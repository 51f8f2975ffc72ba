#!/usr/bin/env python3
"""Time the port's sharded routes (hysortk_tpu_torch.parallel) on the cards
of one host, beside one-device counting of the same reads.

    python3 tools/bench_torch_sharded.py [--ranks N] [--bases B] [--repeats R]
                                         [--with-supermer]

Run from the repository root on a machine with sm_90 cards and the CUDA
toolkit. The reads are those of chip_smoke.py phase 2, made in memory from
a seed (a 2^22-base genome sampled into 150-base reads, half
reverse-complemented, 0.5% substitutions), B bases of them (default 2^26).
K=31, M=17, L=2, U=50.

The script first counts them on cuda:0 alone (kmer_count, one warm-up call
and R timed calls), then spawns N ranks (default: one per card) that count
them with count_reads_sharded, one warm-up call and R timed calls each: by
the range exchange (the default route), and with --with-supermer by the
supermer route too (parallel/supermer_route.py), so that each rank's bytes
sent stand beside the range route's. The backend
follows parallel/group.backend_for: NCCL when every rank has a card of its
own, gloo through pinned host buffers when ranks share one. Every sharded
result must equal the one-device result after sorting by key, histogram
included. It prints the card's name and power limit, per rank and route the
walls, the peak device memory and the bytes sent, and as its last line one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 20261016
K, M, LOWER, UPPER = 31, 17, 2, 50
GENOME_BASES = 1 << 22
READ_LEN = 150


def seeded_reads(n_bases: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint8, lengths int64) of n_bases // 150 reads."""
    rng = np.random.default_rng(SEED)
    n_reads = n_bases // READ_LEN
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    starts = rng.integers(0, GENOME_BASES - READ_LEN + 1, n_reads)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return reads.reshape(-1), np.full(n_reads, READ_LEN, dtype=np.int64)


def config(routing: str = "range"):
    import hysortk_tpu_torch as ht

    return ht.KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER, routing=routing)


def timed_calls(run, repeats: int) -> dict:
    """One warm-up call, then `repeats` timed calls under fresh counters;
    the last call's result, counters and peak device memory."""
    import torch

    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.parallel import exchange

    run()
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        exchange.reset_traffic()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(result=result, walls=walls, peak=torch.cuda.max_memory_allocated(),
                launches={k: v for k, v in _build.launches.items() if v},
                traffic=dict(exchange.traffic))


def rank_main(rank: int, inputs: str, out_dir: str, repeats: int,
              routings: list) -> None:
    import torch
    import torch.distributed as dist

    from hysortk_tpu_torch.parallel import pipeline as sharded

    data = np.load(inputs)
    for routing in routings:
        cfg = config(routing)
        stats = timed_calls(lambda: sharded.count_reads_sharded(
            data["codes"], data["lengths"], cfg), repeats)
        kl, hist = stats.pop("result")
        if rank == 0:
            np.savez(os.path.join(out_dir, f"result-{routing}.npz"), keys=kl.keys,
                     counts=kl.counts, hist=hist)
        del kl, hist
        torch.cuda.empty_cache()
        stats.update(backend=dist.get_backend(),
                     device=str(torch.cuda.current_device()))
        with open(os.path.join(out_dir, f"rank{rank}-{routing}.json"), "w") as f:
            json.dump(stats, f)


def sorted_by_key(keys, counts):
    order = np.lexsort(keys.T[::-1])
    return keys[order], counts[order]


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=0, help="default: one per card")
    p.add_argument("--bases", type=int, default=1 << 26)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--with-supermer", action="store_true",
                   help="also time the supermer route, beside the range route")
    args = p.parse_args()
    routings = ["range"] + (["supermer"] if args.with_supermer else [])
    if not torch.cuda.is_available():
        print("bench_torch_sharded: needs a CUDA device", file=sys.stderr)
        return 1
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.parallel.spawn import spawn_ranks

    ranks = args.ranks or torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.lib()  # built once here, loaded by every rank
    codes, lengths = seeded_reads(args.bases)
    cfg = config()
    one = timed_calls(lambda: ht.kmer_count(codes, lengths, cfg, device="cuda:0"),
                      args.repeats)
    want_kl, want_hist = one.pop("result")
    print(f"one device: {len(want_kl)} k-mers kept; walls "
          f"{', '.join(f'{w:.4f}' for w in one['walls'])} s; peak "
          f"{one['peak'] / 2**30:.3f} GiB", flush=True)
    torch.cuda.empty_cache()

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="bench_sharded_", dir=os.path.join(ROOT, "build"))
    try:
        inputs = os.path.join(out_dir, "reads.npz")
        np.savez(inputs, codes=codes, lengths=lengths)
        t0 = time.perf_counter()
        spawn_ranks(rank_main, ranks, (inputs, out_dir, args.repeats, routings),
                    workdir=out_dir, device="cuda", timeout=900)
        spawn_s = time.perf_counter() - t0
        res, stats = {}, {}
        for routing in routings:
            res[routing] = dict(np.load(os.path.join(out_dir, f"result-{routing}.npz")))
            stats[routing] = []
            for r in range(ranks):
                with open(os.path.join(out_dir, f"rank{r}-{routing}.json")) as f:
                    stats[routing].append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want = sorted_by_key(want_kl.keys, want_kl.counts)
    equal = {}
    for routing in routings:
        got = sorted_by_key(res[routing]["keys"], res[routing]["counts"])
        equal[routing] = bool(
            np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and np.array_equal(res[routing]["hist"], want_hist))
    for r in range(ranks):
        for routing in routings:
            st = stats[routing][r]
            t = st["traffic"]
            print(f"rank {r} {routing} ({st['backend']}, cuda:{st['device']}): walls "
                  f"{', '.join(f'{w:.4f}' for w in st['walls'])} s; peak "
                  f"{st['peak'] / 2**30:.3f} GiB; sent {t['bytes_sent']} B; launches "
                  f"{json.dumps(st['launches'])}", flush=True)
    record = {
        "card": smi, "cards": torch.cuda.device_count(), "ranks": ranks,
        "backend": stats["range"][0]["backend"], "bases": int(codes.size),
        "kept": len(want_kl), "equal": equal,
        "one_device_walls_s": one["walls"], "one_device_peak_b": one["peak"],
        "spawn_s": spawn_s,
    }
    for routing in routings:
        sts = stats[routing]
        record[routing] = {
            "rank_walls_s": [st["walls"] for st in sts],
            "rank_bytes_sent": [st["traffic"]["bytes_sent"] for st in sts],
            "rank_peak_b": [st["peak"] for st in sts],
        }
    print(json.dumps(record))
    if not all(equal.values()):
        print("bench_torch_sharded: a sharded result differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
