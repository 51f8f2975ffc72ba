#!/usr/bin/env python3
"""Time the port's one-shot sharded extension mode on two ranks sharing one
card, for one tree of the repository.

    python3 tools/bench_torch_sharded_ext.py [--tree DIR]

Run on a machine with an sm_90 card and the CUDA toolkit. `--tree` names
the checkout whose hysortk_tpu_torch is imported (default: this one), so
that two commits can be timed in turns in one call on the same card (for
example parent, change, change, parent, each in a process of its own). Two
spawned ranks share the card over gloo (NCCL refuses two ranks on one
GPU). The reads are made in memory from a seed: a 2^22-base genome sampled
into 150-base reads, half reverse-complemented, 0.5% substitutions, 2^24
bases of them. K=31, M=17, L=2, U=50, read ids from 7.

Each rank times six calls of count_reads_sharded_ext under range and
kmer_hash routing, a barrier before each, and keeps the last five; each
rank's medians and walls are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The spawned ranks import this file again and find the tree here, in the
# environment main() sets before it spawns them.
TREE = os.path.abspath(os.environ.get("HYSORTK_BENCH_TREE", ROOT))
sys.path.insert(0, TREE)

SEED = 20261016
GENOME_BASES = 1 << 22
READ_LEN = 150
BASES = 1 << 24


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


def rank_calls(rank: int, out_dir: str) -> None:
    """One rank: the timed calls of each routing, written to r<rank>.json."""
    import torch
    import torch.distributed as dist

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.parallel import pipeline as sharded

    if not ht.__file__.startswith(TREE):
        raise RuntimeError(f"imported {ht.__file__}, not the tree {TREE}")
    codes, lengths = seeded_reads(BASES)
    walls = {}
    for routing in ("range", "kmer_hash"):
        cfg = ht.KmerConfig(k=31, m=17, lower=2, upper=50, extension=True,
                            routing=routing)
        times = []
        for _ in range(6):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded.count_reads_sharded_ext(codes, lengths, cfg, device="cuda",
                                            read_id_offset=7)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[routing] = times[1:]
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(walls, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    global TREE
    TREE = os.environ["HYSORTK_BENCH_TREE"] = os.path.abspath(args.tree)
    sys.path.insert(0, TREE)  # nothing of the package is imported before this

    import torch

    from hysortk_tpu_torch.parallel.spawn import spawn_ranks

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out:
        spawn_ranks(rank_calls, 2, (out,), workdir=out, device="cuda", timeout=400)
        for r in range(2):
            with open(os.path.join(out, f"r{r}.json")) as f:
                walls = json.load(f)
            print(TREE, "rank", r, {k: (round(float(np.median(v)), 4),
                                        [round(x, 4) for x in v])
                                    for k, v in walls.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
