#!/usr/bin/env python3
"""Time the port's single-device entries on one card, for one tree of the
repository.

    python3 tools/bench_torch_single_device.py [--tree DIR] [--repeats R]
                                               [--bases B]

Run on a machine with an sm_90 card and the CUDA toolkit. `--tree` names
the checkout whose hysortk_tpu_torch is imported (default: this one), so
that two commits can be timed in turns in one call on the same card (for
example parent, change, change, parent, each in a process of its own). The
reads are made in memory from a seed: a 2^22-base genome sampled into
150-base reads, half reverse-complemented, 0.5% substitutions, B bases of
them (default 2^26). K=31, M=17, L=2, U=50.

After one warm-up call each, R timed calls (default 7) of: kmer_count
one-shot (count_reads); count_reads_streaming in batches of 2^24 with the
partials held on the host (a) and under device_compact in batches of 2^22
(b); kmer_count in extension mode; count_reads_streaming_ext in batches
of 2^24. Every call after the first must equal the first. Prints the card's name and power limit, each entry's walls,
median and quartiles, and as its last line one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--bases", type=int, default=1 << 26)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import hysortk_tpu_torch as ht

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if not os.path.dirname(os.path.abspath(ht.__file__)).startswith(tree):
        raise RuntimeError(f"imported {ht.__file__}, not the tree {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    codes, lengths = seeded_reads(args.bases)
    cfg = ht.KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER)
    entries = {
        "one_shot": lambda: ht.kmer_count(codes, lengths, cfg, device="cuda"),
        "stream_a": lambda: ht.count_reads_streaming(
            codes, lengths, cfg, 1 << 24, device="cuda"),
        "stream_b": lambda: ht.count_reads_streaming(
            codes, lengths, dataclasses.replace(cfg, device_compact=True), 1 << 22,
            device="cuda"),
        "ext_one_shot": lambda: ht.kmer_count(
            codes, lengths, dataclasses.replace(cfg, extension=True), device="cuda"),
        "ext_stream": lambda: ht.count_reads_streaming_ext(
            codes, lengths, dataclasses.replace(cfg, extension=True), 1 << 24,
            device="cuda"),
    }
    out = {"tree": tree, "card": card, "bases": int(codes.size), "walls": {}}
    for name, run in entries.items():
        first = run()
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not (np.array_equal(got[0].keys, first[0].keys)
                    and np.array_equal(got[0].counts, first[0].counts)
                    and np.array_equal(got[1], first[1])):
                raise AssertionError(f"{name}: a call differs from the first")
        del first, got
        torch.cuda.empty_cache()
        q1, med, q3 = np.percentile(walls, [25, 50, 75])
        out["walls"][name] = walls
        print(f"{name}: median {med:.4f} s, quartiles {q1:.4f} / {q3:.4f} s, walls "
              f"{', '.join(f'{w:.4f}' for w in walls)}")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
