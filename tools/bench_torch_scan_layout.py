#!/usr/bin/env python3
"""Check and time the supermer route's scan and run layout (hysortk_tpu_torch
ops/minimizer.kmer_destinations[_sized], csrc/minimizer_scan.cu;
ops/supermer.run_layout, csrc/supermer_runs.cu) on one CUDA card.

    python3 tools/bench_torch_scan_layout.py

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. On 2^26 positions of random codes laid out as 150-base reads (the
k-mer starts of K = 31 valid), prints the card's name and power limit, then
CUDA-event means of 20 calls after one warm-up:

  - the scan with its bucket sizes (3 buckets) and without them;
  - the run layout at 1, 2, 4 and 257 destinations (three buckets a
    destination, round robin): the wrapper (both launches and its one host
    read of the run count), its count launch and its write launch alone.

Each result is first checked exactly equal to its plain version. Any
mismatch raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hysortk_tpu_torch import _build  # noqa: E402
from hysortk_tpu_torch.ops import minimizer  # noqa: E402
from hysortk_tpu_torch.ops import supermer as sm  # noqa: E402

N = 1 << 26
K, M, READ_LEN = 31, 17, 150


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_layout(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip((a.src, a.off, a.bases, a.dest_begin),
                                                   (b.src, b.off, b.bases, b.dest_begin)))
            and (a.cmax, a.smax) == (b.cmax, b.smax))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, N).astype(np.int8)).cuda()
    valid = torch.from_numpy(np.arange(N) % READ_LEN <= READ_LEN - K).cuda()

    dest, sizes = minimizer.kmer_destinations_sized(codes, valid, K, M, 3)
    plain = minimizer.kmer_destinations_sized_plain(codes, valid, K, M, 3)
    if not (torch.equal(dest, plain[0]) and torch.equal(sizes, plain[1])):
        raise AssertionError("the sized scan differs from its plain version")
    sized = cuda_ms(lambda: minimizer.kmer_destinations_sized(codes, valid, K, M, 3))
    bare = cuda_ms(lambda: minimizer.kmer_destinations(codes, K, M, 3))
    print(f"scan n={N} K={K} m={M} 3 buckets: with the sizes {sized:.4f} ms, "
          f"without {bare:.4f} ms", flush=True)

    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    mk = sm.max_kmers(K)
    for num_dest in (1, 2, 4, 257):
        buckets = 3 * num_dest
        d = minimizer.kmer_destinations(codes, K, M, buckets)
        assign = (torch.arange(buckets, dtype=torch.int32) % num_dest).cuda()
        got = sm.run_layout(valid, d, assign, mk, K, num_dest)
        if not same_layout(got, sm.run_layout_plain(valid, d, assign, mk, K, num_dest)):
            raise AssertionError(f"the run layout differs from its plain version at "
                                 f"{num_dest} destinations")
        runs = got.src.numel()
        scratch = torch.empty(lib.hk_run_layout_scratch(N, num_dest), dtype=torch.uint8,
                              device="cuda")
        dest_begin = torch.empty(num_dest + 1, dtype=torch.int64, device="cuda")
        info = torch.empty(3, dtype=torch.int64, device="cuda")
        src = torch.empty(runs, dtype=torch.int64, device="cuda")
        off = torch.empty_like(src)
        bases = torch.empty(runs, dtype=torch.int32, device="cuda")
        args = (valid.data_ptr(), d.data_ptr(), assign.data_ptr(), buckets, N, mk, K,
                num_dest, scratch.data_ptr())
        count = cuda_ms(lambda: lib.hk_run_layout_count(
            *args, dest_begin.data_ptr(), info.data_ptr(), stream))
        write = cuda_ms(lambda: lib.hk_run_layout_write(
            *args, dest_begin.data_ptr(), src.data_ptr(), off.data_ptr(),
            bases.data_ptr(), stream))
        wrapper = cuda_ms(lambda: sm.run_layout(valid, d, assign, mk, K, num_dest))
        print(f"run layout {num_dest} destination(s), {runs} runs: wrapper {wrapper:.4f} ms, "
              f"count launch {count:.4f} ms, write launch {write:.4f} ms", flush=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
