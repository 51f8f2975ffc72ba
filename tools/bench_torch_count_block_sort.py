#!/usr/bin/env python3
"""Check and time the port's run-length count and block sort
(hysortk_tpu_torch) on one CUDA card.

    python3 tools/bench_torch_count_block_sort.py [--quick]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. Prints the card's name and power limit, ptxas' report for the two
kernels, then:

  - every hard case of hysortk_tpu_torch.testing.count_cases and
    block_sort_cases at the kernels' tile sizes, and both kernels on rows
    that are views at odd offsets (no 16-byte alignment), kernel against the
    plain version, exactly equal;
  - CUDA-event times of run_length_count_filter on sorted keys with runs of
    1..59 slots and a sentinel tail of 1/8, and on the same with one run of
    10^5 and one of 10^6 slots (the look-back's long walks), in turns, at
    W=2 and 2^26 slots, beside torch.unique_consecutive of the packed key
    and the rate of a plain device copy; then W=1, 4, 6 and a ragged size,
    each also on rows at odd offsets;
  - CUDA-event times of block_bitonic_sort at B=2048, W=2, 2^26 slots beside
    torch.sort(dim=1) of the packed key, then every block size from 2 to
    16,384 at W=2, and W=1, 4, 6 with and without payload rows at 2^24
    slots.

--quick stops after the cases and the first timed shape of each kernel (a
first run of a new kernel). Any mismatch raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOWER, UPPER = 2, 50
DEVICE = "cuda"  # "cpu" rehearses the script's own logic on the plain versions


def cuda_ms(fn, reps: int) -> float:
    import torch

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


def to_cuda(rows, offset: int = 0):
    """The rows on the card; with `offset`, each as a view that starts that
    many words into its own buffer (offset 1: 4-byte alignment only)."""
    import torch

    out = []
    for r in rows:
        t = torch.from_numpy(np.ascontiguousarray(r).view(np.int32))
        buf = torch.empty(t.shape[0] + offset, dtype=torch.int32, device=DEVICE)
        buf[offset:] = t
        out.append(buf[offset:])
    return out


def require_equal(got, want, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel != plain")


def check_count_cases() -> int:
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import fused_count

    cases = testing.count_cases(testing.COUNT_TILE)
    for name, runs, n_sentinel, n_words, lower, upper in cases:
        words = testing.count_case_words(runs, n_sentinel, n_words, 7)
        for offset in (0, 1):
            rows = to_cuda(words, offset)
            require_equal(
                fused_count.run_length_count_filter(rows, lower, upper),
                fused_count.run_length_count_filter_plain(rows, lower, upper),
                f"count case {name} at tile {testing.COUNT_TILE}, offset {offset}")
    return len(cases)


def check_block_sort_cases() -> int:
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import block_sort

    cases = testing.block_sort_cases(testing.BLOCK_SORT_CHUNK)
    for name, kind, n_words, n_pay, block, n_blocks in cases:
        rows_np = testing.block_sort_case_rows(kind, n_words, n_pay, block, n_blocks, 7)
        for offset in (0, 1):
            rows = to_cuda(rows_np, offset)
            for descending_odd in (True, False):
                require_equal(
                    block_sort.block_bitonic_sort(rows, n_words, block, descending_odd),
                    block_sort.block_bitonic_sort_plain(rows, n_words, block,
                                                        descending_odd),
                    f"block sort case {name}, offset {offset}, "
                    f"descending_odd {descending_odd}")
    return len(cases)


def sorted_words(gen, n: int, n_words: int, long_runs: bool, max_run: int = 59):
    """Sorted sentinel-marked int32 words on the card: distinct ascending
    keys in runs of 1..max_run slots (with long_runs one of 10^5 and one of
    10^6 slots too), then an all-ones tail of n/8 slots."""
    import torch

    from hysortk_tpu_torch.ops.kmer import narrow

    tail = n // 8
    runs = torch.randint(1, max_run + 1, (3 * n // (max_run + 1),), device=DEVICE,
                         generator=gen)
    if long_runs:
        runs[5] = 100_000
        runs[7] = 1_000_000
    runs = runs[: int((torch.cumsum(runs, 0) <= n - tail).sum())]
    runs[-1] += n - tail - int(runs.sum())
    steps = torch.randint(1, 2**36, (runs.shape[0],), device=DEVICE, generator=gen)
    keys = torch.cumsum(steps, 0) ^ -(1 << 63)  # ascending as unsigned 64-bit
    flat = torch.cat([torch.repeat_interleave(keys, runs),
                      torch.full((tail,), -1, dtype=torch.int64, device=DEVICE)])
    words = [narrow(flat >> 32), narrow(flat)]
    words += [narrow(flat >> (5 * j)) for j in range(2, n_words)]
    return words[:n_words]


def packed_int64(words):
    from hysortk_tpu_torch.ops.kmer import widen

    key = widen(words[0])
    for w in words[1:]:
        key = (key << 32) | widen(w)
    return (key << (64 - 32 * len(words))) ^ -(1 << 63)


def time_count(quick: bool) -> None:
    import torch

    from hysortk_tpu_torch.ops import fused_count

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    n = 1 << 26
    inputs = {}
    for label, long_runs in (("runs of 1..59", False), ("with runs of 10^5 and 10^6", True)):
        words = sorted_words(gen, n, 2, long_runs)
        require_equal(fused_count.run_length_count_filter(words, LOWER, UPPER),
                      fused_count.run_length_count_filter_plain(words, LOWER, UPPER),
                      f"count {label}")
        inputs[label] = words
    runs = {label: (lambda w=w: fused_count.run_length_count_filter(w, LOWER, UPPER))
            for label, w in inputs.items()}
    short, long_ = runs.values()
    turns = [cuda_ms(f, 20) for f in (short, long_, long_, short)]
    packed = packed_int64(inputs["runs of 1..59"])
    lib = cuda_ms(lambda: torch.unique_consecutive(packed, return_counts=True), 5)
    del packed
    bound = (4 * 2 + 5) * n / 3.35e12 * 1e3
    print(f"count W=2 n=2^26: runs of 1..59 {turns[0]:.4f} / {turns[3]:.4f} ms, "
          f"with runs of 10^5 and 10^6 {turns[1]:.4f} / {turns[2]:.4f} ms; "
          f"torch.unique_consecutive {lib:.4f} ms; bound {bound:.4f} ms", flush=True)
    # What the card gives a plain stream: a device copy moves 8 B/slot.
    src, dst = inputs["runs of 1..59"][0], torch.empty(n, dtype=torch.int32, device=DEVICE)
    copy_ms = cuda_ms(lambda: dst.copy_(src), 20)
    print(f"a device copy of 2^26 int32 (8 B/slot moved): {copy_ms:.4f} ms = "
          f"{8 * n / copy_ms / 1e9:.3f} TB/s; the count moves 13 B/slot at "
          f"{13 * n / min(turns) / 1e9:.3f} TB/s", flush=True)
    del src, dst
    inputs.clear()
    if quick:
        return
    for n_words, size in ((1, n), (4, n), (6, n), (2, n - 12345)):
        words = sorted_words(gen, size, n_words, True)
        require_equal(fused_count.run_length_count_filter(words, LOWER, UPPER),
                      fused_count.run_length_count_filter_plain(words, LOWER, UPPER),
                      f"count W={n_words} n={size}")
        ms = cuda_ms(lambda: fused_count.run_length_count_filter(words, LOWER, UPPER), 20)
        odd = [torch.cat([w[:1], w])[1:] for w in words]  # 4-byte alignment only
        odd_ms = cuda_ms(lambda: fused_count.run_length_count_filter(odd, LOWER, UPPER), 10)
        bound = (4 * n_words + 5) * size / 3.35e12 * 1e3
        print(f"count W={n_words} n={size}: equal, kernel {ms:.4f} ms (bound "
              f"{bound:.4f} ms); rows at odd offsets {odd_ms:.4f} ms", flush=True)
        del words, odd


def time_block_sort(quick: bool) -> None:
    import torch

    from hysortk_tpu_torch.ops import block_sort

    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def rows_of(n, n_words, n_pay):
        rows = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                              device=DEVICE, generator=gen) for _ in range(n_words)]
        for r in rows:
            r[n - n // 8:] = -1
        return rows + [torch.arange(n, dtype=torch.int32, device=DEVICE) + j
                       for j in range(n_pay)]

    def one(n, n_words, n_pay, block, with_library=False):
        rows = rows_of(n, n_words, n_pay)
        require_equal(block_sort.block_bitonic_sort(rows, n_words, block, False),
                      block_sort.block_bitonic_sort_plain(rows, n_words, block, False),
                      f"block sort W={n_words}+{n_pay} B={block} n={n}")
        ms = cuda_ms(lambda: block_sort.block_bitonic_sort(rows, n_words, block, False), 5)
        text = ""
        if with_library:
            packed = packed_int64(rows[:n_words]).view(-1, block)
            lib = cuda_ms(lambda: torch.sort(packed, dim=1), 5)
            text = f"; torch.sort(dim=1) of the packed key {lib:.4f} ms"
        bound = 8 * (n_words + n_pay) * n / 3.35e12 * 1e3
        print(f"block sort W={n_words}+{n_pay} B={block} n={n}: equal, kernel "
              f"{ms:.4f} ms (bound {bound:.4f} ms){text}", flush=True)

    one(1 << 26, 2, 0, 2048, with_library=True)
    if quick:
        return
    block = 2
    while block <= 16384:
        one(1 << 24, 2, 0, block, with_library=block >= 256)
        block *= 2
    for n_words, n_pay, block in ((1, 0, 2048), (1, 2, 2048), (2, 2, 2048),
                                  (4, 0, 2048), (4, 2, 8192), (6, 0, 2048),
                                  (6, 2, 8192), (1, 0, 16384)):
        one(1 << 24, n_words, n_pay, block)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from hysortk_tpu_torch import _build, testing

    quick = "--quick" in sys.argv[1:]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    path = _build.library_path()
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(
                name in line for name in ("count_kernel", "block_sort_kernel")):
            print("ptxas:", line.strip()[:150])
            for extra in lines[i + 1:i + 4]:
                if "registers" in extra or "spill" in extra:
                    print("ptxas:   ", extra.strip())
    sys.stdout.flush()

    print(f"{check_count_cases()} count cases at tile {testing.COUNT_TILE} equal to "
          f"plain, aligned and at odd offsets", flush=True)
    print(f"{check_block_sort_cases()} block sort cases at chunk "
          f"{testing.BLOCK_SORT_CHUNK} equal to plain in both orientations, aligned "
          f"and at odd offsets", flush=True)
    time_count(quick)
    time_block_sort(quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
