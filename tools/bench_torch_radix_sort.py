#!/usr/bin/env python3
"""Check and time the port's radix sort (hysortk_tpu_torch) on one CUDA card.

    python3 tools/bench_torch_radix_sort.py [--quick] [--profile]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. Prints the card's name and power limit, ptxas' report for the sort's
kernels, then:

  - every hard case of hysortk_tpu_torch.testing.sort_cases at the kernel's
    tile, kernel against the plain version, exactly equal;
  - CUDA-event times of sort_words at the shapes the main paths use (random
    keys with a sentinel tail of 1/8): W=2 at 2^26 slots, the same with two
    payload rows, W=2 at 2^26 - 12,345 slots, W=1 and W=4 at 2^24 slots,
    all keys equal and keys that differ in one digit only at 2^26 slots,
    beside torch.sort of the packed int64 key;
  - sort_codes_fused beside keybuild + sort_words in turns.

--quick stops after the cases and one timed shape (a first run of a new
kernel); --profile adds the device time by kernel of one sort at W=2 and one
at W=2+2, from torch.profiler. Any mismatch raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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


def to_cuda(rows):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(r).view(np.int32)).cuda()
            for r in rows]


def check_cases() -> int:
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import radix_sort

    tile = testing.SORT_TILE
    cases = testing.sort_cases(tile)
    for name, kind, n, n_words, n_payloads in cases:
        words = to_cuda(testing.sort_case_words(kind, n, n_words, 7))
        pays = to_cuda(testing.sort_case_payloads(n, n_payloads))
        got = radix_sort.sort_words(words, pays)
        want = radix_sort.sort_words_plain(words, pays)
        torch.cuda.synchronize()
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            if not torch.equal(g, w):
                raise AssertionError(f"case {name} at tile {tile}: kernel != plain")
    return len(cases)


def timed_shapes(quick: bool):
    """(label, words, payloads) on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)

    def keys(n, w, tail=True):
        rows = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                              device="cuda", generator=gen) for _ in range(w)]
        if tail:
            for r in rows:
                r[n - n // 8:] = -1
        return rows

    n = 1 << 26
    yield "W=2 n=2^26", keys(n, 2), []
    if quick:
        return
    pay = [torch.arange(n, dtype=torch.int32, device="cuda") for _ in range(2)]
    yield "W=2+2 n=2^26", keys(n, 2), pay
    del pay
    yield "W=2 n=2^26-12345", keys(n - 12345, 2), []
    yield "W=1 n=2^24", keys(1 << 24, 1), []
    yield "W=4 n=2^24", keys(1 << 24, 4), []
    same = [torch.full((n,), 12345, dtype=torch.int32, device="cuda")
            for _ in range(2)]
    yield "W=2 n=2^26 all keys equal", same, []
    same[1] = same[1] | (torch.randint(0, 256, (n,), dtype=torch.int32,
                                       device="cuda", generator=gen) << 8)
    yield "W=2 n=2^26 one varying digit", same, []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from hysortk_tpu_torch import _build, testing
    from hysortk_tpu_torch.ops import radix_sort
    from hysortk_tpu_torch.ops.kmer import widen

    args = sys.argv[1:]
    quick = "--quick" in args
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    path = _build.library_path()
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(
                name in line for name in ("radix_pass", "digit_histogram", "fused_pass0")):
            print("ptxas:", line.strip()[:150])
            for extra in lines[i + 1:i + 4]:
                if "registers" in extra or "spill" in extra:
                    print("ptxas:   ", extra.strip())
    sys.stdout.flush()

    print(f"{check_cases()} hard cases at tile {testing.SORT_TILE} equal to plain",
          flush=True)
    for label, words, pays in timed_shapes(quick):
        got = radix_sort.sort_words(words, pays)
        want = radix_sort.sort_words_plain(words, pays)
        torch.cuda.synchronize()
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: kernel != plain")
        del got, want
        lib_text = "none"
        if len(words) <= 2:
            key = widen(words[0])
            for w in words[1:]:
                key = (key << 32) | widen(w)
            key = (key << (64 - 32 * len(words))) ^ -(1 << 63)
            lib_text = f"{cuda_ms(lambda: torch.sort(key), 5):.4f} ms"
            del key
        ms = cuda_ms(lambda: radix_sort.sort_words(words, pays), 5)
        print(f"{label}: equal, kernel {ms:.4f} ms, torch.sort of the packed "
              f"key {lib_text}", flush=True)
    if not quick:
        time_fused_sort()
    if "--profile" in args:
        profile_sort()
    return 0


def time_fused_sort() -> None:
    """sort_codes_fused beside keybuild + sort_words, in turns, on random
    codes: K=31 at 2^26 slots, K=55 at 2^24."""
    import torch

    from hysortk_tpu_torch.ops import fused_sort, keybuild, radix_sort

    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, n in ((31, 1 << 26), (55, 1 << 24)):
        codes = torch.randint(0, 4, (n,), dtype=torch.int8, device="cuda",
                              generator=gen)
        valid = torch.rand(n, device="cuda", generator=gen) < 0.85
        pair = lambda: radix_sort.sort_words(
            keybuild.canonical_keys_fused(codes, valid, k))[0]
        fused = lambda: fused_sort.sort_codes_fused(codes, valid, k)
        for a, b in zip(pair(), fused()):
            if not torch.equal(a, b):
                raise AssertionError(f"fused sort K={k}: differs from the pair")
        turns = [cuda_ms(f, 5) for f in (pair, fused, fused, pair)]
        print(f"fused sort K={k} n={n}: equal; keybuild + sort {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms, fused {turns[1]:.4f} / {turns[2]:.4f} ms",
              flush=True)


def profile_sort() -> None:
    """Device time by kernel of one sort at W=2 and one at W=2+2, n=2^26."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hysortk_tpu_torch.ops import radix_sort

    shapes = list(timed_shapes(False))[:2]
    for label, words, pays in shapes:
        radix_sort.sort_words(words, pays)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            radix_sort.sort_words(words, pays)
            torch.cuda.synchronize()
        on_device = torch.autograd.DeviceType.CUDA
        for e in prof.key_averages():
            if e.device_type == on_device:
                us = getattr(e, "self_device_time_total", None) or \
                    getattr(e, "self_cuda_time_total", 0)
                print(f"profile {label}: {e.key[:70]}: {us / 1e3:.4f} ms over "
                      f"{e.count} launches", flush=True)


if __name__ == "__main__":
    sys.exit(main())
