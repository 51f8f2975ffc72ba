#!/usr/bin/env python3
"""Check and time the port's run merge and key build (hysortk_tpu_torch) on
one CUDA card.

    python3 tools/bench_torch_merge_keybuild.py [--quick] [--profile]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. Prints the card's name and power limit, ptxas' report for the two
kernels, then:

  - every hard case of hysortk_tpu_torch.testing.merge_cases and
    keybuild_cases at the kernels' own tiles and fan-in, also on rows (codes
    and flags) that are views at odd offsets, kernel against the plain
    version, exactly equal;
  - CUDA-event times of merge_sorted_runs on sorted runs (keys from a pool
    of duplicates, sentinel tails of 1/8) with one count row: 2^25 slots in
    S = 2, 4, 8, 16, 32 runs and 2^26 slots in runs of 2048 (the roll sort's
    S = 32768), for W = 1, 2, 4, each with its pass count, its bound (every
    row read and written once) and, for W <= 2, torch.sort(stable=True) of
    the packed int64 key plus the gather of the count row; then the roll
    sort's shape at fan-in 8 and 16, in turns;
  - CUDA-event times of canonical_keys_fused at K = 15, 31, 55 on 2^26
    slots, on aligned codes and flags and on views one byte off, with the
    bound (2 B read and 4W B written per slot).

--profile adds torch.profiler's device time per kernel (the merge's
partition against its tiles) for W=2 at S=4 and the roll sort's S. --quick
stops after the cases and the first timed shape of each kernel (a first run
of a new kernel). Any mismatch raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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


def on_card(arrays, offset: int = 0):
    """numpy arrays on the card; with `offset`, each as a view that many
    elements into its own buffer."""
    import torch

    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        buf = torch.zeros(t.shape[0] + offset, dtype=t.dtype, device=DEVICE)
        buf[offset:] = t
        out.append(buf[offset:])
    return out


def require_equal(got, want, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel != plain")


def check_merge_cases() -> int:
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import merge

    cases = testing.merge_cases()
    for name, kind, n_words, n_pay, s, run_len in cases:
        rows_np = testing.merge_case_rows(kind, n_words, n_pay, s, run_len, 7)
        for offset in (0, 1):
            rows = on_card(rows_np, offset)
            require_equal(merge.merge_sorted_runs(rows, n_words, run_len),
                          merge.merge_sorted_runs_plain(rows, n_words, run_len),
                          f"merge case {name}, offset {offset}")
    return len(cases)


def check_keybuild_cases() -> int:
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import keybuild

    cases = testing.keybuild_cases()
    for name, kind, n, k, offset in cases:
        codes, valid = on_card(testing.keybuild_case_codes(kind, n, k, 7), offset)
        require_equal(keybuild.canonical_keys_fused(codes, valid, k),
                      keybuild.canonical_keys_plain(codes, valid, k),
                      f"keybuild case {name}")
    return len(cases)


def packed_int64(words):
    from hysortk_tpu_torch.ops.kmer import widen

    key = widen(words[0])
    for w in words[1:]:
        key = (key << 32) | widen(w)
    return (key << (64 - 32 * len(words))) ^ -(1 << 63)


def sorted_runs(gen, n: int, n_words: int, run_len: int):
    """n_words key rows and one count row on the card: n / run_len ascending
    runs, keys from a pool of n / 4 (duplicates within and across runs, half
    with the top bit set), each run's last eighth the sentinel with count 0."""
    import torch

    from hysortk_tpu_torch.ops import block_sort, radix_sort

    pool = torch.randint(-2**31, 2**31, (n_words, max(n // 4, 1)), dtype=torch.int32,
                         device=DEVICE, generator=gen)
    pick = torch.randint(0, pool.shape[1], (n,), device=DEVICE, generator=gen)
    words = [pool[w][pick] for w in range(n_words)]
    count = torch.randint(1, 65536, (n,), dtype=torch.int32, device=DEVICE,
                          generator=gen)
    tail = (torch.arange(n, device=DEVICE) % run_len) >= run_len - run_len // 8
    for w in words:
        w[tail] = -1
    count[tail] = 0
    rows = words + [count]
    if run_len <= block_sort.max_block(n_words):
        return block_sort.block_bitonic_sort(rows, n_words, run_len, False)
    out = [torch.empty_like(r) for r in rows]
    for r0 in range(0, n, run_len):
        got, (cnt,) = radix_sort.sort_words([w[r0:r0 + run_len] for w in words],
                                            [count[r0:r0 + run_len]])
        for o, g in zip(out, got + [cnt]):
            o[r0:r0 + run_len] = g
    return out


def time_merge(quick: bool, profile: bool) -> None:
    import torch

    from hysortk_tpu_torch.ops import merge

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    shapes = [(1 << 25, s) for s in (4, 2, 8, 16, 32)] + [(1 << 26, (1 << 26) // 2048)]
    for n_words in (2, 1, 4):
        for n, s in shapes:
            run_len = n // s
            rows = sorted_runs(gen, n, n_words, run_len)
            require_equal(merge.merge_sorted_runs(rows, n_words, run_len),
                          merge.merge_sorted_runs_plain(rows, n_words, run_len),
                          f"merge W={n_words} S={s}")
            passes = len(merge.merge_plan(np.arange(0, n + 1, run_len),
                                          merge.TILE, merge.FAN_IN))
            ms = cuda_ms(lambda: merge.merge_sorted_runs(rows, n_words, run_len), 10)
            bound = 8 * len(rows) * n / HBM_BYTES_PER_S * 1e3
            text = "none (W > 2)"
            if n_words <= 2:
                packed = packed_int64(rows[:n_words])

                def library():
                    order = torch.sort(packed, stable=True).indices
                    return rows[-1].index_select(0, order)

                if not torch.equal(library(), merge.merge_sorted_runs(
                        rows, n_words, run_len)[-1]):
                    raise AssertionError("the library call's count row differs")
                text = f"{cuda_ms(library, 5):.4f} ms"
                del packed
            print(f"merge W={n_words}+1 n={n} S={s} L={run_len}: equal, {passes} "
                  f"pass(es) at fan-in {merge.FAN_IN}, kernel {ms:.4f} ms (bound "
                  f"{bound:.4f} ms, one pass); torch.sort(stable) + gather {text}",
                  flush=True)
            if profile and n_words == 2 and s in (4, (1 << 26) // 2048):
                profile_kernels(lambda: merge.merge_sorted_runs(rows, n_words, run_len),
                                f"merge W=2 S={s}")
            if n_words == 2 and s == (1 << 26) // 2048:
                fan_in_turns(rows, n_words, run_len)
            del rows
            if quick:
                return


def fan_in_turns(rows, n_words: int, run_len: int) -> None:
    """The roll sort's shape at fan-in 8 and 16, in turns."""
    from hysortk_tpu_torch.ops import merge

    default = merge.FAN_IN

    def at(fan_in):
        def run():
            merge.FAN_IN = fan_in
            try:
                return merge.merge_sorted_runs(rows, n_words, run_len)
            finally:
                merge.FAN_IN = default
        return run

    turns = [cuda_ms(at(f), 5) for f in (8, 16, 16, 8)]
    print(f"merge roll-sort shape: fan-in 8 {turns[0]:.4f} / {turns[3]:.4f} ms, "
          f"fan-in 16 {turns[1]:.4f} / {turns[2]:.4f} ms", flush=True)


def profile_kernels(fn, what: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    for e in prof.key_averages():
        if e.device_type != on_device:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
        print(f"{what} profile {e.key[:70]}: {us / 1e3 / 5:.4f} ms a call "
              f"({e.count // 5} launches a call)", flush=True)


def time_keybuild(quick: bool) -> None:
    import torch

    from hysortk_tpu_torch.ops import keybuild, wire

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    n = 1 << 26
    codes = torch.randint(0, 4, (n,), dtype=torch.int8, device=DEVICE, generator=gen)
    lengths = torch.randint(1, 300, (n // 150,), dtype=torch.int32, device=DEVICE,
                            generator=gen)
    for k in (31, 15, 55):
        valid = wire.valid_from_lengths(lengths, k, n)
        w = (k + 15) // 16
        bound = (2 + 4 * w) * n / HBM_BYTES_PER_S * 1e3
        odd_codes = torch.cat([codes[:1], codes])[1:]
        odd_valid = torch.cat([valid[:1], valid])[1:]
        times = []
        for c, v in ((codes, valid), (odd_codes, odd_valid)):
            require_equal(keybuild.canonical_keys_fused(c, v, k),
                          keybuild.canonical_keys_plain(c, v, k), f"keybuild K={k}")
            times.append(cuda_ms(lambda: keybuild.canonical_keys_fused(c, v, k), 20))
        print(f"keybuild K={k} n={n}: equal, kernel {times[0]:.4f} ms (bound "
              f"{bound:.4f} ms); codes and flags one byte off {times[1]:.4f} ms",
              flush=True)
        if quick:
            return


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
                name in line for name in ("merge_partition", "merge_tiles",
                                          "keybuild_kernel")):
            print("ptxas:", line.strip()[:150])
            for extra in lines[i + 1:i + 4]:
                if "registers" in extra or "spill" in extra:
                    print("ptxas:   ", extra.strip())
    sys.stdout.flush()

    print(f"{check_merge_cases()} merge cases at tile {testing.MERGE_TILE} and "
          f"fan-in {testing.MERGE_FAN_IN} equal to plain, aligned and one word off",
          flush=True)
    print(f"{check_keybuild_cases()} keybuild cases at tile {testing.KEYBUILD_TILE} "
          f"equal to plain", flush=True)
    time_merge(quick, "--profile" in sys.argv[1:])
    time_keybuild(quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
