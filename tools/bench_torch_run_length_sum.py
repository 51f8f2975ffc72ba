#!/usr/bin/env python3
"""Check and time the port's weighted run-length sum (hysortk_tpu_torch
ops/run_length_sum, csrc/run_length_sum.cu) on one CUDA card.

    python3 tools/bench_torch_run_length_sum.py [--quick]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. Prints the card's name and power limit, ptxas' report for the sum
and count kernels, then:

  - every hard case of hysortk_tpu_torch.testing.sum_cases at the kernel's
    tile, on aligned rows and on rows that are views at odd offsets (no
    16-byte alignment), kernel against the plain version, exactly equal, one
    launch a call;
  - at the shape of the streaming final merge (2^25 slots, W=2, runs of 1..4
    slots as four partial lists give, weights 1..65535 on every slot, a
    sentinel tail of 1/8), CUDA-event times in turns of the sum, the count
    kernel on the same words (the same look-back with no sum), a device copy
    of one int32 row, and ops/count.frequency_filter on the sum's output;
    beside them torch.unique_consecutive(return_inverse=True) + index_add_
    of the packed key as a two-call reference;
  - at 2^26 slots, W = 1, 2, 4, 6: runs of 1..59 slots, the same with one
    run of 10^5 and one of 10^6 slots, and rows at odd offsets.

--quick stops after the cases and the first timed shape (a first run of a
new kernel). Any mismatch raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The count's bench (beside this file) holds the helpers both use.
from bench_torch_count_block_sort import (  # noqa: E402
    DEVICE, cuda_ms, packed_int64, require_equal, sorted_words, to_cuda)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def bound_ms(n: int, n_words: int) -> float:
    return (4 * n_words + 4 + 5) * n / HBM_BYTES_PER_S * 1e3


def check_cases() -> int:
    from hysortk_tpu_torch import _build, testing
    from hysortk_tpu_torch.ops import run_length_sum

    cases = testing.sum_cases(testing.SUM_TILE)
    for name, runs, n_sentinel, n_words, kind in cases:
        rows = list(testing.count_case_words(runs, n_sentinel, n_words, 7))
        rows.append(testing.sum_case_weights(kind, runs, n_sentinel, 7))
        for offset in (0, 1):
            t = to_cuda(rows, offset)
            before = _build.launches["run_length_sum"]
            got = run_length_sum.run_length_sum_fused(t[:-1], t[-1])
            if _build.launches["run_length_sum"] != before + 1:
                raise AssertionError(f"sum case {name}: not one launch")
            require_equal(got, run_length_sum.run_length_sum_fused_plain(t[:-1], t[-1]),
                          f"sum case {name} at tile {testing.SUM_TILE}, offset {offset}")
    return len(cases)


def time_final_merge_shape() -> None:
    """The streaming final merge's shape, in turns with its neighbours."""
    import torch

    from hysortk_tpu_torch.ops import count as count_ops
    from hysortk_tpu_torch.ops import fused_count, run_length_sum

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    n = 1 << 25
    words = sorted_words(gen, n, 2, False, max_run=4)
    weights = torch.randint(1, 65536, (n,), dtype=torch.int32, device=DEVICE,
                            generator=gen)
    got = run_length_sum.run_length_sum_fused(words, weights)
    require_equal(got, run_length_sum.run_length_sum_fused_plain(words, weights),
                  "sum at the final merge's shape")
    head, total = got
    dst = torch.empty_like(weights)
    fns = {
        "sum": lambda: run_length_sum.run_length_sum_fused(words, weights),
        "count": lambda: fused_count.run_length_count_filter(words, 1, 2**31 - 1),
        "copy": lambda: dst.copy_(weights),
        "filter": lambda: count_ops.frequency_filter(head, total, 2, 50),
    }
    order = ["sum", "count", "copy", "filter", "filter", "copy", "count", "sum"]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(fns[k], 20))
    packed = packed_int64(words)

    def two_calls():
        keys, inverse = torch.unique_consecutive(packed, return_inverse=True)
        return torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=DEVICE).index_add_(0, inverse, weights)

    lib = cuda_ms(two_calls, 5)
    b = bound_ms(n, 2)
    best = min(times["sum"])
    print(f"final-merge shape W=2 n={n} (runs of 1..4): sum {times['sum'][0]:.4f} / "
          f"{times['sum'][1]:.4f} ms (bound {b:.4f} ms, {b / best:.1%} of the HBM "
          f"rate); count on the same words {times['count'][0]:.4f} / "
          f"{times['count'][1]:.4f}; device copy of one int32 row (8 B/slot) "
          f"{times['copy'][0]:.4f} / {times['copy'][1]:.4f} = "
          f"{8 * n / min(times['copy']) / 1e9:.3f} TB/s; frequency_filter on the "
          f"sum's output {times['filter'][0]:.4f} / {times['filter'][1]:.4f}; "
          f"unique_consecutive + index_add_ {lib:.4f} ms", flush=True)


def time_widths() -> None:
    import torch

    from hysortk_tpu_torch.ops import run_length_sum

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    n = 1 << 26
    for n_words in (1, 2, 4, 6):
        weights = torch.randint(1, 65536, (n,), dtype=torch.int32, device=DEVICE,
                                generator=gen)
        text = []
        for label, long_runs in (("runs of 1..59", False),
                                 ("with runs of 10^5 and 10^6", True)):
            words = sorted_words(gen, n, n_words, long_runs)
            require_equal(run_length_sum.run_length_sum_fused(words, weights),
                          run_length_sum.run_length_sum_fused_plain(words, weights),
                          f"sum W={n_words} {label}")
            ms = cuda_ms(lambda: run_length_sum.run_length_sum_fused(words, weights), 20)
            text.append(f"{label} {ms:.4f} ms")
        odd = [torch.cat([w[:1], w])[1:] for w in words + [weights]]
        odd_ms = cuda_ms(lambda: run_length_sum.run_length_sum_fused(odd[:-1], odd[-1]), 10)
        print(f"sum W={n_words} n={n}: equal, {'; '.join(text)}; rows at odd offsets "
              f"{odd_ms:.4f} ms; bound {bound_ms(n, n_words):.4f} ms", flush=True)
        del words, odd, weights


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
                name in line for name in ("sum_kernel", "count_kernel")):
            print("ptxas:", line.strip()[:150])
            for extra in lines[i + 1:i + 4]:
                if "registers" in extra or "spill" in extra:
                    print("ptxas:   ", extra.strip())
    sys.stdout.flush()

    print(f"{check_cases()} sum cases at tile {testing.SUM_TILE} equal to plain, "
          f"aligned and at odd offsets, one launch each", flush=True)
    time_final_merge_shape()
    if not quick:
        time_widths()
    return 0


if __name__ == "__main__":
    sys.exit(main())
