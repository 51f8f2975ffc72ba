#!/usr/bin/env python3
"""Check and time the result stage's kernels (hysortk_tpu_torch
ops/compact.compact_kept, counts_histogram and gather_runs;
csrc/kept_rows.cu) on one CUDA card.

    python3 tools/bench_torch_kept_rows.py [--profile]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. On a synthetic sorted block of 2^26 slots laid out as phase 2 of
chip_smoke.py leaves it (runs of geometric lengths, the count at each run's
head, heads kept where the count lies in [2, 50], two key words), prints
the card's name and power limit, then CUDA-event means after one warm-up
of:

  - compact_kept with the histogram (the main path's result), mixed keys
    unmixed (the range route's), the slots and offsets (extension mode),
    and the output that does not sync (the streams' compact step), each
    beside its plain version, the library composition torch.nonzero +
    index_select + bincount, and its byte bound;
  - counts_histogram of the kept counts beside torch.bincount;
  - gather_runs of the kept runs' occurrences beside its plain version
    (repeat_interleave) and its byte bound.

Each result is first checked exactly equal to its plain version. Any
mismatch raises. --profile adds the main path's compaction by kernel from a
torch.profiler trace (device time a call), and the streamed extension
merge's gather step (pipeline.gather_kept_ext) on four unfiltered partials
of 2^24 slots, timed and by kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hysortk_tpu_torch import _build, testing  # noqa: E402
from hysortk_tpu_torch.ops import compact  # noqa: E402

N = 1 << 26
LOWER, UPPER = 2, 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def cuda_ms(fn, reps: int = 10) -> float:
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


def block(seed: int = 1, n: int = N):
    """(words, cnt, keep, rid, pos) of a sorted counted block of n slots."""
    rng = np.random.default_rng(seed)
    runs = rng.geometric(1 / 16, n // 8)
    runs = runs[np.cumsum(runs) <= n]
    if runs.sum() < n:
        runs = np.append(runs, n - runs.sum())
    heads = np.concatenate([[0], np.cumsum(runs)[:-1]])
    dev = torch.device("cuda")
    keys = torch.sort(torch.randint(0, 2**62, (runs.size,), device=dev)).values
    rep = torch.from_numpy(runs).to(dev)
    flat = torch.repeat_interleave(keys, rep)
    words = [(flat >> 32).to(torch.int32), (flat & 0xFFFFFFFF).to(torch.int32)]
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    cnt[torch.from_numpy(heads).to(dev)] = rep.to(torch.int32)
    keep = (cnt >= LOWER) & (cnt <= UPPER)
    rid = torch.randint(0, 2**31 - 1, (n,), dtype=torch.int32, device=dev)
    pos = torch.randint(0, 2**31 - 1, (n,), dtype=torch.int32, device=dev)
    return words, cnt, keep, rid, pos


def same(got, want) -> None:
    for name in ("keys", "counts", "hist", "slots", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            continue
        pairs = zip(g, w) if isinstance(w, list) else [(g, w)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"compact_kept's {name} differ from the plain version")
    if int(got.m) != int(want.m) or got.occ != want.occ:
        raise AssertionError("compact_kept's row or occurrence count differs")


def profile(fn, reps: int = 10) -> None:
    """Device time by kernel of `reps` calls of fn, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if dev_us > 0:
            print(f"  profile: {e.key[:70]}: {dev_us / reps / 1e3:.4f} ms a call, "
                  f"{e.count // reps} a call", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_kept_rows: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    words, cnt, keep, rid, pos = block()
    m = int(keep.sum())
    print(f"block: {N} slots, two key words, {m} kept", flush=True)

    def library():
        idx = torch.nonzero(keep).squeeze(1)
        kept = cnt.index_select(0, idx)
        return ([w.index_select(0, idx) for w in words],
                torch.bincount(kept.to(torch.int64), minlength=UPPER + 2))

    modes = {
        "histogram": dict(upper=UPPER, hist_upper=UPPER),
        "mixed": dict(upper=UPPER, hist_upper=UPPER, mixed=True),
        "slots+offsets": dict(slots=True, offsets=True),
        "no sync": dict(rows=True, sync=False),
    }
    # Each input read once (keep, and of the count and the words the
    # 32-byte sectors that hold a kept slot: testing.kept_read_bytes), each
    # output written once (the kept rows' words, the narrowed or int32
    # count, the slot and offset where asked).
    read_bytes = testing.kept_read_bytes(keep, [*words, cnt])
    for name, mode in modes.items():
        got = compact.compact_kept(words, cnt, keep, **mode)
        same(got, compact.compact_kept_plain(words, cnt, keep, **mode))
        out_bytes = m * (8 + got.counts.element_size()) + 8 * m * bool(mode.get("slots"))
        if not mode.get("sync", True):
            out_bytes = N * (8 + 4)
        bound = (read_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        before = _build.launches["kept_rows"]
        t = cuda_ms(lambda: compact.compact_kept(words, cnt, keep, **mode))
        if _build.launches["kept_rows"] == before:
            raise AssertionError("compact_kept launched no kernel")
        p = cuda_ms(lambda: compact.compact_kept_plain(words, cnt, keep, **mode), 3)
        print(f"compact_kept {name}: kernel {t:.4f} ms, plain {p:.4f} ms, "
              f"bound {bound:.4f} ms (bytes)", flush=True)
    print(f"library composition (nonzero + index_select + bincount): "
          f"{cuda_ms(library):.4f} ms", flush=True)
    if "--profile" in sys.argv:
        profile(lambda: compact.compact_kept(words, cnt, keep, **modes["histogram"]))

    kept_cnt = compact.compact_kept([cnt], cnt, keep).keys[:, 0].contiguous()
    h = compact.counts_histogram(kept_cnt, UPPER)
    if not torch.equal(h, compact.counts_histogram_plain(kept_cnt, UPPER)):
        raise AssertionError("counts_histogram differs from the plain version")
    print(f"counts_histogram of {m} counts: kernel "
          f"{cuda_ms(lambda: compact.counts_histogram(kept_cnt, UPPER)):.4f} ms, "
          f"bincount {cuda_ms(lambda: torch.bincount(kept_cnt, minlength=UPPER + 1)):.4f} ms",
          flush=True)

    kept = compact.compact_kept(words, cnt, keep, slots=True, offsets=True)
    args = (kept.slots, kept.counts, rid, pos)
    got = compact.gather_runs(*args, offsets=kept.offsets, total=kept.occ)
    want = compact.gather_runs_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("gather_runs differs from the plain version")
    bound = (16 * kept.occ + 8 * m) / HBM_BYTES_PER_S * 1e3
    t = cuda_ms(lambda: compact.gather_runs(*args, offsets=kept.offsets, total=kept.occ))
    p = cuda_ms(lambda: compact.gather_runs_plain(*args), 3)
    print(f"gather_runs {m} runs, {kept.occ} occurrences: kernel {t:.4f} ms, plain "
          f"(repeat_interleave) {p:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
    if "--profile" in sys.argv:
        merge_gather(rid, pos)
    print(smi.stdout.strip(), flush=True)
    return 0


def merge_gather(rid, pos, parts: int = 4) -> None:
    """The streamed extension merge's third step (pipeline.gather_kept_ext)
    on `parts` unfiltered partials of 2^24 slots each (every run kept), as
    phase 8(c) of chip_smoke.py merges them: its CUDA-event time and its
    device time by kernel."""
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import count as count_ops
    from hysortk_tpu_torch.ops import run_length_sum

    held = []
    for seed in range(parts):
        words, cnt, _, _, _ = block(seed + 2, N // parts)
        kept = compact.compact_kept(words, cnt, cnt > 0, offsets=True)
        held.append(pipeline.ExtPartial(kept.keys, kept.counts, rid[:kept.occ].clone(),
                                        pos[:kept.occ].clone()))
        del words, cnt
    words_s, counts_s, starts_s = pipeline.merge_ext_rows(held)
    head, total = run_length_sum.run_length_sum_fused(words_s, counts_s)
    keep = count_ops.frequency_filter(head, total, LOWER, UPPER)
    step = lambda: pipeline.gather_kept_ext(held, words_s, counts_s, starts_s, head,
                                            total, keep, UPPER)
    print(f"gather_kept_ext over {parts} partials, {words_s[0].shape[0]} merged rows: "
          f"{cuda_ms(step, 5):.4f} ms", flush=True)
    profile(step, 5)


if __name__ == "__main__":
    sys.exit(main())
