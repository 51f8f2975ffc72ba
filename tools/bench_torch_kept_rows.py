#!/usr/bin/env python3
"""Check and time the result stage's kernels (hysortk_tpu_torch
ops/compact.compact_kept, counts_histogram and gather_runs;
csrc/kept_rows.cu) on one CUDA card.

    python3 tools/bench_torch_kept_rows.py [--tree DIR] [--profile] [--probe]
    python3 tools/bench_torch_kept_rows.py --turns DIR,DIR,...

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. `--tree` names the checkout whose hysortk_tpu_torch is imported
(default: this one). The inputs are the blocks the main paths hand the
compaction, made on the card from seeded reads (tools/
bench_torch_single_device.py's: a 2^22-base genome sampled into 150-base
reads, 2^26 bases, K=31, L=2, U=50) through the tree's own kernels: phase
2's sorted, counted block of chip_smoke.py (keybuild, radix sort, count),
9(a)'s (the keys mixed before the sort), 8(a)'s (extension mode). Prints the
card's name and power limit, then, each checked exactly equal to its plain
version first, CUDA-event means (10 calls after a warm-up, each call's host
read included) of compact_kept with the histogram at phase 2's shape, with
the mixed keys unmixed at 9(a)'s, with slots and offsets at 8(a)'s, the
output that does not sync (the streams' compact step) at phase 2's, and
counts_histogram of 8(a)'s kept counts; each beside its plain version, its
byte bound (keep, the 32-byte sectors of the words and the count that hold
a kept slot: testing.kept_read_bytes, and the outputs), and torch.nonzero +
index_select + bincount at phase 2's; then gather_runs at 8(a)'s shape.
The last line is one JSON object of the kernel times.

--turns runs the timing alone (no plain versions) once per tree, in the
order given, each in a process of its own (for example parent, change,
change, parent), and prints each turn's times.

--probe times tools/kept_sector_probe.cu (built at first use into
build/probe/) at phase 2's keep: keep read once and, of the two key words
and the count, the 32-byte sectors, then the 64-byte pieces, that hold a
kept slot; then every piece (a dense read). The floor under the
compaction's reads, and which granularity the card pays for.

--profile prints the compaction's device time by kernel at phase 2's shape
(both modes) from a torch.profiler trace, and the streamed extension
merge's gather step (pipeline.gather_kept_ext) on four unfiltered
partials, timed and by kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, LOWER, UPPER = 31, 2, 50
BASES = 1 << 26
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def cuda_ms(fn, reps: int = 10) -> float:
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def blocks():
    """{shape: (words, cnt, keep)} of phase 2, 9(a) and 8(a), and 8(a)'s
    sorted read ids and positions, made on the card."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from bench_torch_single_device import seeded_reads

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import fused_count, keybuild, mixkey, radix_sort, wire

    codes, lengths = seeded_reads(BASES)
    cfg = ht.KmerConfig(k=K, m=17, lower=LOWER, upper=UPPER, fuse_keybuild=True,
                        fuse_count=True, sort_backend="auto")
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, "cuda")
    codes_d, valid = wire.decode_block(packed, lens, K, n)
    marked = keybuild.canonical_keys_fused(codes_d, valid, K)
    out = {}
    words, _ = radix_sort.sort_words(marked)
    out["phase2"] = (words, *fused_count.run_length_count_filter(words, LOWER, UPPER))
    mixed, _ = radix_sort.sort_words(mixkey.mix_keys(marked))
    out["9a"] = (mixed, *fused_count.run_length_count_filter(mixed, LOWER, UPPER))
    del codes_d, valid, marked
    dev = wire.decode_block_ext(packed, lens, K, n, 0)
    words, cnt, keep, rid, pos = pipeline._count_device_ext(*dev, K, LOWER, UPPER)
    out["8a"] = (words, cnt, keep)
    return out, rid, pos


def modes(shapes):
    """(name, shape, compact_kept keywords, output bytes a kept row or None
    for n rows of 4 W + 4, unmix operations a kept row)."""
    w = len(shapes["phase2"][0])
    return [
        ("phase 2 (histogram)", "phase2", dict(upper=UPPER, hist_upper=UPPER), 4 * w + 1, 0),
        ("9(a) (mixed keys unmixed)", "9a", dict(upper=UPPER, hist_upper=UPPER, mixed=True),
         4 * w + 1, 24 * w),
        ("8(a) (slots, offsets)", "8a", dict(slots=True, offsets=True), 4 * w + 12, 0),
        ("sync=False (streams' compact step)", "phase2", dict(rows=True, sync=False), None, 0),
    ]


def same(got, want) -> None:
    for name in ("keys", "counts", "hist", "slots", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        if (g is None) != (w is None):
            raise AssertionError(f"compact_kept's {name} given by one version only")
        if w is None:
            continue
        pairs = zip(g, w) if isinstance(w, list) else [(g, w)]
        if not all(a.dtype == b.dtype and torch_equal(a, b) for a, b in pairs):
            raise AssertionError(f"compact_kept's {name} differ from the plain version")
    if int(got.m) != int(want.m) or got.occ != want.occ:
        raise AssertionError("compact_kept's row or occurrence count differs")


def torch_equal(a, b) -> bool:
    import torch

    return torch.equal(a.cpu(), b.cpu())


def time_modes(shapes, plain: bool) -> dict:
    """{mode: kernel ms} (and the plain versions' where `plain`), each
    result checked against its plain version first."""
    from hysortk_tpu_torch import _build, testing
    from hysortk_tpu_torch.ops import compact

    times = {}
    for name, shape, kw, row_bytes, ops in modes(shapes):
        words, cnt, keep = shapes[shape]
        got = compact.compact_kept(words, cnt, keep, **kw)
        same(got, compact.compact_kept_plain(words, cnt, keep, **kw))
        before = _build.launches["kept_rows"]
        t = cuda_ms(lambda: compact.compact_kept(words, cnt, keep, **kw))
        if _build.launches["kept_rows"] == before:
            raise AssertionError("compact_kept launched no kernel")
        times[name] = t
        if not plain:
            continue
        m, n = int(got.m), keep.numel()
        out = (row_bytes * m if row_bytes else n * (4 * len(words) + 4))
        read = testing.kept_read_bytes(keep, [*words, cnt])
        b = max((read + out) / HBM_BYTES_PER_S, (2 * n + ops * m) / 67e12) * 1e3
        p = cuda_ms(lambda: compact.compact_kept_plain(words, cnt, keep, **kw), 3)
        print(f"compact_kept {name}: n={n} m={m}: kernel {t:.4f} ms, plain {p:.4f} ms, "
              f"bound {b:.4f} ms ({read} B read, {out} B written)", flush=True)
    words, cnt, keep = shapes["8a"]
    counts = compact.compact_kept(words, cnt, keep, slots=True, offsets=True).counts
    h = compact.counts_histogram(counts, UPPER)
    if not torch_equal(h, compact.counts_histogram_plain(counts, UPPER)):
        raise AssertionError("counts_histogram differs from the plain version")
    times["histogram-only"] = cuda_ms(lambda: compact.counts_histogram(counts, UPPER))
    if plain:
        import torch

        print(f"counts_histogram of 8(a)'s {counts.numel()} kept counts: kernel "
              f"{times['histogram-only']:.4f} ms, bincount "
              f"{cuda_ms(lambda: torch.bincount(counts, minlength=UPPER + 1)):.4f} ms, "
              f"bound {4 * counts.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    return times


def library(shapes) -> None:
    import torch

    words, cnt, keep = shapes["phase2"]

    def chain():
        idx = torch.nonzero(keep).squeeze(1)
        kept = cnt.index_select(0, idx)
        return ([w.index_select(0, idx) for w in words],
                torch.bincount(kept.to(torch.int64), minlength=UPPER + 2))

    print(f"library composition at phase 2's shape (nonzero + index_select + bincount): "
          f"{cuda_ms(chain):.4f} ms", flush=True)


def gather(shapes, rid, pos) -> None:
    from hysortk_tpu_torch.ops import compact

    words, cnt, keep = shapes["8a"]
    kept = compact.compact_kept(words, cnt, keep, slots=True, offsets=True)
    args = (kept.slots, kept.counts, rid, pos)
    got = compact.gather_runs(*args, offsets=kept.offsets, total=kept.occ)
    if not all(torch_equal(a, b) for a, b in zip(got, compact.gather_runs_plain(*args))):
        raise AssertionError("gather_runs differs from the plain version")
    m = int(kept.m)
    bound = (16 * kept.occ + 8 * m) / HBM_BYTES_PER_S * 1e3
    t = cuda_ms(lambda: compact.gather_runs(*args, offsets=kept.offsets, total=kept.occ))
    p = cuda_ms(lambda: compact.gather_runs_plain(*args), 3)
    print(f"gather_runs at 8(a)'s shape, {m} runs, {kept.occ} occurrences: kernel {t:.4f} "
          f"ms, plain (repeat_interleave) {p:.4f} ms, bound {bound:.4f} ms (bytes)",
          flush=True)


def nvcc_library(name: str, sources: list[str]) -> str:
    """A shared library built from `sources` by nvcc for sm_90a into
    build/<name>/<hash>/ (reused while the sources stay)."""
    from hysortk_tpu_torch import _build

    digest = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(ROOT, "build", name, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        cmd = [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources}:\n{proc.stderr[-4000:]}")
    return lib


def probe(shapes) -> None:
    """The sector probe at phase 2's keep (module docstring)."""
    import torch

    from hysortk_tpu_torch import testing

    lib = ctypes.CDLL(nvcc_library("probe", [os.path.join(ROOT, "tools",
                                                          "kept_sector_probe.cu")]))
    lib.hk_probe_sectors.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    words, cnt, keep = shapes["phase2"]
    rows = [*words, cnt]
    n = keep.numel()
    if n % 16 or any(r.data_ptr() % 64 for r in rows) or keep.data_ptr() % 16:
        raise AssertionError("the probe takes 64-byte aligned rows and n a multiple of 16")
    ptrs = (ctypes.c_void_p * len(rows))(*[r.data_ptr() for r in rows])
    sink = torch.zeros(1, dtype=torch.int32, device=keep.device)
    grid = torch.cuda.get_device_properties(keep.device).multi_processor_count * 8
    stream = torch.cuda.current_stream().cuda_stream
    idx = torch.nonzero(keep).squeeze(1)

    def run(gran, dense):
        status = lib.hk_probe_sectors(keep.data_ptr(), ptrs, len(rows), n, gran, dense,
                                      sink.data_ptr(), grid, stream)
        if status != 0:
            raise RuntimeError(f"probe launch: CUDA error {status}")

    for gran, dense in ((32, 0), (64, 0), (64, 1)):
        per_row = n // (gran // 4) if dense else int(
            torch.unique_consecutive(idx // (gran // 4)).numel())
        pieces = per_row * len(rows)
        read = n + gran * pieces
        t = cuda_ms(lambda: run(gran, dense))
        print(f"sector probe at phase 2's keep, {'every' if dense else 'kept'} {gran}-byte "
              f"piece{'' if dense else 's'} of {len(rows)} rows: {t:.4f} ms for {read} B "
              f"({read / t / 1e9:.2f} TB/s; the bytes at 3.35 TB/s "
              f"{read / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    print(f"(testing.kept_read_bytes at phase 2's keep: "
          f"{testing.kept_read_bytes(keep, rows)} B)", flush=True)


def profile(fn, reps: int = 10) -> None:
    """Device time by kernel of `reps` calls of fn, from torch.profiler."""
    import torch
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


def merge_gather(rid, pos, parts: int = 4) -> None:
    """The streamed extension merge's third step (pipeline.gather_kept_ext)
    on `parts` unfiltered partials cut from 8(a)'s reads' slots: its
    CUDA-event time and its device time by kernel."""
    import torch

    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import compact
    from hysortk_tpu_torch.ops import count as count_ops
    from hysortk_tpu_torch.ops import run_length_sum

    rng = np.random.default_rng(3)
    held = []
    for _ in range(parts):
        n = BASES // parts
        runs = rng.geometric(1 / 4, n // 2)
        runs = runs[np.cumsum(runs) <= n]
        keys = torch.sort(torch.randint(0, 2**62, (runs.size,), device="cuda")).values
        rep = torch.from_numpy(runs).cuda()
        flat = torch.repeat_interleave(keys, rep)
        words = [(flat >> 32).to(torch.int32), (flat & 0xFFFFFFFF).to(torch.int32)]
        heads = torch.from_numpy(np.concatenate([[0], np.cumsum(runs)[:-1]])).cuda()
        cnt = torch.zeros(flat.numel(), dtype=torch.int32, device="cuda")
        cnt[heads] = rep.to(torch.int32)
        kept = compact.compact_kept(words, cnt, cnt > 0, offsets=True)
        held.append(pipeline.ExtPartial(kept.keys, kept.counts, rid[:kept.occ].clone(),
                                        pos[:kept.occ].clone()))
    words_s, counts_s, starts_s = pipeline.merge_ext_rows(held)
    head, total = run_length_sum.run_length_sum_fused(words_s, counts_s)
    keep = count_ops.frequency_filter(head, total, LOWER, UPPER)
    step = lambda: pipeline.gather_kept_ext(held, words_s, counts_s, starts_s, head,
                                            total, keep, UPPER)
    print(f"gather_kept_ext over {parts} partials, {words_s[0].shape[0]} merged rows: "
          f"{cuda_ms(step, 5):.4f} ms", flush=True)
    profile(step, 5)


def turns(trees: list[str]) -> None:
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                               "--times-only"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"turn on {tree} failed:\n{proc.stdout[-2000:]}"
                               f"{proc.stderr[-4000:]}")
        results.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
    for tree, times in results:
        print(f"turn {tree}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)
    print(json.dumps({"turns": [{"tree": t, "ms": times} for t, times in results]}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--turns")
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_kept_rows: no CUDA device", file=sys.stderr)
        return 1
    if args.turns:
        print(card(), flush=True)
        turns(args.turns.split(","))
        print(card(), flush=True)
        return 0
    sys.path.insert(0, os.path.abspath(args.tree))
    shapes, rid, pos = blocks()
    if args.times_only:
        print(json.dumps(time_modes(shapes, plain=False)), flush=True)
        return 0
    print(card(), flush=True)
    times = time_modes(shapes, plain=True)
    library(shapes)
    gather(shapes, rid, pos)
    if args.profile:
        from hysortk_tpu_torch.ops import compact

        for name, shape, kw, _, _ in modes(shapes):
            print(f"profile of compact_kept {name}:", flush=True)
            profile(lambda: compact.compact_kept(*shapes[shape], **kw))
    if args.probe:
        probe(shapes)
    if args.profile:
        merge_gather(rid, pos)
    print(card(), flush=True)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
