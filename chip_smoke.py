#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an sm_90 card (H100) and
the CUDA toolkit; the kernels are built from hysortk_tpu_torch/csrc into
build/kernels/ at first use. Phases, each printing its findings:

  0  the card (nvidia-smi name and power limit), versions, kernel build time
  1  each kernel against its plain PyTorch version on the card, exactly
     equal, timed with CUDA events: synthetic cases (top-bit keys,
     duplicates, sentinel tails, poly-A-length runs), then the inputs the
     main path gives each kernel at the size of phase 2
  2  the slice at a size users run: a seeded 2^22-base genome sampled into
     150-base reads at ~16x coverage (2^26 bases), written as FASTA, then
     read_dna_buffer -> kmer_count(K=31, L=2, U=50, device="cuda") ->
     print_kmer_histogram -> write_output_file; every kernel's launch
     count must rise, and the result must equal the plain functions
     composed on the same CUDA tensors
  3  a FASTA under 10 kB through the facade on the card against the
     pure-Python oracle

Any failure raises (exit code 1). Without a CUDA device the script exits 1
before printing any result. The last two lines of standard output are the
per-kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
K, M, LOWER, UPPER = 31, 17, 2, 50
GENOME_BASES = 1 << 22
READ_LEN = 150
N_READS = (1 << 26) // READ_LEN  # 2^26 bases of reads, ~16x coverage


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
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


def max_abs_err(got, want) -> int:
    """Largest |got - want| over lists of tensors: int32 key words read as
    unsigned, counts and bool masks as integers."""
    import torch

    from hysortk_tpu_torch.ops.kmer import widen

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{g.dtype}{tuple(g.shape)} != {w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.int32:
            g, w = widen(g), widen(w)
        else:
            g, w = g.to(torch.int64), w.to(torch.int64)
        if g.numel():
            err = max(err, int((g - w).abs().max()))
    return err


def require_equal(name: str, err: int) -> None:
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, max |err| {err}")


# --------------------------------------------------------------------------
# Phase 0


def phase0_device():
    import torch

    from hysortk_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"phase0 python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    log(f"phase0 kernel build+load {time.perf_counter() - t0:.3f} s -> "
        f"{os.path.relpath(path, ROOT)}")
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("phase0 ptxas:", line.strip())
    return smi


# --------------------------------------------------------------------------
# Phase 1


def phase1_synthetic(gen):
    """Kernels against plain versions on synthetic worst cases. Returns the
    largest error seen per kernel."""
    import torch

    from hysortk_tpu_torch.ops import fused_count, keybuild, radix_sort, wire

    errs = {"keybuild": 0, "radix_sort": 0, "fused_count": 0}
    dev = "cuda"
    n = 1 << 24

    # keybuild: random codes, reads of random lengths (some shorter than k).
    codes = torch.randint(0, 4, (n,), dtype=torch.int8, device=dev, generator=gen)
    lengths = torch.randint(1, 300, (n // 150,), dtype=torch.int32, device=dev,
                            generator=gen)
    for k in (15, 31, 55):
        valid = wire.valid_from_lengths(lengths, k, n)
        got = keybuild.canonical_keys_fused(codes, valid, k)
        want = keybuild.canonical_keys_plain(codes, valid, k)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"keybuild k={k}", e)
        ms = cuda_ms(lambda: keybuild.canonical_keys_fused(codes, valid, k), 10)
        pms = cuda_ms(lambda: keybuild.canonical_keys_plain(codes, valid, k), 3)
        log(f"phase1 keybuild k={k} n={n}: equal, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
        errs["keybuild"] = max(errs["keybuild"], e)
    del codes, lengths, valid, got, want

    # sort: full-range words (top bit set in half of them), a pool of
    # duplicates, word-0 ties that differ only in the last word, and a
    # sentinel tail.
    for w_count, size in ((1, 1 << 24), (2, 1 << 24), (4, 1 << 24), (2, 1 << 26)):
        words = [
            torch.randint(-2**31, 2**31, (size,), dtype=torch.int32, device=dev,
                          generator=gen)
            for _ in range(w_count)
        ]
        dup = torch.randint(0, size, (size // 4,), device=dev, generator=gen)
        pool = torch.randint(0, 4096, (size // 4,), device=dev, generator=gen)
        for w in words:
            w[dup] = w[pool]
        tie = torch.randint(0, size, (size // 4,), device=dev, generator=gen)
        words[0][tie] = torch.tensor(-2**31 + 7, dtype=torch.int32, device=dev)
        for w in words:
            w[-size // 8:] = -1
        got, _ = radix_sort.sort_words(words)
        want, _ = radix_sort.sort_words_plain(words)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"radix_sort W={w_count} n={size}", e)
        ms = cuda_ms(lambda: radix_sort.sort_words(words), 5)
        pms = cuda_ms(lambda: radix_sort.sort_words_plain(words), 3)
        log(f"phase1 radix_sort W={w_count} n={size}: equal, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
        errs["radix_sort"] = max(errs["radix_sort"], e)
        del words, got, want

    # count: sorted W=2 keys whose runs include poly-A lengths (10^5, 10^6),
    # runs at exactly L and U, top-bit keys, then a sentinel tail.
    size = 1 << 26
    tail = size // 8
    runs = torch.randint(1, 60, (size // 20,), device=dev, generator=gen)
    runs[::997] = LOWER
    runs[1::997] = UPPER
    runs[5] = 100_000
    runs[7] = 1_000_000
    total = torch.cumsum(runs, 0)
    runs = runs[: int((total <= size - tail).sum())]
    n_runs = runs.shape[0]
    hi = torch.randint(0, 2**31, (n_runs,), dtype=torch.int64, device=dev,
                       generator=gen)
    lo = torch.randint(0, 2**31, (n_runs,), dtype=torch.int64, device=dev,
                       generator=gen)
    keys = torch.unique((hi << 33) ^ (lo << 1))  # distinct, ascending as int64
    keys = keys[: n_runs]
    runs = runs[: keys.shape[0]]
    keys = keys ^ -(1 << 63)  # flip the sign bit: signed order -> unsigned order
    body = torch.repeat_interleave(keys, runs)
    full = torch.full((size - body.shape[0],), -1, dtype=torch.int64, device=dev)
    flat = torch.cat([body, full])
    from hysortk_tpu_torch.ops.kmer import narrow

    words = [narrow(flat >> 32), narrow(flat)]
    got = fused_count.run_length_count_filter(words, LOWER, UPPER)
    want = fused_count.run_length_count_filter_plain(words, LOWER, UPPER)
    torch.cuda.synchronize()
    e = max_abs_err(got, want)
    require_equal("fused_count", e)
    if int(got[0].max()) != 1_000_000:
        raise AssertionError("the 10^6-slot run was not counted whole")
    ms = cuda_ms(lambda: fused_count.run_length_count_filter(words, LOWER, UPPER), 10)
    pms = cuda_ms(lambda: fused_count.run_length_count_filter_plain(words, LOWER, UPPER), 3)
    log(f"phase1 fused_count W=2 n={size}: equal, kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    errs["fused_count"] = max(errs["fused_count"], e)
    return errs


def phase1_main_path(codes_np, lengths_np, errs):
    """Each kernel against its plain version on the very inputs the main
    path gives it in phase 2 (same padding, same decode). Returns each
    kernel's (kernel ms, plain ms)."""
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import fused_count, keybuild, radix_sort

    codes, valid = pipeline.device_batch(codes_np, lengths_np, slice_config(), "cuda")
    n = codes.shape[0]
    marked = keybuild.canonical_keys_fused(codes, valid, K)
    e = max_abs_err(marked, keybuild.canonical_keys_plain(codes, valid, K))
    require_equal("keybuild main path", e)
    kb = (cuda_ms(lambda: keybuild.canonical_keys_fused(codes, valid, K), 10),
          cuda_ms(lambda: keybuild.canonical_keys_plain(codes, valid, K), 3))
    errs["keybuild"] = max(errs["keybuild"], e)

    sorted_words, _ = radix_sort.sort_words(marked)
    e = max_abs_err(sorted_words, radix_sort.sort_words_plain(marked)[0])
    require_equal("radix_sort main path", e)
    rs = (cuda_ms(lambda: radix_sort.sort_words(marked), 5),
          cuda_ms(lambda: radix_sort.sort_words_plain(marked), 3))
    errs["radix_sort"] = max(errs["radix_sort"], e)

    got = fused_count.run_length_count_filter(sorted_words, LOWER, UPPER)
    e = max_abs_err(
        got, fused_count.run_length_count_filter_plain(sorted_words, LOWER, UPPER)
    )
    require_equal("fused_count main path", e)
    fc = (cuda_ms(lambda: fused_count.run_length_count_filter(
              sorted_words, LOWER, UPPER), 10),
          cuda_ms(lambda: fused_count.run_length_count_filter_plain(
              sorted_words, LOWER, UPPER), 3))
    errs["fused_count"] = max(errs["fused_count"], e)

    times = {"keybuild": kb, "radix_sort": rs, "fused_count": fc}
    for name, (ms, pms) in times.items():
        log(f"phase1 {name} main-path n={n} K={K}: equal, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
    return times


KERNELS = {
    "keybuild": ("hysortk_tpu_torch/csrc/keybuild.cu",
                 "hysortk_tpu/ops/keybuild.py:173"),
    # With the merge levels of hysortk_tpu/ops/pallas_sort.py:392.
    "radix_sort": ("hysortk_tpu_torch/csrc/radix_sort.cu",
                   "hysortk_tpu/ops/pallas_msort.py:396"),
    "fused_count": ("hysortk_tpu_torch/csrc/fused_count.cu",
                    "hysortk_tpu/ops/pallas_count.py:180"),
}


# --------------------------------------------------------------------------
# Phase 2


def write_reads_fasta(path: str, rng) -> None:
    """Seeded genome -> 150-base reads, half reverse-complemented, 0.5%
    substitutions, a few Ns, as a 60-column FASTA."""
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    starts = rng.integers(0, GENOME_BASES - READ_LEN + 1, N_READS)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flip = rng.random(N_READS) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)[reads]
    n_pos = rng.integers(0, reads.size, 1000)
    ascii_.reshape(-1)[n_pos] = ord("N")

    # >r0000000\n + 60 + \n + 60 + \n + 30 + \n per read
    ids = np.arange(N_READS)
    digits = (ids[:, None] // 10 ** np.arange(6, -1, -1)[None, :]) % 10
    header = np.concatenate(
        [np.full((N_READS, 2), [ord(">"), ord("r")], dtype=np.uint8),
         (digits + ord("0")).astype(np.uint8)], axis=1)
    nl = np.full((N_READS, 1), ord("\n"), dtype=np.uint8)
    rows = np.concatenate(
        [header, nl, ascii_[:, :60], nl, ascii_[:, 60:120], nl,
         ascii_[:, 120:], nl], axis=1)
    with open(path, "wb") as f:
        f.write(rows.tobytes())


def slice_config():
    """The production configuration of the single-device path (bench.py's:
    fused keybuild, fused count, auto sort; these three select nothing in
    the port, whose CUDA path always runs its kernels)."""
    import hysortk_tpu_torch as ht

    return ht.KmerConfig(k=K, m=M, lower=LOWER, upper=UPPER,
                         fuse_keybuild=True, fuse_count=True, sort_backend="auto")


def plain_count_reads(codes_np, lengths_np, cfg):
    """The slice composed from the plain versions, on the card."""
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import fused_count, keybuild, radix_sort

    codes, valid = pipeline.device_batch(codes_np, lengths_np, cfg, "cuda")
    marked = keybuild.canonical_keys_plain(codes, valid, cfg.k)
    words, _ = radix_sort.sort_words_plain(marked)
    cnt, keep = fused_count.run_length_count_filter_plain(
        words, cfg.lower, cfg.upper
    )
    kl = pipeline.compact_keys(words, cnt, keep, cfg.k)
    return kl, pipeline.host_histogram(kl.counts, cfg.upper)


def phase2_slice(workdir: str, rng):
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build

    fasta = os.path.join(workdir, "reads.fa")
    t0 = time.perf_counter()
    write_reads_fasta(fasta, rng)
    log(f"phase2 wrote {N_READS} reads x {READ_LEN} bases "
        f"({os.path.getsize(fasta)} B FASTA) in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    codes, lengths = ht.read_dna_buffer(fasta)
    log(f"phase2 read_dna_buffer {int(codes.size)} bases, {lengths.size} reads "
        f"in {time.perf_counter() - t0:.3f} s")
    cfg = slice_config()
    n_kmers = int(np.maximum(lengths - K + 1, 0).sum())

    _build.reset_launches()
    t0 = time.perf_counter()
    kl, hist = ht.kmer_count(codes, lengths, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        kl, hist = ht.kmer_count(codes, lengths, cfg, device="cuda")
        walls.append(time.perf_counter() - t0)
    launches = dict(_build.launches)
    log(f"phase2 launches during the main path: {json.dumps(launches)}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    best = min(walls)
    log(f"phase2 kmer_count first call {first_s:.4f} s; steady "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; best {best:.4f} s = "
        f"{n_kmers / best:.1f} k-mers/s ({n_kmers} k-mers)")

    text = ht.print_kmer_histogram(hist)
    out_path = ht.write_output_file(kl, os.path.join(workdir, "out"))
    with open(out_path, "rb") as f:
        lines = f.read().count(b"\n")
    if lines != len(kl):
        raise AssertionError(f"{out_path} has {lines} lines, list has {len(kl)}")

    pk, phist = plain_count_reads(codes, lengths, cfg)
    if not (np.array_equal(kl.keys, pk.keys) and np.array_equal(kl.counts, pk.counts)
            and np.array_equal(hist, phist)):
        raise AssertionError("kernel path differs from the plain composition")
    if not 2_000_000 <= len(kl) <= 8_000_000:
        raise AssertionError(f"{len(kl)} k-mers survived [{LOWER}, {UPPER}]")
    if int(hist.sum()) != len(kl) or text.count("\n") < 3:
        raise AssertionError("histogram does not match the list")
    log(f"phase2 {len(kl)} k-mers kept, equal to the plain composition; "
        f"histogram mode at count {int(np.argmax(hist))}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return codes, lengths, launches


# --------------------------------------------------------------------------
# Phase 3


def phase3_small(workdir: str, rng) -> None:
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.io import writer

    reads = testing.random_reads(rng, 40, 5, 180, "ACGTNacgt")
    reads += reads[:15]  # repeats so counts reach L
    path = os.path.join(workdir, "small.fa")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">s{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j:j + 60] + "\n")
    if os.path.getsize(path) >= 10_000:
        raise AssertionError("phase 3 FASTA is not under 10 kB")
    codes, lengths = ht.read_dna_buffer(path)
    for k in (15, 31, 55):
        cfg = ht.KmerConfig(k=k, m=min(M, k - 1), lower=2, upper=10)
        kl, hist = ht.kmer_count(codes, lengths, cfg, device="cuda")
        out_dir = os.path.join(workdir, f"small_out_k{k}")
        ht.write_output_file(kl, out_dir)
        got = {km.decode(): c for km, c in writer.parse_output_files(out_dir).items()}
        want = testing.oracle_filtered(reads, k, 2, 10)
        if got != want:
            raise AssertionError(f"phase 3 k={k}: {len(got)} k-mers vs oracle {len(want)}")
        want_hist = testing.oracle_histogram(want)
        if {c: int(v) for c, v in enumerate(hist) if v} != want_hist:
            raise AssertionError(f"phase 3 k={k}: histogram differs from the oracle")
        log(f"phase3 k={k}: {len(got)} k-mers equal to the oracle")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import hysortk_tpu_torch  # noqa: F401  (fails outside the repository)

    phase0_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = phase1_synthetic(gen)
    torch.cuda.empty_cache()

    scratch_root = os.path.join(ROOT, "build")
    os.makedirs(scratch_root, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch_root)
    try:
        codes, lengths, launches = phase2_slice(workdir, rng)
        torch.cuda.empty_cache()
        times = phase1_main_path(codes, lengths, errs)
        phase3_small(workdir, rng)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in KERNELS
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
