#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an sm_90 card (H100) and
the CUDA toolkit; the kernels are built from hysortk_tpu_torch/csrc into
build/kernels/ at first use. Phases, each printing its findings:

  0  the card (nvidia-smi name and power limit), versions, kernel build time;
     the host library's build time (csrc/host_io.cpp into build/host/),
     compiler and thread count
  1  each kernel against its plain PyTorch version on the card, exactly
     equal, timed with CUDA events: synthetic cases (top-bit keys,
     duplicates, sentinel tails, poly-A-length runs, runs of unequal fill),
     the sorts' hard cases of hysortk_tpu_torch.testing at the kernels' tile
     sizes (all keys equal, one varying digit, ragged and single-slot
     inputs, one to six key words, up to eight rows with arange payloads),
     the count's and the block sort's hard cases there (runs and sentinel
     tails against tile edges, tiles without a boundary, every block size
     from 2 to the largest, rows that are not 16-byte aligned), the run
     merge's and the key build's hard cases there (run counts of one pass
     and more, runs of one slot to two tiles, equal keys across tile edges,
     every key width, ragged sizes, inputs shorter than the halo, views at
     odd offsets), the key mix's hard cases (every key width, sentinel rows,
     top-bit and near-sentinel words, rows at odd offsets, ragged sizes), then
     the inputs the main paths give each kernel at the size of phases
     2 and 4, with each kernel's bound (the least time the card could take)
     and, where one PyTorch call computes the same function, that call's
     time
  2  the slice at a size users run: a seeded 2^22-base genome sampled into
     150-base reads at ~16x coverage (2^26 bases), written as FASTA, then
     read_dna_buffer -> kmer_count(K=31, L=2, U=50, device="cuda") ->
     print_kmer_histogram -> write_output_file; every kernel's launch
     count must rise, each call's histogram must come from the device
     (pipeline.device_histogram), and the result must equal the plain
     functions composed on the same CUDA tensors, and the host stages must
     have called the port's own host library (from build/host/); read_dna_buffer
     stage by stage (.fai build and write, .fai parse, partition,
     read_records) and again on the written .fai, each equal to the first;
     then the same count stage by stage with a synchronize after each, for
     the stage times (pack into pinned staging, which must be pinned; H2D;
     decode; keybuild; sort; count; compaction + D2H, with the copy-out's
     part; the device histogram,
     equal to host_histogram), each device stage also by CUDA events, and
     the device-busy share of the one-shot call (those events' sum over the
     best wall); then each of the host library's seven functions
     (.fai scan, FASTA strip, 2-bit pack, key decode, output lines, supermer
     run boundaries, run gather) on phase 2's reads and result, exactly
     equal to its numpy plain version, both timed
  3  a FASTA under 10 kB through the facade on the card against the
     pure-Python oracle
  4  bounded-memory streaming of phase 2's reads through
     count_reads_streaming(device="cuda"): (a) the default configuration in
     batches of 2^24 bases (host-held partials), (b) device_compact in
     batches of 2^22 bases (device-resident runs, consolidation cycles, the
     final device merge); each result equal to phase 2's, both streaming
     kernels launched in both runs, each run's stream/* spans and device
     idle share from a torch.profiler trace; then the out-of-memory drains under
     device_compact and HYSORTK_DEVICE_RESIDENT_GROUP=8, a per-process
     memory fraction leaving 64 MiB above what the allocator holds at the
     entry of (c) the first consolidation cycle (batches of 2^22) and (d)
     the final device merge (batches of 2^24): each logs its drain
     warning, finishes on the host and equals phase 2
  5  python -m hysortk_tpu_torch.cli on phase 3's FASTA, streaming, against
     the oracle
  6  phase 2's call again with HYSORTK_FUSED_SORT=1 (the key build fused
     into the sort's first pass): the same result, through the fused kernel
     and neither the separate key build nor the radix sort wrapper
  7  key build -> sort_words(formulation="roll") (block sort + run merge) ->
     fused count on phase 2's device batch: sorted words equal to the radix
     sort's, kept k-mers equal to phase 2's
  8  extension mode ((ReadId, PosInRead) per occurrence): kmer_count with
     extension=True on phase 2's reads, with a sample of its occurrences
     read back from the reads; the same call stage by stage (wire pack +
     H2D, device pipeline, gather + D2H + flat result with the copy-out's
     part, beside the former
     host flatten, whose read ids and positions equal the device's), its
     device outputs equal to the plain composition on the same CUDA
     tensors; (c) count_reads_streaming_ext, its partials held and merged
     on the card (never on the host), on phase 2's reads in batches of 2^24
     against (a) and on the first 2^24 bases in batches of 2^22 with a read
     id offset against count_reads_ext on the same reads (keys, counts,
     histogram, every k-mer's occurrences as sets), each with its peak, the
     held bytes, the merge's transient factor and the launches of
     merge_runs and run_length_sum, then the full-width call stage by stage
     (wire feed, batch steps, holding, merge_runs, run_length_sum, gather,
     D2H, device histogram); phase 3's FASTA through the facade and the CLI
     (--extension, one-shot and streamed) against an oracle of kmer ->
     (count, {(rid, pos)}); (e) the streamed call's out-of-memory drain: its
     device merge under a memory fraction 64 MiB above the allocator's
     holding logs its warning, finishes by the host merge, equals (c)
  9  the sharded range exchange (parallel/pipeline.count_reads_sharded:
     key build, mix, sort, pack, all_to_all, run merge of the received runs,
     count) on phase 2's reads: (a) one rank with NCCL in this process, best
     of three calls; (b) four spawned ranks sharing the card, over gloo with
     pinned host staging (NCCL refuses two ranks on one GPU); (c) the
     combiner forced on two spawned ranks, on the first 2^24 bases; each
     result equal to the one-shot result on the same reads after sorting by
     key, histogram included; per rank the walls, the peak device memory,
     the bytes sent, the time in the exchange and the kernels' launches
 10  the rest of the sharded pipeline on phase 2's reads and configuration:
     (a) count_reads_sharded_streaming, one rank with NCCL, in batches of
     2^24 bases (the final merge timed); (b) the same on two spawned ranks
     sharing the card over gloo; (c) count_reads_sharded_ext, one rank at
     2^26 bases against phase 8(a), then on two ranks on phase 8(c)'s 2^24
     bases one-shot and count_reads_sharded_ext_streaming in batches of
     2^22, both against phase 8(c)'s one-shot result; (d) minimizer routing
     with the balanced dispatcher, one rank (with a stage line: scan, bucket
     sizes and plan, pack, exchange, receive sort, count, result) and four
     spawned ranks; (e) on two ranks at 2^24 bases: minimizer with
     round_robin and the combiner, kmer_hash, kmer_hash with extension
     mode. Each result exactly equal to its reference after sorting by key
     (extension mode: every occurrence as sorted (key, rid, pos) rows); no
     run calls the host flatten (every extension route feeds the wire) or
     the host merge (the extension streams merge on the card, their merge
     kernels launched); per rank the wall, the peak device memory, the step
     passes, the bytes sent and the kernels' launches
 11  supermer routing (parallel/supermer_route.py: wire feed and decode,
     destination scan, bucket sizes on the card, classification and
     dispatch, the send side on the card (heavy pre-count, the run table
     and segment pack kernels), all_to_all, receive-side decode, key build,
     sort, count) with phase 2's configuration: first the encoder's and
     fill_run_meta's hard cases of hysortk_tpu_torch.testing on the card
     (each case's route result equal to kmer_count's, fill_run_meta equal
     to its CPU result); the send side's hard cases (the run table's cases,
     every encoder case at K = 15, 31, 55, 95 on 1, 2 and 4 destinations,
     extension mode off and on: each kernel equal to its plain version, the
     send tensor equal to the host encoder's); the two send-side kernels on
     11(a)'s inputs against their plain versions, timed beside their
     bounds, and the send tensor of phase 2's reads equal to the host
     encoder's at one and four destinations (four also in extension mode);
     (a) count_reads_sharded with routing="supermer" on phase 2's reads, one
     rank with NCCL, best of three, then two calls more under the route's
     own stage spans (runtime/timer.record_stages; the second's line,
     feed to result, logged), the wire bytes beside the range route's
     (9(a)), and no run boundary or run gather in the host library; the device heavy pre-count timed on (c)'s first reads
     under four ranks' buckets against the host pre-count; (b) four spawned
     ranks sharing the card
     over gloo; (c) the heavy-bucket pre-count on four ranks: phase 8(c)'s
     2^24 bases plus poly-A reads making ~25% of the k-mers (the poly-A
     key's count is above U = 65535, the most a configuration allows, and is
     dropped), and 2^17 bases with ~25% poly-A k-mers (the poly-A key's
     count passes U and is kept), a bucket flagged and pre-counted on the
     card (never by the host pre-count), each
     result equal to the range route's on the same reads; (d) extension mode on phase 8(c)'s 2^24 bases with read ids
     from EXT_RID0, one-shot on one rank and on two, and streamed in batches
     of 2^22 on two (merged on the card, not by the host merge), each
     against phase 8(c)'s one-shot result; (e)
     count_reads_sharded_streaming in batches of 2^24, one rank and two
     ranks, against phase 2. Each result exactly equal after sorting by key
     (extension mode: every occurrence as sorted (key, rid, pos) rows); per
     rank the wall, the peak device memory, the bytes sent and the kernels'
     launches, both send-side kernels launched in every run
 12  multi-process runs (parallel/multihost.py) through the CLI's
     --coordinator, each process reading its own records of the FASTA and
     writing its share to <rank>.out: (a) two processes sharing the card
     over gloo and (b) one process over NCCL on phase 2's FASTA, (c)
     --routing supermer on two processes (both send-side kernels launched in
     each), each against phase 2; (d)
     --extension --stream-batch-bases 2^24 on two processes on phase 2's
     FASTA against phase 8(a)'s one-shot extension result, its merge
     kernels launched in every process. Each time the
     union of the
     shares equals the reference's lines (so the shares are disjoint) and
     the printed histogram the reference's; per rank its wall, its stage
     times (read shard and its index part, pack, step, merge, result,
     write), its peak device memory and its kernels' launches

Then the copy-out of results to the host (pipeline.to_host): the pinned
footprint of the process after phases 2, 8 and 12 (the ring's, at or under
its cap, and torch's whole pinned pool), and on phase 2's and 8(c)'s
results, per array, the pinned D2H alone by CUDA events, the host copy
into a touched, a fresh torch.empty, a fresh np.empty and a fresh
MAP_POPULATE destination, a pinned allocation on a cache miss and the
port's copy-out, then the whole result in one copy-out, and the port's
copy-out against a ring of smaller pieces and the former copy-out in
turns; the host's transparent huge page modes and thread counts.

Any failure raises (exit code 1); a rank's failure fails its spawn. Without
a CUDA device the script exits 1 before printing any result. The last four
lines of standard output are the copy-out's JSON record, the card's name
and power limit, the per-kernel JSON record and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
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
EXT_STREAM_BASES = 1 << 24  # 8(c)'s second run, and the sharded phases' smaller runs
EXT_STREAM_BATCH = 1 << 22
EXT_RID0 = 1_000_000  # phase 8(c)'s read id offset, phase 10's too
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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's only rate outside the tensor cores (float32); the
# kernels' integer operations are held against it.
OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    read each input once and write each output once, or to do the
    operations, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def packed_int64(words):
    """W <= 2 int32 key words as one int64 per slot whose signed order is
    the words' unsigned lexicographic order (the sign bit flipped)."""
    from hysortk_tpu_torch.ops.kmer import widen

    key = widen(words[0])
    for w in words[1:]:
        key = (key << 32) | widen(w)
    shift = 64 - 32 * len(words)
    return (key << shift) ^ -(1 << 63)


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


def rows_on_card(rows, offset: int = 0):
    """(n,) uint32 numpy rows as int32 tensors on the card; with `offset`
    each is a view that many words into its own buffer (offset 1: no
    16-byte alignment)."""
    import torch

    out = []
    for r in rows:
        r = torch.from_numpy(np.ascontiguousarray(r).view(np.int32))
        buf = torch.empty(r.shape[0] + offset, dtype=torch.int32, device="cuda")
        buf[offset:] = r
        out.append(buf[offset:])
    return out


def require_equal(name: str, err: int) -> None:
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, max |err| {err}")


# --------------------------------------------------------------------------
# Phase 0


def phase0_device():
    import torch

    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.io import native

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("phase0 ptxas:", line.strip())
    t0 = time.perf_counter()
    host_path = native.library_path()
    cxx = _build.find_cxx()
    log(f"phase0 host library build+load {time.perf_counter() - t0:.3f} s -> "
        f"{os.path.relpath(host_path, ROOT)}; compiler {cxx}: "
        f"{_build.compiler_version(cxx)}; flags {' '.join(_build.HOST_FLAGS)}; "
        f"{torch.get_num_threads()} threads (torch.get_num_threads(), "
        f"os.cpu_count() {os.cpu_count()})")
    return smi


# --------------------------------------------------------------------------
# Phase 1


def phase1_synthetic(gen):
    """Kernels against plain versions on synthetic worst cases. Returns the
    largest error seen per kernel."""
    import torch

    from hysortk_tpu_torch.ops import (
        block_sort, fused_count, fused_sort, keybuild, merge, mixkey, radix_sort,
        run_length_sum, wire,
    )

    errs = {name: 0 for name in KERNELS}
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
        # fused sort on the same codes: invalid runs, valid k-mers whose
        # halo crosses a radix tile's edge, and a sentinel tail of 1/8.
        valid = valid.clone()
        valid[1000:5000] = False
        valid[8192 * 3 - 40:8192 * 3 + 8] = True
        valid[-n // 8:] = False
        got = fused_sort.sort_codes_fused(codes, valid, k)
        want = fused_sort.sort_codes_fused_plain(codes, valid, k)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"fused_sort k={k}", e)
        if not bool((got[0][-n // 8:] == -1).all()):
            raise AssertionError("the sentinel tail is not last")
        ms = cuda_ms(lambda: fused_sort.sort_codes_fused(codes, valid, k), 5)
        pms = cuda_ms(lambda: fused_sort.sort_codes_fused_plain(codes, valid, k), 3)
        log(f"phase1 fused_sort k={k} n={n}: equal, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
        errs["fused_sort"] = max(errs["fused_sort"], e)
    del codes, lengths, valid, got, want

    # block sort: full-range words, a pool of duplicates, equal keys across
    # every block's edge, a sentinel tail; with and without payload rows,
    # both orientations, up to the largest block the kernel holds.
    size = 1 << 22
    for w_count, n_pay, block in ((1, 0, 16384), (1, 2, 2048), (2, 0, 16384),
                                  (2, 2, 2048), (4, 0, 2048), (4, 2, 8192)):
        if block > block_sort.max_block(w_count):
            raise AssertionError(f"block {block} exceeds the kernel's largest")
        rows = [
            torch.randint(-2**31, 2**31, (size,), dtype=torch.int32, device=dev,
                          generator=gen)
            for _ in range(w_count)
        ]
        dup = torch.randint(0, size, (size // 4,), device=dev, generator=gen)
        pool = torch.randint(0, 4096, (size // 4,), device=dev, generator=gen)
        for w in rows:
            w[dup] = w[pool]
            w.view(-1, block)[:, :5] = 9
            w.view(-1, block)[:, -5:] = 9
            w[-size // 8:] = -1
        rows += [torch.arange(size, dtype=torch.int32, device=dev) + j
                 for j in range(n_pay)]
        for descending_odd in (True, False):
            got = block_sort.block_bitonic_sort(rows, w_count, block, descending_odd)
            want = block_sort.block_bitonic_sort_plain(rows, w_count, block,
                                                       descending_odd)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            require_equal(f"block_sort W={w_count}+{n_pay} B={block} "
                          f"descending_odd={descending_odd}", e)
            errs["block_sort"] = max(errs["block_sort"], e)
        ms = cuda_ms(lambda: block_sort.block_bitonic_sort(rows, w_count, block), 5)
        pms = cuda_ms(lambda: block_sort.block_bitonic_sort_plain(rows, w_count, block), 3)
        log(f"phase1 block_sort W={w_count}+{n_pay} B={block} n={size}: equal in "
            f"both orientations, kernel {ms:.4f} ms, plain {pms:.4f} ms "
            f"({block_sort_regime(block)})")
        del rows, got, want

    # sort: full-range words (top bit set in half of them), a pool of
    # duplicates, word-0 ties that differ only in the last word, and a
    # sentinel tail.
    # The last size is not a power of two: the sort pads nothing.
    for w_count, size in ((1, 1 << 24), (2, 1 << 24), (4, 1 << 24), (2, 1 << 26),
                          (2, (1 << 26) - 12345)):
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

    phase1_sort_cases(errs)
    phase1_count_block_sort_cases(errs)
    phase1_sum_cases(errs)
    phase1_merge_keybuild_cases(errs)
    phase1_mix_cases(errs)

    # mix: full-range words (half with the top bit set), a sentinel tail of
    # 1/8 that must stay sentinel, at 2^26 x W=2.
    size = 1 << 26
    words = [torch.randint(-2**31, 2**31, (size,), dtype=torch.int32, device=dev,
                           generator=gen) for _ in range(2)]
    for w in words:
        w[-size // 8:] = -1
    got = mixkey.mix_keys(words)
    want = mixkey.mix_keys_plain(words)
    torch.cuda.synchronize()
    e = max_abs_err(got, want)
    require_equal("mix_keys W=2", e)
    if not all(bool((g[-size // 8:] == -1).all()) for g in got):
        raise AssertionError("the mix moved the sentinel")
    ms = cuda_ms(lambda: mixkey.mix_keys(words), 10)
    pms = cuda_ms(lambda: mixkey.mix_keys_plain(words), 3)
    log(f"phase1 mix_keys W=2 n={size}: equal, kernel {ms:.4f} ms, plain {pms:.4f} ms")
    errs["mix_keys"] = max(errs["mix_keys"], e)
    del words, got, want

    # count and weighted sum: sorted keys whose runs include poly-A lengths
    # (10^5, 10^6), runs at exactly L and U, top-bit keys, then a sentinel
    # tail of 1/8.
    size = 1 << 26
    words = synthetic_sorted_words(gen, size, 2)
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
    del got, want

    for w_count in (2, 4):
        if w_count != 2:
            words = synthetic_sorted_words(gen, size, w_count)
        # Weights up to 65535 on every slot, the sentinel tail included
        # (there they must count 0).
        weights = torch.randint(1, 65536, (size,), dtype=torch.int32, device=dev,
                                generator=gen)
        got = run_length_sum.run_length_sum_fused(words, weights)
        want = run_length_sum.run_length_sum_fused_plain(words, weights)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"run_length_sum W={w_count}", e)
        # int32 totals wrap (the 10^6-slot run's does), so the sums agree
        # modulo 2^32.
        valid = int(weights[: size - size // 8].to(torch.int64).sum())
        if (int(got[1].to(torch.int64).sum()) - valid) % 2**32 != 0:
            raise AssertionError("the totals do not add up to the valid weights")
        if int(got[0].sum()) != int(fused_count.run_length_count_filter(
                words, 1, 2**31 - 1)[1].sum()):
            raise AssertionError("heads differ from the count kernel's")
        ms = cuda_ms(lambda: run_length_sum.run_length_sum_fused(words, weights), 10)
        pms = cuda_ms(lambda: run_length_sum.run_length_sum_fused_plain(words, weights), 3)
        log(f"phase1 run_length_sum W={w_count} n={size}: equal, kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
        errs["run_length_sum"] = max(errs["run_length_sum"], e)
        del got, want, weights
    del words

    # merge: runs drawn from one pool of keys (duplicates within and across
    # runs, half with the top bit set), sentinel tails of different lengths,
    # one run all sentinel where there are more than two, one payload row.
    for w_count, n_runs, run_len in ((1, 2, 1 << 24), (2, 4, 1 << 23),
                                     (4, 8, 1 << 22), (2, 8, 1 << 22)):
        rows = synthetic_runs(gen, w_count, n_runs, run_len)
        got = merge.merge_sorted_runs(rows, w_count, run_len)
        want = merge.merge_sorted_runs_plain(rows, w_count, run_len)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"merge_runs W={w_count} S={n_runs} L={run_len}", e)
        ms = cuda_ms(lambda: merge.merge_sorted_runs(rows, w_count, run_len), 5)
        pms = cuda_ms(lambda: merge.merge_sorted_runs_plain(rows, w_count, run_len), 3)
        log(f"phase1 merge_runs W={w_count}+1 S={n_runs} L={run_len} "
            f"({merge_passes(n_runs, run_len)} pass(es)): equal, "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
        errs["merge_runs"] = max(errs["merge_runs"], e)
        del rows, got, want
    return errs


def phase1_sort_cases(errs) -> None:
    """The sorts' hard cases (hysortk_tpu_torch.testing) at the kernels' own
    tile sizes, each kernel exactly equal to its plain version."""
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import fused_sort, radix_sort

    cases = testing.sort_cases(testing.SORT_TILE)
    for name, kind, n, n_words, n_payloads in cases:
        words = rows_on_card(testing.sort_case_words(kind, n, n_words, SEED))
        pays = rows_on_card(testing.sort_case_payloads(n, n_payloads))
        got = radix_sort.sort_words(words, pays)
        want = radix_sort.sort_words_plain(words, pays)
        torch.cuda.synchronize()
        e = max_abs_err(got[0] + got[1], want[0] + want[1])
        require_equal(f"radix_sort case {name}", e)
        if any(g.data_ptr() == w.data_ptr() for g in got[0] for w in words):
            raise AssertionError("the sort returned the caller's own rows")
        errs["radix_sort"] = max(errs["radix_sort"], e)
    log(f"phase1 radix_sort hard cases at tile {testing.SORT_TILE}: "
        f"{len(cases)} equal (keys and arange payloads: the stable order)")
    fused_cases = testing.fused_sort_cases()
    for name, kind, n, k in fused_cases:
        codes, valid = testing.fused_sort_case_codes(kind, n, k, SEED)
        codes, valid = torch.from_numpy(codes).cuda(), torch.from_numpy(valid).cuda()
        got = fused_sort.sort_codes_fused(codes, valid, k)
        want = fused_sort.sort_codes_fused_plain(codes, valid, k)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"fused_sort case {name}", e)
        errs["fused_sort"] = max(errs["fused_sort"], e)
    log(f"phase1 fused_sort hard cases at tiles {testing.FUSED_SORT_TILES[2]} "
        f"(W <= 2) and {testing.FUSED_SORT_TILES[3]}: {len(fused_cases)} equal")


def phase1_merge_keybuild_cases(errs) -> None:
    """The run merge's and the key build's hard cases
    (hysortk_tpu_torch.testing) at the kernels' own tiles and fan-in, on
    aligned rows and on views at odd offsets, each kernel exactly equal to
    its plain version."""
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import keybuild, merge

    cases = testing.merge_cases()
    for name, kind, n_words, n_pay, n_runs, run_len in cases:
        rows_np = testing.merge_case_rows(kind, n_words, n_pay, n_runs, run_len, SEED)
        for offset in (0, 1):
            rows = rows_on_card(rows_np, offset)
            got = merge.merge_sorted_runs(rows, n_words, run_len)
            want = merge.merge_sorted_runs_plain(rows, n_words, run_len)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            require_equal(f"merge_runs case {name} offset {offset}", e)
            errs["merge_runs"] = max(errs["merge_runs"], e)
    passes = sorted({merge_passes(c[4], c[5]) for c in cases})
    log(f"phase1 merge_runs hard cases at tile {testing.MERGE_TILE}, fan-in "
        f"{testing.MERGE_FAN_IN}: {len(cases)} "
        f"equal, aligned and one word off, {passes[0]}-{passes[-1]} passes")
    # By bounds (merge_runs_at), as the sharded receive side calls it: run
    # counts and lengths that are not powers of two.
    shapes = ((3, 123457), (4, 70001), (8, 3001), (9, 2048))
    for n_runs, run_len in shapes:
        rows = rows_on_card(
            testing.merge_case_rows("random", 2, 1, n_runs, run_len, SEED))
        got = merge.merge_runs_at(rows, 2, range(0, (n_runs + 1) * run_len, run_len))
        want = merge.merge_sorted_runs_plain(rows, 2, run_len)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"merge_runs_at S={n_runs} L={run_len}", e)
        errs["merge_runs"] = max(errs["merge_runs"], e)
    log(f"phase1 merge_runs by bounds (merge_runs_at), S x L = "
        f"{', '.join(f'{s} x {l}' for s, l in shapes)}: equal")
    cases = testing.keybuild_cases()
    for name, kind, n, k, offset in cases:
        codes_np, valid_np = testing.keybuild_case_codes(kind, n, k, SEED)
        codes, valid = (
            torch.zeros(n + offset, dtype=torch.from_numpy(a).dtype, device="cuda")
            for a in (codes_np, valid_np))
        codes[offset:] = torch.from_numpy(codes_np).cuda()
        valid[offset:] = torch.from_numpy(valid_np).cuda()
        codes, valid = codes[offset:], valid[offset:]
        got = keybuild.canonical_keys_fused(codes, valid, k)
        want = keybuild.canonical_keys_plain(codes, valid, k)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"keybuild case {name}", e)
        errs["keybuild"] = max(errs["keybuild"], e)
    log(f"phase1 keybuild hard cases at tile {testing.KEYBUILD_TILE}: {len(cases)} "
        f"equal (K = {', '.join(map(str, testing.KEYBUILD_KS))}; codes and flags "
        f"at odd offsets in {sum(c[4] > 0 for c in cases)})")


def phase1_mix_cases(errs) -> None:
    """The key mix's hard cases (hysortk_tpu_torch.testing) at the kernel's
    block, each exactly equal to its plain version and to the numpy mix."""
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import mixkey

    cases = testing.mix_cases()
    for name, kind, n_words, n, offset in cases:
        words = testing.mix_case_words(kind, n_words, n, SEED)
        rows = rows_on_card(words, offset)
        got = mixkey.mix_keys(rows)
        want = mixkey.mix_keys_plain(rows)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        require_equal(f"mix_keys case {name}", e)
        host = np.stack([g.cpu().numpy().view(np.uint32) for g in got])
        if not np.array_equal(host, mixkey.mix_keys_np(words.T.copy()).T):
            raise AssertionError(f"mix_keys case {name}: differs from the numpy mix")
        errs["mix_keys"] = max(errs["mix_keys"], e)
    log(f"phase1 mix_keys hard cases at block {testing.MIX_BLOCK}: {len(cases)} equal "
        f"(W = 1..6, sentinel rows, top-bit and near-sentinel words, rows at odd "
        f"offsets in {sum(c[4] > 0 for c in cases)})")


def merge_passes(n_runs: int, run_len: int) -> int:
    """How many passes merge_sorted_runs makes over n_runs runs."""
    from hysortk_tpu_torch.ops import merge

    return len(merge.merge_plan(np.arange(n_runs + 1) * run_len,
                                merge.TILE, merge.FAN_IN))


def block_sort_regime(block: int) -> str:
    """How csrc/block_sort.cu's one body takes a block of this size."""
    from hysortk_tpu_torch import testing

    chunk = testing.BLOCK_SORT_CHUNK
    if block < chunk:
        return f"{chunk // block} blocks share a thread block's registers"
    if block == chunk:
        return "one block in a thread block's registers"
    return (f"{block // chunk} register chunks, strides of {chunk} and up in "
            f"shared memory")


def phase1_count_block_sort_cases(errs) -> None:
    """The count's and the block sort's hard cases (hysortk_tpu_torch.testing)
    at the kernels' own tile sizes, on aligned rows and on rows that are views
    one word into their buffers, each exactly equal to its plain version."""
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import block_sort, fused_count

    cases = testing.count_cases(testing.COUNT_TILE)
    for name, runs, n_sentinel, n_words, lower, upper in cases:
        words = testing.count_case_words(runs, n_sentinel, n_words, SEED)
        for offset in (0, 1):
            rows = rows_on_card(words, offset)
            got = fused_count.run_length_count_filter(rows, lower, upper)
            want = fused_count.run_length_count_filter_plain(rows, lower, upper)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            require_equal(f"fused_count case {name} offset {offset}", e)
            errs["fused_count"] = max(errs["fused_count"], e)
    log(f"phase1 fused_count hard cases at tile {testing.COUNT_TILE}: {len(cases)} "
        f"equal, on 16-byte aligned rows and on rows one word off")
    cases = testing.block_sort_cases(testing.BLOCK_SORT_CHUNK)
    for name, kind, n_words, n_pay, block, n_blocks in cases:
        rows_np = testing.block_sort_case_rows(kind, n_words, n_pay, block,
                                               n_blocks, SEED)
        for offset in (0, 1):
            rows = rows_on_card(rows_np, offset)
            for descending_odd in (True, False):
                got = block_sort.block_bitonic_sort(rows, n_words, block,
                                                    descending_odd)
                want = block_sort.block_bitonic_sort_plain(rows, n_words, block,
                                                           descending_odd)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                require_equal(f"block_sort case {name} offset {offset} "
                              f"descending_odd={descending_odd}", e)
                errs["block_sort"] = max(errs["block_sort"], e)
    sizes = sorted({c[4] for c in cases})
    log(f"phase1 block_sort hard cases around chunk {testing.BLOCK_SORT_CHUNK}: "
        f"{len(cases)} equal in both orientations, aligned and one word off; "
        f"B = {sizes[0]} .. {sizes[-1]} ({block_sort_regime(sizes[0])} .. "
        f"{block_sort_regime(sizes[-1])})")


def phase1_sum_cases(errs) -> None:
    """The weighted sum's hard cases (hysortk_tpu_torch.testing.sum_cases)
    at the kernel's tile, on aligned rows and on rows that are views one word
    into their buffers, each exactly equal to the plain version."""
    import torch

    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.ops import run_length_sum

    cases = testing.sum_cases(testing.SUM_TILE)
    for name, runs, n_sentinel, n_words, kind in cases:
        rows = list(testing.count_case_words(runs, n_sentinel, n_words, SEED))
        rows.append(testing.sum_case_weights(kind, runs, n_sentinel, SEED))
        for offset in (0, 1):
            t = rows_on_card(rows, offset)
            got = run_length_sum.run_length_sum_fused(t[:-1], t[-1])
            want = run_length_sum.run_length_sum_fused_plain(t[:-1], t[-1])
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            require_equal(f"run_length_sum case {name} offset {offset}", e)
            errs["run_length_sum"] = max(errs["run_length_sum"], e)
    log(f"phase1 run_length_sum hard cases at tile {testing.SUM_TILE}: {len(cases)} "
        f"equal, on 16-byte aligned rows and on rows one word off (walks over 41 "
        f"tiles, int32 totals that wrap across tiles, signed weights)")


def synthetic_sorted_words(gen, size: int, n_words: int):
    """Sorted sentinel-marked keys of n_words int32 words: distinct keys
    (half with the top bit set) in runs of 1..59 slots, some of exactly
    LOWER and UPPER, one of 10^5 and one of 10^6 slots, then an all-ones
    tail of size/8 slots. Words past the second repeat the run's key bits,
    so the order is set by the first two."""
    import torch

    from hysortk_tpu_torch.ops.kmer import narrow

    dev = "cuda"
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
    # The body's last run takes up the slack, so the tail is exactly size/8.
    runs[-1] += size - tail - int(runs.sum())
    keys = keys ^ -(1 << 63)  # flip the sign bit: signed order -> unsigned order
    body = torch.repeat_interleave(keys, runs)
    full = torch.full((tail,), -1, dtype=torch.int64, device=dev)
    flat = torch.cat([body, full])
    words = [narrow(flat >> 32), narrow(flat)]
    for j in range(2, n_words):
        words.append(narrow(flat >> (7 * j)))
    return words


def synthetic_runs(gen, n_words: int, n_runs: int, run_len: int):
    """n_runs sorted runs of run_len slots, concatenated: n_words key rows
    and one payload row (int32 each)."""
    import torch

    from hysortk_tpu_torch.ops import radix_sort

    dev = "cuda"
    pool = [
        torch.randint(-2**31, 2**31, (run_len // 2,), dtype=torch.int32, device=dev,
                      generator=gen)
        for _ in range(n_words)
    ]
    parts = []
    for r in range(n_runs):
        filled = run_len - r * run_len // (2 * n_runs)
        if n_runs > 2 and r == n_runs - 1:
            filled = 0
        pick = torch.randint(0, run_len // 2, (filled,), device=dev, generator=gen)
        payload = torch.randint(1, 65536, (filled,), dtype=torch.int32, device=dev,
                                generator=gen)
        words, (payload,) = radix_sort.sort_words_plain(
            [w[pick] for w in pool], [payload]
        )
        pad = torch.full((run_len - filled,), -1, dtype=torch.int32, device=dev)
        parts.append([torch.cat([w, pad]) for w in words]
                     + [torch.cat([payload, torch.zeros_like(pad)])])
    return [torch.cat([p[q] for p in parts]) for q in range(n_words + 1)]


def phase1_main_path(codes_np, lengths_np, errs):
    """Each kernel of the one-shot path against its plain version on the
    very inputs the main path gives it in phase 2 (same padding, same
    decode). Returns each kernel's measurements."""
    import torch

    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import (
        block_sort, fused_count, fused_sort, keybuild, mixkey, radix_sort,
    )

    codes, valid = pipeline.device_batch(codes_np, lengths_np, slice_config(), "cuda")
    n = codes.shape[0]
    marked = keybuild.canonical_keys_fused(codes, valid, K)
    w = len(marked)
    e = max_abs_err(marked, keybuild.canonical_keys_plain(codes, valid, K))
    require_equal("keybuild main path", e)
    errs["keybuild"] = max(errs["keybuild"], e)
    # In: codes int8 + valid bool; out: W words. Two shift-ors per base for
    # the key and as many for its reverse complement, a compare and select
    # and a sentinel select per word.
    kb_bound = bound((2 + 4 * w) * n, (4 * K + 3 * w) * n)
    kb = dict(
        ms=cuda_ms(lambda: keybuild.canonical_keys_fused(codes, valid, K), 10),
        plain_ms=cuda_ms(lambda: keybuild.canonical_keys_plain(codes, valid, K), 3),
        bound_ms=kb_bound[0], bound_by=kb_bound[1], library_ms=None,
    )

    # The sharded path's mix, on the same key words (phase 9 mixes these).
    mixed = mixkey.mix_keys(marked)
    e = max_abs_err(mixed, mixkey.mix_keys_plain(marked))
    require_equal("mix_keys main path", e)
    errs["mix_keys"] = max(errs["mix_keys"], e)
    del mixed
    # In and out: W words each. Per word and round one fmix32 (three
    # xor-shifts, two multiplies) and two adds; one XOR per word at the end.
    mx_bound = bound(8 * w * n, (2 * 10 + 1) * w * n)
    mx = dict(
        ms=cuda_ms(lambda: mixkey.mix_keys(marked), 10),
        plain_ms=cuda_ms(lambda: mixkey.mix_keys_plain(marked), 3),
        bound_ms=mx_bound[0], bound_by=mx_bound[1], library_ms=None,
    )

    sorted_words, _ = radix_sort.sort_words(marked)
    e = max_abs_err(sorted_words, radix_sort.sort_words_plain(marked)[0])
    require_equal("radix_sort main path", e)
    errs["radix_sort"] = max(errs["radix_sort"], e)
    # In and out: W words each. A comparison sort needs about log2(n!)
    # key compares of up to W word compares.
    rs_bound = bound(8 * w * n, w * n * np.log2(max(n, 2)))
    rs = dict(
        ms=cuda_ms(lambda: radix_sort.sort_words(marked), 5),
        plain_ms=cuda_ms(lambda: radix_sort.sort_words_plain(marked), 3),
        bound_ms=rs_bound[0], bound_by=rs_bound[1], library_ms=None,
    )
    if w <= 2:
        # One torch.sort on the key packed into a sign-flipped int64 (the
        # packing is not timed). Beyond two words no one call sorts the key.
        packed = packed_int64(marked)
        lib_sorted = torch.sort(packed).values
        if not torch.equal(lib_sorted, packed_int64(sorted_words)):
            raise AssertionError("torch.sort of the packed key differs")
        rs["library_ms"] = cuda_ms(lambda: torch.sort(packed), 5)
        del packed, lib_sorted

    # Path A: the key build fused into the sort, on the codes themselves.
    got = fused_sort.sort_codes_fused(codes, valid, K)
    e = max(max_abs_err(got, sorted_words),
            max_abs_err(got, fused_sort.sort_codes_fused_plain(codes, valid, K)))
    require_equal("fused_sort main path", e)
    errs["fused_sort"] = max(errs["fused_sort"], e)
    del got
    # In: codes int8 + valid bool; out: W sorted words. The key build's
    # operations plus the sort's compares.
    fs_bound = bound((2 + 4 * w) * n,
                     (4 * K + 3 * w) * n + w * n * np.log2(max(n, 2)))
    fs = dict(
        ms=cuda_ms(lambda: fused_sort.sort_codes_fused(codes, valid, K), 5),
        plain_ms=cuda_ms(lambda: fused_sort.sort_codes_fused_plain(codes, valid, K), 3),
        bound_ms=fs_bound[0], bound_by=fs_bound[1], library_ms=None,
    )
    # The unfused pair on the same inputs, in turns with the fused kernel.
    pair = lambda: radix_sort.sort_words(keybuild.canonical_keys_fused(codes, valid, K))
    fused = lambda: fused_sort.sort_codes_fused(codes, valid, K)
    turns = [cuda_ms(f, 5) for f in (pair, fused, fused, pair)]
    log(f"phase1 fused_sort main-path n={n} K={K}: unfused pair {turns[0]:.4f} / "
        f"{turns[3]:.4f} ms, fused {turns[1]:.4f} / {turns[2]:.4f} ms")

    # Path B: the block sort as sort_words(formulation="roll") calls it (the
    # key rows padded to B * 2^m, ascending blocks), here without a pad.
    block = block_sort.DEFAULT_BLOCK
    if n % block:
        raise AssertionError(f"{n} slots are not whole blocks of {block}")
    got = block_sort.block_bitonic_sort(marked, w, block, descending_odd=False)
    e = max_abs_err(got, block_sort.block_bitonic_sort_plain(marked, w, block, False))
    require_equal("block_sort main path", e)
    errs["block_sort"] = max(errs["block_sort"], e)
    # In and out: W words each. A comparison sort of B slots per block.
    bs_bound = bound(8 * w * n, w * n * np.log2(block))
    bs = dict(
        ms=cuda_ms(lambda: block_sort.block_bitonic_sort(marked, w, block, False), 5),
        plain_ms=cuda_ms(
            lambda: block_sort.block_bitonic_sort_plain(marked, w, block, False), 3),
        bound_ms=bs_bound[0], bound_by=bs_bound[1], library_ms=None,
    )
    if w <= 2:
        # One torch.sort along the blocks of the packed key.
        packed = packed_int64(marked).view(-1, block)
        lib_sorted = torch.sort(packed, dim=1).values
        if not torch.equal(lib_sorted.view(-1), packed_int64(got)):
            raise AssertionError("torch.sort of the packed blocks differs")
        bs["library_ms"] = cuda_ms(lambda: torch.sort(packed, dim=1), 5)
        del packed, lib_sorted
    del got

    got = fused_count.run_length_count_filter(sorted_words, LOWER, UPPER)
    e = max_abs_err(
        got, fused_count.run_length_count_filter_plain(sorted_words, LOWER, UPPER)
    )
    require_equal("fused_count main path", e)
    errs["fused_count"] = max(errs["fused_count"], e)
    # In: W words; out: cnt int32 + keep bool. A boundary and a sentinel
    # compare per word, a subtraction and two bound compares.
    fc_bound = bound((4 * w + 5) * n, (2 * w + 3) * n)
    fc = dict(
        ms=cuda_ms(lambda: fused_count.run_length_count_filter(
            sorted_words, LOWER, UPPER), 10),
        plain_ms=cuda_ms(lambda: fused_count.run_length_count_filter_plain(
            sorted_words, LOWER, UPPER), 3),
        bound_ms=fc_bound[0], bound_by=fc_bound[1], library_ms=None,
    )
    if w <= 2:
        # torch.unique_consecutive gives the run lengths, in another layout
        # (one entry per run, not per slot), without the filter.
        packed = packed_int64(sorted_words)
        _, lengths = torch.unique_consecutive(packed, return_counts=True)
        if int(lengths.sum()) != n:
            raise AssertionError("unique_consecutive lost slots")
        fc["library_ms"] = cuda_ms(
            lambda: torch.unique_consecutive(packed, return_counts=True), 5)
        del packed, lengths

    # The look-back's worst inputs beside the main path's, in turns: one run
    # over every slot (every tile but the first has no boundary and walks),
    # and runs of 10^5 and 10^6 slots among short ones.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    one_run = [torch.full((n,), 7, dtype=torch.int32, device="cuda")
               for _ in range(w)]
    long_runs = synthetic_sorted_words(gen, n, w)
    for what, words in (("one run", one_run), ("long runs", long_runs)):
        e = max_abs_err(
            fused_count.run_length_count_filter(words, LOWER, UPPER),
            fused_count.run_length_count_filter_plain(words, LOWER, UPPER))
        require_equal(f"fused_count {what}", e)
        errs["fused_count"] = max(errs["fused_count"], e)
    count = lambda words: (lambda: fused_count.run_length_count_filter(
        words, LOWER, UPPER))
    turns = [cuda_ms(count(words), 10) for words in
             (sorted_words, one_run, long_runs, long_runs, one_run, sorted_words)]
    log(f"phase1 fused_count look-back n={n}: main-path input {turns[0]:.4f} / "
        f"{turns[5]:.4f} ms, one run over every slot {turns[1]:.4f} / "
        f"{turns[4]:.4f} ms, runs of 10^5 and 10^6 slots {turns[2]:.4f} / "
        f"{turns[3]:.4f} ms")
    del one_run, long_runs

    times = {"keybuild": kb, "radix_sort": rs, "fused_count": fc,
             "fused_sort": fs, "block_sort": bs, "mix_keys": mx}
    for name, t in times.items():
        log_kernel(f"phase1 {name} main-path n={n} K={K}", t)
    return times


def log_kernel(what: str, t: dict) -> None:
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    log(f"{what}: equal, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library call {lib}")


def phase1_streaming_path(merge_inputs, sum_inputs, errs, what: str):
    """The two streaming kernels against their plain versions on the very
    inputs a run's final merge gave them. Returns their measurements."""
    import torch

    from hysortk_tpu_torch.ops import merge, run_length_sum

    rows, n_words, run_len = merge_inputs
    n = rows[0].shape[0]
    n_runs = n // run_len
    got = merge.merge_sorted_runs(rows, n_words, run_len)
    e = max_abs_err(got, merge.merge_sorted_runs_plain(rows, n_words, run_len))
    require_equal(f"merge_runs {what}", e)
    errs["merge_runs"] = max(errs["merge_runs"], e)
    # In and out: every row once. Each output takes log2(runs) key compares
    # of up to W word compares.
    mr_bound = bound(8 * len(rows) * n, n_words * n * np.log2(n_runs))
    mr = dict(
        ms=cuda_ms(lambda: merge.merge_sorted_runs(rows, n_words, run_len), 10),
        plain_ms=cuda_ms(
            lambda: merge.merge_sorted_runs_plain(rows, n_words, run_len), 3),
        bound_ms=mr_bound[0], bound_by=mr_bound[1], library_ms=None,
    )
    if n_words <= 2:
        # A stable merge of runs is a stable sort of their concatenation: one
        # torch.sort(stable=True) of the packed key, then the payload rows
        # gathered by its order (the packing is not timed).
        packed = packed_int64(rows[:n_words])

        def library():
            order = torch.sort(packed, stable=True).indices
            return [r.index_select(0, order) for r in rows[n_words:]]

        if not all(torch.equal(a, b) for a, b in zip(library(), got[n_words:])):
            raise AssertionError("the stable torch.sort's payload rows differ")
        mr["library_ms"] = cuda_ms(library, 5)
        del packed
    del got

    words, weights = sum_inputs
    w = len(words)
    got = run_length_sum.run_length_sum_fused(words, weights)
    e = max_abs_err(got, run_length_sum.run_length_sum_fused_plain(words, weights))
    require_equal(f"run_length_sum {what}", e)
    errs["run_length_sum"] = max(errs["run_length_sum"], e)
    # In: W words + weights; out: total int32 + head bool. A boundary and a
    # sentinel compare per word, a select and an add.
    rl_bound = bound((4 * w + 4 + 5) * n, (2 * w + 2) * n)
    rl = dict(
        ms=cuda_ms(lambda: run_length_sum.run_length_sum_fused(words, weights), 10),
        plain_ms=cuda_ms(
            lambda: run_length_sum.run_length_sum_fused_plain(words, weights), 3),
        bound_ms=rl_bound[0], bound_by=rl_bound[1], library_ms=None,
    )
    log_kernel(f"phase1 merge_runs {what} W={n_words}+{len(rows) - n_words} "
               f"S={n_runs} L={run_len} ({merge_passes(n_runs, run_len)} "
               f"pass(es), library call: torch.sort(stable=True) + gather)", mr)
    log_kernel(f"phase1 run_length_sum {what} W={w} n={n}", rl)
    return {"merge_runs": mr, "run_length_sum": rl}


KERNELS = {
    "keybuild": ("hysortk_tpu_torch/csrc/keybuild.cu",
                 "hysortk_tpu/ops/keybuild.py:173"),
    # With the merge levels of hysortk_tpu/ops/pallas_sort.py:392.
    "radix_sort": ("hysortk_tpu_torch/csrc/radix_sort.cu",
                   "hysortk_tpu/ops/pallas_msort.py:396"),
    # With the look-back of csrc/lookback.cuh.
    "fused_count": ("hysortk_tpu_torch/csrc/fused_count.cu",
                    "hysortk_tpu/ops/pallas_count.py:180"),
    "run_length_sum": ("hysortk_tpu_torch/csrc/run_length_sum.cu",
                       "hysortk_tpu/ops/pallas_count.py:342"),
    # merge_levels entered at 2 * run_len (pallas_sort.py:392), with the
    # member tail of hysortk_tpu/ops/pallas_msort.py:522 (call :414).
    "merge_runs": ("hysortk_tpu_torch/csrc/merge_runs.cu",
                   "hysortk_tpu/ops/pallas_sort.py:589"),
    # pallas_msort.block_sort_keybuild, driven by pallas_sort.sort_codes_fused
    # (pallas_sort.py:535).
    "fused_sort": ("hysortk_tpu_torch/csrc/fused_sort.cu",
                   "hysortk_tpu/ops/pallas_msort.py:355"),
    "block_sort": ("hysortk_tpu_torch/csrc/block_sort.cu",
                   "hysortk_tpu/ops/pallas_sort.py:179"),
    # The JAX package mixes in XLA: a kernel the port added for the sharded
    # path, not the port of a Pallas kernel.
    "mix_keys": ("hysortk_tpu_torch/csrc/mixkey.cu",
                 "hysortk_tpu/ops/mixkey.py:128 (XLA, no pallas_call)"),
    # The supermer route's send side, which the JAX package runs in host
    # numpy: kernels the port added for the route, not ports of Pallas
    # kernels.
    "supermer_runs": ("hysortk_tpu_torch/csrc/supermer_runs.cu",
                      "hysortk_tpu/io/supermer.py:50 run_boundaries (host numpy, "
                      "no pallas_call)"),
    "supermer_pack": ("hysortk_tpu_torch/csrc/supermer_pack.cu",
                      "hysortk_tpu/io/supermer.py:124, :271 + "
                      "parallel/supermer_route.py:219, :641 (host numpy, no "
                      "pallas_call)"),
}
# Which path's run gives each kernel its launch count in the record:
# phase 2, phase 4(a), and for fused_sort phase 6, for block_sort phase 7,
# for mix_keys phase 9(a), for the supermer kernels 11(a)'s first call.
ONE_SHOT_KERNELS = ("keybuild", "radix_sort", "fused_count")
STREAMING_KERNELS = ("run_length_sum", "merge_runs")
SUPERMER_KERNELS = ("supermer_runs", "supermer_pack")


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


def ext_stream_reads(codes, lengths):
    """The first EXT_STREAM_BASES bases of the reads (whole reads): phase
    8(c)'s input, and phase 9(c)'s and 10's smaller runs'."""
    n_reads = EXT_STREAM_BASES // READ_LEN
    return codes[: n_reads * READ_LEN], lengths[:n_reads]


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
    kl = pipeline.compact_keys(words, cnt, pipeline.kept_slots(keep), cfg.k, cfg.upper)
    return kl, pipeline.host_histogram(kl.counts, cfg.upper)


def phase2_slice(workdir: str, rng):
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build, pipeline
    from hysortk_tpu_torch.io import native

    fasta = os.path.join(workdir, "reads.fa")
    t0 = time.perf_counter()
    write_reads_fasta(fasta, rng)
    log(f"phase2 wrote {N_READS} reads x {READ_LEN} bases "
        f"({os.path.getsize(fasta)} B FASTA) in {time.perf_counter() - t0:.3f} s")

    native.reset_calls()
    t0 = time.perf_counter()
    codes, lengths = ht.read_dna_buffer(fasta)
    log(f"phase2 read_dna_buffer {int(codes.size)} bases, {lengths.size} reads "
        f"in {time.perf_counter() - t0:.3f} s (the .fai built and written)")
    phase2_read_stages(fasta, codes, lengths)
    cfg = slice_config()
    n_kmers = int(np.maximum(lengths - K + 1, 0).sum())

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    pipeline.reset_calls()
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
    for name in ONE_SHOT_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if pipeline.calls["device_histogram"] != 4:
        raise AssertionError(f"{pipeline.calls['device_histogram']} device histograms "
                             f"in four calls: the histogram did not come from the device")
    log("phase2 histogram check: each of the four calls computed its histogram on the "
        "device (pipeline.device_histogram)")
    peak = torch.cuda.max_memory_allocated()
    best = min(walls)
    log(f"phase2 kmer_count first call {first_s:.4f} s; steady "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; best {best:.4f} s = "
        f"{n_kmers / best:.1f} k-mers/s ({n_kmers} k-mers)")

    phase2_stages(codes, lengths, cfg, best)

    text = ht.print_kmer_histogram(hist)
    out_path = ht.write_output_file(kl, os.path.join(workdir, "out"))
    with open(out_path, "rb") as f:
        lines = f.read().count(b"\n")
    if lines != len(kl):
        raise AssertionError(f"{out_path} has {lines} lines, list has {len(kl)}")
    # The host stages went through the port's own library.
    host_calls = dict(native.calls)
    host_lib = os.path.relpath(native.library_path(), ROOT)
    log(f"phase2 host route: the port's library {host_lib}, calls {json.dumps(host_calls)}")
    unused = [name for name in ("fai_build", "strip_and_pack", "pack_2bit", "format_output")
              if host_calls[name] == 0]
    if unused or not host_lib.startswith(os.path.join("build", "host") + os.sep):
        raise AssertionError(f"phase 2 did not run the port's host library ({host_lib}): "
                             f"no call of {unused}")

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
        f"peak device memory {peak / 2**30:.3f} GiB")
    return codes, lengths, launches, (kl, hist), peak, best


def phase2_read_stages(fasta: str, codes, lengths) -> None:
    """read_dna_buffer stage by stage (.fai build and write, .fai parse,
    partition, read_records), then once more on the written .fai (the
    parse route), each equal to the first read."""
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.io import fasta as fasta_io

    t = {}
    t0 = time.perf_counter()
    built = fasta_io.generate_fai(fasta, fasta + ".fai")
    t[".fai build + write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = fasta_io.parse_fai(fasta + ".fai")
    t[".fai parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bounds = fasta_io.partition_bounds(index, 1)
    t["partition (1 shard)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bounds4 = fasta_io.partition_bounds(index, 4)
    t["partition (4 shards)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = fasta_io.read_records(fasta, index[bounds[0]:bounds[1]])
    t["read_records"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = ht.read_dna_buffer(fasta)
    t["read_dna_buffer on the .fai"] = time.perf_counter() - t0
    cols = ("length", "offset", "linebases", "linewidth")
    if not (all(np.array_equal(getattr(built, c), getattr(index, c)) for c in cols)
            and built.names_blob == index.names_blob and len(index) == lengths.size):
        raise AssertionError("the parsed .fai differs from the built one")
    if int(np.diff(bounds4).min()) <= 0 or bounds4[-1] != lengths.size:
        raise AssertionError(f"4-shard partition {bounds4.tolist()} is not a tiling")
    for c, ln in (got, again):
        if not (np.array_equal(c, codes) and np.array_equal(ln, lengths)):
            raise AssertionError("a staged read differs from read_dna_buffer's")
    log(f"phase2 read_dna_buffer stages ({len(index)} records, "
        f"{os.path.getsize(fasta)} B of FASTA), s: "
        + "; ".join(f"{name} {sec:.4f}" for name, sec in t.items()))


def plain_fai(data):
    """native.fai_build's result by its plain version: the columns and name
    bounds of fasta.fai_columns_plain, the text of FaiIndex.to_bytes."""
    from hysortk_tpu_torch.io import fasta as fasta_io

    cols, lo, hi = fasta_io.fai_columns_plain(data)
    offsets = np.concatenate([[0], np.cumsum(hi - lo)])
    names = data[fasta_io.segment_positions(lo, hi - lo)].tobytes()
    text = fasta_io.FaiIndex(names, offsets, *cols).to_bytes()
    return cols, lo, hi, np.frombuffer(text, dtype=np.uint8)


def phase2_host_functions(workdir: str, codes, lengths, one_shot) -> None:
    """Each function of the port's host library against its numpy plain
    version on phase 2's reads and result, exactly equal, with both times
    (host clock: the library's mean of three calls after one, the plain
    version's one call)."""
    import torch

    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.io import native, supermer, writer
    from hysortk_tpu_torch.ops import kmer
    from hysortk_tpu_torch.parallel import pipeline as sharded
    from hysortk_tpu_torch.parallel import supermer_route as sr

    cfg = slice_config()
    kl, _ = one_shot
    fasta = os.path.join(workdir, "reads.fa")
    with open(fasta, "rb") as f:
        fasta_bytes = np.frombuffer(f.read(), dtype=np.uint8)
    raw_args = fasta_io.read_record_bytes(fasta, fasta_io.load_or_build_fai(fasta))
    n = -(-(int(codes.size) + 16) // cfg.pad_multiple) * cfg.pad_multiple
    buf = np.zeros(n, dtype=np.uint8)
    buf[: codes.size] = codes
    flat, valid = fasta_io.flatten_for_device(codes, lengths, K, cfg.pad_multiple)
    # Destinations as a four-rank supermer route gives them: minimizer
    # buckets, dealt to the ranks in turn.
    dest = (sr.host_destinations(flat, K, M, sharded._num_buckets(cfg, 4), "cuda")
            % 4).astype(np.int32)
    max_kmers = supermer.MAX_SUPERMER_LEN - K + 1
    starts, kmers_, _ = native.run_boundaries(valid, dest, max_kmers)
    bases = kmers_ + K - 1
    out_off = np.zeros(bases.size, np.int64)
    np.cumsum(bases[:-1], out=out_off[1:])
    total = int(bases.sum())
    counts32 = kl.counts.astype(np.int32)
    cases = (
        ("fai_build", f"{int(fasta_bytes.size)} B of FASTA, {lengths.size} records",
         lambda: native.fai_build(fasta_bytes), lambda: plain_fai(fasta_bytes)),
        ("strip_and_pack", f"{int(raw_args[0].size)} B of FASTA, {lengths.size} records",
         lambda: native.strip_and_pack(*raw_args),
         lambda: fasta_io.strip_and_pack_plain(*raw_args)),
        ("pack_2bit", f"{n} codes", lambda: native.pack_2bit(buf),
         lambda: supermer.pack_codes_2bit_plain(buf)),
        ("decode_keys", f"{len(kl)} keys", lambda: native.decode_keys(kl.keys, K),
         lambda: kmer.decode_keys_plain(kl.keys, K)),
        ("format_output", f"{len(kl)} rows",
         lambda: native.format_output(kl.keys, counts32, K),
         lambda: writer.format_output_plain(kl.keys, counts32, K)),
        ("run_boundaries", f"{int(valid.size)} positions, {starts.size} runs",
         lambda: native.run_boundaries(valid, dest, max_kmers),
         lambda: supermer.run_boundaries_plain(valid, dest, max_kmers)),
        ("gather_runs", f"{starts.size} runs, {total} bases",
         lambda: native.gather_runs(flat, starts, bases, out_off, total),
         lambda: supermer.gather_runs_plain(flat, starts, bases, out_off, total)),
    )
    for name, what, fn, plain in cases:
        got = fn()
        t0 = time.perf_counter()
        for _ in range(3):
            got = fn()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        want = plain()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(got, bytes):
            same = got == want
        else:
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            same = all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in pairs)
        if not same:
            raise AssertionError(f"host library {name} differs from its plain version")
        log(f"phase2 host {name} ({what}): library {ms:.1f} ms on "
            f"{torch.get_num_threads()} threads, plain {plain_ms:.1f} ms, equal")
        del got, want


@contextlib.contextmanager
def copy_out_clock():
    """Yields a list that collects the host ms of every pipeline.to_host
    call (the copy-out) made inside the block."""
    from hysortk_tpu_torch import pipeline

    real, spent = pipeline.to_host, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spent.append((time.perf_counter() - t0) * 1e3)

    pipeline.to_host = timed
    try:
        yield spent
    finally:
        pipeline.to_host = real


def phase2_stages(codes, lengths, cfg, best_wall: float) -> None:
    """The one-shot call stage by stage, a synchronize after each: each
    stage's host wall and, where it only queues device work, its device
    time by CUDA events (not for the compaction, whose events would span
    its host copy out of the bounce buffer). The device-busy share of the
    call: those events' sum over the best wall of the one-shot call, and
    the device's kernels and copies in a torch.profiler trace of one call
    over that call's wall. Checks that the feed's staging is pinned and
    that the histogram is the device's."""
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import fused_count, keybuild, radix_sort, wire

    stages = []
    device_ms = []

    def timed(name, fn, on_device=True):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if on_device:
            device_ms.append(start.elapsed_time(end))
            stages.append(f"{name} {wall:.1f} (device {device_ms[-1]:.1f})")
        else:
            stages.append(f"{name} {wall:.1f}")
        return out

    dev = torch.device("cuda")
    n = -(-(int(codes.size) + 16) // cfg.pad_multiple) * cfg.pad_multiple
    for _ in range(2):
        stages.clear()
        device_ms.clear()
        staged = timed("pack into pinned", lambda: pipeline.stage_wire(
            codes, lengths, n, dev), on_device=False)
        if not all(t.is_pinned() for t in staged):
            raise AssertionError("the feed's staging is not pinned")
        packed, lens = timed("H2D", lambda: tuple(
            t.to(dev, non_blocking=True) for t in staged))
        del staged
        codes_d, valid_d = timed("decode", lambda: wire.decode_block(packed, lens, cfg.k, n))
        del packed, lens
        marked = timed("keybuild", lambda: keybuild.canonical_keys_fused(
            codes_d, valid_d, cfg.k))
        words = timed("radix sort", lambda: radix_sort.sort_words(marked)[0])
        cnt, keep = timed("fused count", lambda: fused_count.run_length_count_filter(
            words, cfg.lower, cfg.upper))

        def compaction():
            idx = pipeline.kept_slots(keep)
            with copy_out_clock() as copy_ms:
                kl = pipeline.compact_keys(words, cnt, idx, cfg.k, cfg.upper)
            return kl, idx, copy_ms

        kl, idx, copy_ms = timed("compaction + D2H", compaction, on_device=False)
        stages[-1] += f" (copy-out {sum(copy_ms):.1f})"
        before = pipeline.calls["device_histogram"]
        hist = timed("device histogram", lambda: pipeline.device_histogram(
            cnt, idx, cfg.upper))
        if pipeline.calls["device_histogram"] != before + 1 or not np.array_equal(
                hist, pipeline.host_histogram(kl.counts, cfg.upper)):
            raise AssertionError("the device histogram differs from host_histogram")
        del codes_d, valid_d, marked, words, cnt, keep, idx, kl
    busy = sum(device_ms)
    log(f"phase2 stages of the one-shot call, second of two, ms: {'; '.join(stages)}")
    log(f"phase2 feed staged in pinned memory (is_pinned), histogram from "
        f"device_histogram equal to host_histogram")
    traced_busy, traced_wall = profile_call(lambda: ht.kmer_count(
        codes, lengths, cfg, device="cuda"), "phase2 one-shot")
    log(f"phase2 device-busy share of the one-shot call: CUDA events of the stages "
        f"but the compaction {busy:.1f} ms over the best wall {best_wall * 1e3:.1f} ms = "
        f"{100 * busy / (best_wall * 1e3):.1f}%; torch.profiler {traced_busy:.1f} ms "
        f"busy over {traced_wall:.1f} ms = {100 * traced_busy / traced_wall:.1f}% "
        f"(idle {100 * (1 - traced_busy / traced_wall):.1f}%)")


# --------------------------------------------------------------------------
# Phase 3


def phase3_small(workdir: str, rng):
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
    return path, reads


# --------------------------------------------------------------------------
# Phase 4


class Recorder:
    """Wraps a function of a module for one run and counts its calls. With
    `keep_args_within` it also keeps the arguments of its last call made
    inside a call of one of those recorders (and of no other call, so that
    it holds no tensor alive that the run itself would have let go)."""

    def __init__(self, module, name: str, keep_args_within=()):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep_args_within = keep_args_within
        self.calls = 0
        self.active = 0
        self.last_args = None

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if any(outer.active for outer in self.keep_args_within):
            self.last_args = args
        self.active += 1
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.active -= 1

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase4_streaming(codes, lengths, one_shot, one_shot_peak, errs):
    """Both streaming configurations on phase 2's reads, each equal to the
    one-shot result. Returns the launch counts of run (a) and the two
    streaming kernels' measurements on its final merge's inputs."""
    import dataclasses

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.ops import merge, run_length_sum
    from hysortk_tpu_torch.runtime import scheduler

    runs = (
        ("a", slice_config(), 1 << 24),
        ("b", dataclasses.replace(slice_config(), device_compact=True), 1 << 22),
    )
    def stream(cfg, batch_bases, keep_args):
        """One streaming call under call counters of the scheduler's
        passes. With keep_args the two kernels' wrappers are wrapped too and
        the final merge's inputs are kept; a wrapper's frame holds its
        arguments, which keeps the merge from releasing its first pass's
        input, so the peak is read from a run without."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        cycles = Recorder(scheduler, "_consolidate_device_runs")
        resident = Recorder(scheduler, "_merge_device_resident")
        host_merge = Recorder(scheduler, "merge_partial_lists")
        recorders = [cycles, resident, host_merge]
        if keep_args:
            within = (resident, host_merge)
            merges = Recorder(merge, "merge_sorted_runs", within)
            sums = Recorder(run_length_sum, "run_length_sum_fused", within)
            recorders += [merges, sums]
        with contextlib.ExitStack() as stack:
            for recorder in recorders:
                stack.enter_context(recorder)
            t0 = time.perf_counter()
            kl, hist = ht.count_reads_streaming(
                codes, lengths, cfg, batch_bases, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        want, want_hist = one_shot
        if not (np.array_equal(kl.keys, want.keys)
                and np.array_equal(kl.counts, want.counts)
                and np.array_equal(hist, want_hist)):
            raise AssertionError("a streaming run differs from the one-shot result")
        return dict(
            kept=len(kl), wall=wall, peak=torch.cuda.max_memory_allocated(),
            launches=dict(_build.launches), cycles=cycles.calls,
            resident=resident.calls, host_merge=host_merge.calls,
            merge_args=merges.last_args if keep_args else None,
            sum_args=sums.last_args if keep_args else None,
        )

    out = {}
    for tag, cfg, batch_bases in runs:
        r = stream(cfg, batch_bases, keep_args=False)
        launches, peak = r["launches"], r["peak"]
        batches = len(scheduler.read_batch_spans(
            lengths, scheduler.snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple)))
        log(f"phase4{tag} device_compact={cfg.device_compact} batch_bases={batch_bases}: "
            f"{batches} batches, {r['cycles']} consolidation cycles, "
            f"{r['resident']} device-resident merges, {r['host_merge']} host-list "
            f"merges, wall {r['wall']:.4f} s, peak device memory {peak / 2**30:.3f} GiB, "
            f"launches {json.dumps(launches)}")
        for name in ONE_SHOT_KERNELS + STREAMING_KERNELS:
            if launches[name] == 0:
                raise AssertionError(
                    f"kernel {name} was not launched by streaming run ({tag})")
        if tag == "a" and not (r["host_merge"] == 1 and r["resident"] == 0):
            raise AssertionError("run (a) did not merge host-held partial lists")
        if tag == "b":
            if not (r["cycles"] >= 1 and r["resident"] == 1 and r["host_merge"] == 0):
                raise AssertionError(
                    "run (b) did not stay device-resident through a "
                    "consolidation cycle and the final device merge")
            if peak >= one_shot_peak:
                raise AssertionError(
                    f"run (b) peaked at {peak} B, one-shot at {one_shot_peak} B")
        log(f"phase4{tag} {r['kept']} k-mers, equal to phase 2's one-shot result")
        r = stream(cfg, batch_bases, keep_args=True)
        rows, n_words, run_len = r["merge_args"]
        times = phase1_streaming_path(
            (list(rows), n_words, run_len),
            (list(r["sum_args"][0]), r["sum_args"][1]),
            errs, f"final merge of 4({tag})",
        )
        out[tag] = (launches, times)
        del r, rows
        profile_call(lambda: ht.count_reads_streaming(
            codes, lengths, cfg, batch_bases, device="cuda"), f"phase4{tag}")
    return out["a"]


class MemoryCapWithin(Recorder):
    """A Recorder whose calls run under a per-process memory fraction that
    leaves `margin` bytes above what the allocator holds at the call's entry
    (its cache emptied first), so that a call which needs more raises
    torch.cuda.OutOfMemoryError from the allocator; the fraction is back to
    the whole card when the call returns or raises."""

    def __init__(self, module, name: str, margin: int):
        super().__init__(module, name)
        self.margin = margin
        self.caps = []

    def __call__(self, *args, **kwargs):
        import torch

        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        cap = torch.cuda.memory_reserved() + self.margin
        self.caps.append(cap)
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            return super().__call__(*args, **kwargs)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)


def phase4_drains(codes, lengths, one_shot) -> None:
    """The streaming scheduler's out-of-memory drains on the card:
    phase 2's reads under device_compact with HYSORTK_DEVICE_RESIDENT_GROUP=8,
    (c) in 17 batches of 2^22, where the first consolidation cycle runs
    under a memory fraction too small for it, and (d) in batches of 2^24
    (fewer than eight: no cycle), where the final device merge does. Each
    must log its drain warning, finish on the host and equal phase 2."""
    import dataclasses
    import logging

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.runtime import scheduler

    cfg = dataclasses.replace(slice_config(), device_compact=True)
    cases = (
        ("c", 1 << 22, "_consolidate_device_runs",
         "device-resident consolidation ran out of device memory"),
        ("d", 1 << 24, "_merge_device_resident",
         "device-resident merge ran out of device memory"),
    )
    logged = []

    class Catch(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    handler = Catch(logging.WARNING)
    stream_log = logging.getLogger("hysortk_tpu_torch.stream")
    stream_log.addHandler(handler)
    os.environ["HYSORTK_DEVICE_RESIDENT_GROUP"] = "8"
    try:
        for tag, batch_bases, capped, warning in cases:
            logged.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.ExitStack() as stack:
                # In this order: the cap wraps the cycle counter in (c).
                cycles = stack.enter_context(
                    Recorder(scheduler, "_consolidate_device_runs"))
                cap = stack.enter_context(MemoryCapWithin(scheduler, capped, 64 << 20))
                host_merge = stack.enter_context(Recorder(scheduler, "merge_partial_lists"))
                t0 = time.perf_counter()
                kl, hist = ht.count_reads_streaming(codes, lengths, cfg, batch_bases,
                                                    device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            want, want_hist = one_shot
            if not (np.array_equal(kl.keys, want.keys)
                    and np.array_equal(kl.counts, want.counts)
                    and np.array_equal(hist, want_hist)):
                raise AssertionError(f"drain run 4({tag}) differs from phase 2's result")
            if not any(warning in w for w in logged):
                raise AssertionError(f"drain run 4({tag}) logged no drain warning: {logged}")
            if cap.calls != 1 or host_merge.calls != 1:
                raise AssertionError(
                    f"drain run 4({tag}): {cap.calls} capped calls of {capped}, "
                    f"{host_merge.calls} host-list merges (want 1 and 1)")
            log(f"phase4{tag} drain: {capped} under a cap of {cap.caps[0] / 2**30:.3f} GiB "
                f"raised torch.cuda.OutOfMemoryError; warning logged ({warning}); "
                f"{cycles.calls} consolidation cycles begun, finished by a host-list merge; "
                f"wall {wall:.4f} s, peak device memory {peak / 2**30:.3f} GiB; "
                f"{len(kl)} k-mers equal to phase 2's")
    finally:
        os.environ.pop("HYSORTK_DEVICE_RESIDENT_GROUP", None)
        stream_log.removeHandler(handler)
        torch.cuda.set_per_process_memory_fraction(1.0)


def profile_call(run, what: str) -> tuple[float, float]:
    """One call under torch.profiler: where its wall time goes by the
    scheduler's stage spans (a streaming call's), and its device time by
    kernel. Returns (device busy ms, wall ms under the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    run()  # warm
    with profile(activities=activities):  # the tracer's own start-up
        torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA
    # Kernels and copies as the device ran them; the spans' device-side
    # twins cover the same time again and are left out.
    kernels = [e for e in events
               if e.device_type == on_device and not e.key.startswith("stream/")]
    spans = [e for e in events
             if e.device_type != on_device and e.key.startswith("stream/")]

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    log(f"{what} profile: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms, device idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(spans, key=lambda e: -e.cpu_time_total):
        log(f"{what} profile span {e.key}: {e.cpu_time_total / 1e3:.1f} ms host "
            f"over {e.count} calls")
    for e in sorted(kernels, key=device_us, reverse=True)[:10]:
        log(f"{what} profile device {e.key[:60]}: {device_us(e) / 1e3:.2f} ms "
            f"over {e.count} calls")
    return busy_ms, wall_ms


# --------------------------------------------------------------------------
# Phase 5


def phase5_cli(workdir: str, fasta: str, reads) -> None:
    """python -m hysortk_tpu_torch.cli, streaming, on phase 3's FASTA."""
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.io import writer

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for tag, extra in (("host", []), ("compact", ["--device-compact"])):
        out_dir = os.path.join(workdir, f"cli_out_{tag}")
        proc = subprocess.run(
            [sys.executable, "-m", "hysortk_tpu_torch.cli", fasta, out_dir,
             "-k", str(K), "-m", str(M), "-l", "2", "-u", "10", "--device", "cuda",
             "--stream-batch-bases", "2000", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise AssertionError(f"phase 5 cli exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        got = {km.decode(): c for km, c in writer.parse_output_files(out_dir).items()}
        want = testing.oracle_filtered(reads, K, 2, 10)
        if got != want or not want:
            raise AssertionError(f"phase 5 ({tag}): {len(got)} k-mers vs oracle {len(want)}")
        log(f"phase5 cli --stream-batch-bases 2000 {' '.join(extra)}: "
            f"{len(got)} k-mers equal to the oracle")

# --------------------------------------------------------------------------
# Phase 6


def same_list(a, b) -> bool:
    return np.array_equal(a.keys, b.keys) and np.array_equal(a.counts, b.counts)


def phase6_fused_sort(codes, lengths, one_shot):
    """Path A at full width: phase 2's call with HYSORTK_FUSED_SORT set.
    Returns the launch counts of its calls."""
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build

    cfg = slice_config()
    want, want_hist = one_shot
    before = os.environ.get("HYSORTK_FUSED_SORT")
    os.environ["HYSORTK_FUSED_SORT"] = "1"
    try:
        _build.reset_launches()
        walls = []
        for call in range(3):
            t0 = time.perf_counter()
            kl, hist = ht.kmer_count(codes, lengths, cfg, device="cuda")
            walls.append(time.perf_counter() - t0)
            if call == 0 and [_build.launches[name] for name in (
                    "fused_sort", "fused_count", "keybuild", "radix_sort")] != [1, 1, 0, 0]:
                raise AssertionError(
                    f"one fused call launched {json.dumps(_build.launches)}")
            if not (same_list(kl, want) and np.array_equal(hist, want_hist)):
                raise AssertionError("the fused path differs from phase 2's result")
        launches = dict(_build.launches)
    finally:
        if before is None:
            del os.environ["HYSORTK_FUSED_SORT"]
        else:
            os.environ["HYSORTK_FUSED_SORT"] = before
    log(f"phase6 HYSORTK_FUSED_SORT=1 kmer_count: {len(kl)} k-mers equal to phase "
        f"2's; walls {', '.join(f'{w:.4f}' for w in walls)} s; launches "
        f"{json.dumps(launches)}")
    return launches, min(walls)


# --------------------------------------------------------------------------
# Phase 7


def phase7_roll(codes, lengths, one_shot):
    """Path B at full width, composed: key build -> sort_words("roll") ->
    fused count on phase 2's device batch. Returns its launch counts."""
    import torch

    from hysortk_tpu_torch import _build, pipeline
    from hysortk_tpu_torch.ops import block_sort, fused_count, keybuild, radix_sort

    cfg = slice_config()
    codes_d, valid_d = pipeline.device_batch(codes, lengths, cfg, "cuda")
    _build.reset_launches()
    marked = keybuild.canonical_keys_fused(codes_d, valid_d, cfg.k)
    words, _ = radix_sort.sort_words(marked, formulation="roll")
    cnt, keep = fused_count.run_length_count_filter(words, cfg.lower, cfg.upper)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in ("keybuild", "block_sort", "merge_runs", "fused_count"):
        if launches[name] != 1:
            raise AssertionError(f"path B launched {name} {launches[name]} times")
    if launches["radix_sort"] or launches["fused_sort"]:
        raise AssertionError("path B went through the radix sort")
    radix_words, _ = radix_sort.sort_words(marked)
    require_equal("roll sort against the radix sort", max_abs_err(words, radix_words))
    del radix_words
    kl = pipeline.compact_keys(words, cnt, pipeline.kept_slots(keep), cfg.k, cfg.upper)
    if not same_list(kl, one_shot[0]):
        raise AssertionError("path B differs from phase 2's result")
    del words, cnt, keep
    n = marked[0].shape[0]
    radix = lambda: radix_sort.sort_words(marked)
    roll = lambda: radix_sort.sort_words(marked, formulation="roll")
    turns = [cuda_ms(f, 3) for f in (radix, roll, roll, radix)]
    log(f"phase7 roll sort n={n} W={len(marked)} B={block_sort.DEFAULT_BLOCK}: "
        f"{len(kl)} k-mers equal to phase 2's, sorted words equal to the radix "
        f"sort's; radix {turns[0]:.4f} / {turns[3]:.4f} ms, roll {turns[1]:.4f} / "
        f"{turns[2]:.4f} ms; launches {json.dumps(launches)}")
    for block in (4096, 8192, 16384):
        ms = cuda_ms(lambda: radix_sort.sort_words(
            marked, formulation="roll", block=block), 3)
        bms = cuda_ms(lambda: block_sort.block_bitonic_sort(
            marked, len(marked), block, False), 3)
        log(f"phase7 roll sort B={block}: {ms:.4f} ms, of which block sort {bms:.4f} ms")
    return launches


# --------------------------------------------------------------------------
# Phase 8


def oracle_ext(reads, k: int, lower: int, upper: int, rid0: int = 0):
    """kmer -> (count, {(rid, pos)}) by pure Python."""
    from hysortk_tpu_torch import testing

    occ: dict = {}
    for r, read in enumerate(reads):
        s = testing.normalize(read)
        for i in range(len(s) - k + 1):
            occ.setdefault(testing.canonical(s[i:i + k]).encode(), set()).add(
                (r + rid0, i))
    return {km: (len(v), v) for km, v in occ.items() if lower <= len(v) <= upper}


def sample_ext(kl, step: int):
    """Every step-th k-mer of an extension list, as its as_dict()."""
    from hysortk_tpu_torch import pipeline

    return pipeline.KmerListExt(
        keys=kl.keys[::step], counts=kl.counts[::step], k=kl.k,
        pos=kl.pos[::step], rid=kl.rid[::step]).as_dict()


def phase8_extension(workdir, codes, lengths, one_shot, one_shot_peak, fasta,
                     reads, errs):
    """Path C: extension mode one-shot at full width, streamed at full width
    and on 2^24 bases, on the small FASTA through the facade and the CLI,
    and the streamed call's drain. Returns the references of
    phase 10: (a)'s list and histogram, and (c)'s one-shot ones on the
    first EXT_STREAM_BASES bases with read ids from EXT_RID0."""
    import dataclasses

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build, pipeline, testing
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.io import writer
    from hysortk_tpu_torch.ops import fused_count, keybuild, radix_sort, wire
    from hysortk_tpu_torch.ops import kmer as kmer_ops

    cfg = dataclasses.replace(slice_config(), extension=True)

    # (a) one-shot at 2^26 bases through the facade.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    kl, hist = ht.kmer_count(codes, lengths, cfg, device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.launches)
    if [launches[name] for name in ONE_SHOT_KERNELS] != [1, 1, 1]:
        raise AssertionError(f"extension call launched {json.dumps(launches)}")
    if not isinstance(kl, ht.KmerListExt):
        raise AssertionError("extension call returned no KmerListExt")
    if not (same_list(kl, one_shot[0]) and np.array_equal(hist, one_shot[1])):
        raise AssertionError("extension counts differ from phase 2's")
    n_occ = int(kl.counts.sum())
    sizes = np.diff(kl.offsets)
    if not (np.array_equal(sizes, kl.counts) and len(kl.rid) == len(kl)
            and kl.occ_rid.shape == kl.occ_pos.shape == (n_occ,)):
        raise AssertionError("occurrence lists do not match the counts")
    # Every occurrence of a sample of k-mers, read back from the reads.
    read_codes = codes[: lengths.size * READ_LEN].reshape(-1, READ_LEN)
    sample = range(0, len(kl), max(len(kl) // 500, 1))
    decoded = kmer_ops.decode_keys(kl.keys[sample.start::sample.step], K).tolist()
    for j, want_kmer in zip(sample, decoded):
        for r, p in zip(kl.rid[j].tolist(), kl.pos[j].tolist()):
            kmer = "".join("ACGT"[c] for c in read_codes[r, p:p + K])
            if testing.canonical(kmer).encode() != want_kmer:
                raise AssertionError(f"k-mer {j} does not occur at read {r} pos {p}")
    d2h = kl.keys.nbytes + kl.counts.nbytes + 8 * len(kl) + 8 * n_occ
    plain_d2h = one_shot[0].keys.nbytes + one_shot[0].counts.nbytes
    log(f"phase8a kmer_count(extension=True) {int(codes.size)} bases: {len(kl)} "
        f"k-mers equal to phase 2's, {n_occ} occurrences; wall {wall:.4f} s; peak "
        f"device memory {peak / 2**30:.3f} GiB (phase 2: {one_shot_peak / 2**30:.3f}); "
        f"D2H {d2h} B (phase 2: {plain_d2h} B); launches {json.dumps(launches)}")
    ext_one_shot = (kl, hist)
    del kl, sizes

    # (b) the one-shot call's stages, then its device outputs against the
    # plain composition on the same tensors.
    t0 = time.perf_counter()
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, "cuda")
    torch.cuda.synchronize()
    t_wire = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = list(wire.decode_block_ext(packed, lens, cfg.k, n, 0))
    words, cnt, keep, rid_s, pos_s = pipeline._count_device_ext(
        *dev, cfg.k, cfg.lower, cfg.upper)
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t0
    del packed, lens
    t0 = time.perf_counter()
    with copy_out_clock() as copy_ms:
        assembled = pipeline.kept_partial(words, cnt, keep, rid_s, pos_s)[0].to_host(cfg.k)
    t_assemble = time.perf_counter() - t0
    if not same_list(assembled, one_shot[0]):
        raise AssertionError("the assembled extension list differs from phase 2's")
    del assembled
    # The host flatten that fed this call before (two np.repeat over every
    # slot), for comparison: its read ids and positions are the device's.
    t0 = time.perf_counter()
    flat, valid, rid, pos = fasta_io.flatten_for_device_ext(
        codes, lengths, cfg.k, cfg.pad_multiple)
    t_flatten = time.perf_counter() - t0
    at = torch.from_numpy(valid).cuda()
    if not (flat.shape[0] == n
            and torch.equal(dev[2][at].cpu(), torch.from_numpy(rid[valid]))
            and torch.equal(dev[3][at].cpu(), torch.from_numpy(pos[valid].view(np.int32)))):
        raise AssertionError("the device's read ids and positions differ from the "
                             "host flatten's")
    del flat, valid, rid, pos, at
    log(f"phase8b stages of the one-shot extension call: wire pack + H2D "
        f"{t_wire:.4f} s, device pipeline (decode, key build, sort, count) "
        f"{t_device:.4f} s, gather + D2H + flat result {t_assemble:.4f} s (copy-out "
        f"{sum(copy_ms) / 1e3:.4f} s); the former host flatten alone {t_flatten:.4f} s")
    marked = keybuild.canonical_keys_plain(dev[0], dev[1], cfg.k)
    p_words, (p_rid, p_pos) = radix_sort.sort_words_plain(marked, dev[2:])
    p_cnt, p_keep = fused_count.run_length_count_filter_plain(
        p_words, cfg.lower, cfg.upper)
    e_sort = max_abs_err(words + [rid_s, pos_s], p_words + [p_rid, p_pos])
    e_count = max_abs_err([cnt, keep], [p_cnt, p_keep])
    require_equal("extension sort (words + rid + pos)", e_sort)
    require_equal("extension count", e_count)
    errs["radix_sort"] = max(errs["radix_sort"], e_sort)
    errs["fused_count"] = max(errs["fused_count"], e_count)
    del words, cnt, keep, rid_s, pos_s, p_words, p_rid, p_pos, p_cnt, p_keep
    marked = keybuild.canonical_keys_fused(dev[0], dev[1], cfg.k)
    ms = cuda_ms(lambda: radix_sort.sort_words(marked, dev[2:]), 3)
    ms_keys = cuda_ms(lambda: radix_sort.sort_words(marked), 3)
    log(f"phase8b device outputs (words, rid, pos, counts, keep) equal to the plain "
        f"composition; radix sort W=2+2 payload rows {ms:.4f} ms (keys only "
        f"{ms_keys:.4f} ms)")
    del dev, marked
    torch.cuda.empty_cache()

    # (c) streamed against one-shot: at full width (phase 2's reads in
    # batches of 2^24, read ids from 0) against (a), then on the first
    # EXT_STREAM_BASES bases in batches of 2^22 with a read id offset
    # against count_reads_ext on the same reads; then the full-width call
    # stage by stage.
    phase8_streamed("full", codes, lengths, cfg, STREAM_BATCH, 0, ext_one_shot, wall)
    sub_codes, sub_lengths = ext_stream_reads(codes, lengths)
    rid0 = EXT_RID0
    t0 = time.perf_counter()
    want, want_hist = ht.count_reads_ext(sub_codes, sub_lengths, cfg, rid0,
                                         device="cuda")
    one_wall = time.perf_counter() - t0
    got = phase8_streamed("sub", sub_codes, sub_lengths, cfg, EXT_STREAM_BATCH, rid0,
                          (want, want_hist), one_wall)
    if int(got[0].occ_rid.min()) < rid0:
        raise AssertionError("the read id offset was lost")
    ext_sub_one_shot = (want, want_hist)
    del got
    phase8_stream_stages(codes, lengths, cfg, STREAM_BATCH, ext_one_shot)

    # (d) the small FASTA: facade and CLI against the oracle.
    want = oracle_ext(reads, K, 2, 10)
    small_cfg = ht.KmerConfig(k=K, m=M, lower=2, upper=10, extension=True)
    s_codes, s_lengths = ht.read_dna_buffer(fasta)
    kl, _ = ht.kmer_count(s_codes, s_lengths, small_cfg, device="cuda")
    streamed, _ = ht.count_reads_streaming_ext(s_codes, s_lengths, small_cfg, 2000,
                                               device="cuda")
    if not (kl.as_dict() == want and streamed.as_dict() == want and want):
        raise AssertionError("extension result on the small FASTA differs from "
                             "the oracle")
    log(f"phase8d kmer_count(extension=True) and count_reads_streaming_ext on the "
        f"small FASTA: {len(want)} k-mers with their occurrences equal to the oracle")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    counts = {km.decode(): c for km, (c, _) in want.items()}
    for tag, extra in (("one_shot", []), ("stream", ["--stream-batch-bases", "2000"])):
        out_dir = os.path.join(workdir, f"cli_ext_{tag}")
        proc = subprocess.run(
            [sys.executable, "-m", "hysortk_tpu_torch.cli", fasta, out_dir,
             "-k", str(K), "-m", str(M), "-l", "2", "-u", "10", "--device", "cuda",
             "--extension", "--validate", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0 or "validate OK" not in proc.stdout:
            raise AssertionError(f"phase 8 cli exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        got = {km.decode(): c for km, c in writer.parse_output_files(out_dir).items()}
        if got != counts:
            raise AssertionError(f"phase 8 cli ({tag}): {len(got)} k-mers vs oracle "
                                 f"{len(counts)}")
        log(f"phase8d cli --extension {' '.join(extra)}: {len(got)} k-mers equal "
            f"to the oracle")
    # (e) the out-of-memory drain of the device merge.
    phase8_drain(sub_codes, sub_lengths, cfg, rid0, ext_sub_one_shot)
    return ext_one_shot, ext_sub_one_shot


def phase8_streamed(tag, codes, lengths, cfg, batch_bases, rid0, want, one_wall):
    """count_reads_streaming_ext against a one-shot (list, histogram) of the
    same reads: keys, counts and histogram equal, every k-mer's occurrences
    equal as sets (as sorted (key, rid, pos) rows); the partials merged on
    the card once and never on the host, both merge kernels launched. Its
    line: wall against the one-shot wall, peak device memory, the held
    partials' bytes at the merge's entry and the merge's transient factor
    (its peak above what was allocated at its entry, over the held bytes),
    the launches. Returns (list, histogram)."""
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.runtime import scheduler

    seen = {}
    real_merge = scheduler.merge_ext_partials_device

    def measured_merge(parts, cfg_):
        torch.cuda.synchronize()
        seen["peak_before"] = torch.cuda.max_memory_allocated()
        seen["entry"] = torch.cuda.memory_allocated()
        seen["held"] = sum(p.nbytes for p in parts)
        seen["partials"] = len(parts)
        torch.cuda.reset_peak_memory_stats()
        out = real_merge(parts, cfg_)
        torch.cuda.synchronize()
        seen["merge_peak"] = torch.cuda.max_memory_allocated()
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    scheduler.merge_ext_partials_device = measured_merge
    try:
        with Recorder(scheduler, "merge_ext_partials") as host_merge:
            t0 = time.perf_counter()
            got, got_hist = ht.count_reads_streaming_ext(codes, lengths, cfg, batch_bases,
                                                         rid0, device="cuda")
            wall = time.perf_counter() - t0
    finally:
        scheduler.merge_ext_partials_device = real_merge
    launches = dict(_build.launches)
    peak = max(seen["peak_before"], seen["merge_peak"])
    if host_merge.calls or "held" not in seen:
        raise AssertionError(f"8(c) {tag}: {host_merge.calls} host merges, device merge "
                             f"{'run' if seen else 'not run'}")
    for name in STREAMING_KERNELS:
        if not launches[name]:
            raise AssertionError(f"8(c) {tag}: {name} was not launched")
    if not (same_list(got, want[0]) and np.array_equal(got_hist, want[1])):
        raise AssertionError(f"8(c) {tag}: streamed extension counts differ from one-shot")
    if not np.array_equal(np.diff(got.offsets), got.counts):
        raise AssertionError(f"8(c) {tag}: occurrence lists do not match the counts")
    t0 = time.perf_counter()
    require_same_ext(f"8(c) {tag}", (got, got_hist), want)
    factor = (seen["merge_peak"] - seen["entry"]) / max(seen["held"], 1)
    log(f"phase8c count_reads_streaming_ext {int(codes.size)} bases in batches of "
        f"{batch_bases}, read_id_offset {rid0}: {len(got)} k-mers, {int(got.counts.sum())} "
        f"occurrences; keys, counts and histogram equal to the one-shot result, every "
        f"k-mer's occurrences equal as sets (checked in {time.perf_counter() - t0:.1f} s); "
        f"wall {wall:.4f} s (one-shot {one_wall:.4f} s); peak device memory "
        f"{peak / 2**30:.3f} GiB; {seen['partials']} partials held, "
        f"{seen['held'] / 2**20:.1f} MiB at the merge's entry, merge transient "
        f"{(seen['merge_peak'] - seen['entry']) / 2**20:.1f} MiB = {factor:.2f} x held "
        f"(budget factor {scheduler.EXT_MERGE_FACTOR}); host merges 0; launches on this "
        f"path merge_runs {launches['merge_runs']}, run_length_sum "
        f"{launches['run_length_sum']}; all {json.dumps(launches)}")
    return got, got_hist


def phase8_stream_stages(codes, lengths, cfg, batch_bases, want) -> None:
    """The full-width streamed extension call again, each stage synchronized
    at both edges and timed on the host and by CUDA events: the batch steps
    (wire feed, then decode, key build, sort, count), holding (the partial
    made from the step's outputs), the device merge (merge_runs,
    run_length_sum, the gather, each on its own), the D2H of the result and
    the device histogram; the call's host wall beside them."""
    import collections

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.ops import merge as merge_ops
    from hysortk_tpu_torch.ops import run_length_sum
    from hysortk_tpu_torch.runtime import scheduler

    host, dev, calls = collections.defaultdict(float), collections.defaultdict(float), \
        collections.Counter()
    patches = []

    def clock(owner, name, key):
        real = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            try:
                return real(*a, **k)
            finally:
                end.record()
                torch.cuda.synchronize()
                host[key] += (time.perf_counter() - t0) * 1e3
                dev[key] += start.elapsed_time(end)
                calls[key] += 1

        setattr(owner, name, timed)
        patches.append((owner, name, real))

    for owner, name, key in (
            (scheduler, "feed_wire", "feed"), (scheduler, "_count_device_ext_packed", "step"),
            (scheduler, "ext_partial", "hold"), (scheduler, "merge_ext_partials_device", "merge"),
            (merge_ops, "merge_runs_at", "merge_runs"),
            (run_length_sum, "run_length_sum_fused", "run_length_sum"),
            (pipeline, "gather_kept_ext", "gather"), (pipeline.ExtPartial, "to_host", "d2h"),
            (pipeline, "device_histogram", "histogram")):
        clock(owner, name, key)
    try:
        t0 = time.perf_counter()
        got, got_hist = ht.count_reads_streaming_ext(codes, lengths, cfg, batch_bases,
                                                     device="cuda")
        staged_wall = time.perf_counter() - t0
    finally:
        for owner, name, real in reversed(patches):
            setattr(owner, name, real)
    if not (same_list(got, want[0]) and np.array_equal(got_hist, want[1])):
        raise AssertionError("8(c) stage by stage differs from the one-shot result")
    del got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ht.count_reads_streaming_ext(codes, lengths, cfg, batch_bases, device="cuda")
    wall = time.perf_counter() - t0
    rest = host["merge"] - host["merge_runs"] - host["run_length_sum"] - host["gather"] \
        - host["d2h"] - host["histogram"]
    line = "; ".join(f"{what} {host[key]:.1f} (device {dev[key]:.1f})"
                     for what, key in (("wire feed", "feed"), ("batch steps", "step"),
                                       ("holding", "hold"), ("merge_runs", "merge_runs"),
                                       ("run_length_sum", "run_length_sum"),
                                       ("gather", "gather"), ("D2H of the result", "d2h"),
                                       ("device histogram", "histogram")))
    log(f"phase8c stream stages (ms, host with the device's events in brackets; "
        f"{calls['step']} batches of {batch_bases}): {line}; the rest of the merge "
        f"{rest:.1f}; device merge in all {host['merge']:.1f}; wall {staged_wall:.4f} s "
        f"stage by stage, host wall of the call {wall:.4f} s")


def phase8_drain(codes, lengths, cfg, rid0, want) -> None:
    """(e) The streamed extension call's out-of-memory drain on the card: the
    device merge runs under a per-process memory fraction leaving 64 MiB
    above what the allocator holds at its entry (the held partials need
    several times more), so it raises torch.cuda.OutOfMemoryError; the run
    must log its drain warning, finish by the host merge and equal 8(c)."""
    import logging

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.runtime import scheduler

    logged = []

    class Catch(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    handler = Catch(logging.WARNING)
    stream_log = logging.getLogger("hysortk_tpu_torch.stream")
    stream_log.addHandler(handler)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with MemoryCapWithin(scheduler, "merge_ext_partials_device", 64 << 20) as cap, \
                Recorder(scheduler, "merge_ext_partials") as host_merge:
            t0 = time.perf_counter()
            got = ht.count_reads_streaming_ext(codes, lengths, cfg, EXT_STREAM_BATCH, rid0,
                                               device="cuda")
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        stream_log.removeHandler(handler)
        torch.cuda.set_per_process_memory_fraction(1.0)
    warning = "device merge of extension partials ran out of device memory"
    if not any(warning in w for w in logged):
        raise AssertionError(f"8(e) logged no drain warning: {logged}")
    if cap.calls != 1 or host_merge.calls != 1:
        raise AssertionError(f"8(e): {cap.calls} device merges, {host_merge.calls} host "
                             f"merges (want 1 and 1)")
    if not (same_list(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("8(e) differs from 8(c)")
    require_same_ext("8(e)", got, want)
    log(f"phase8e drain: merge_ext_partials_device under a cap of "
        f"{cap.caps[0] / 2**30:.3f} GiB raised torch.cuda.OutOfMemoryError; warning "
        f"logged ({warning}); finished by the host merge; wall {wall:.4f} s, peak device "
        f"memory {peak / 2**30:.3f} GiB; {len(got[0])} k-mers and every occurrence equal "
        f"to 8(c)")


# --------------------------------------------------------------------------
# Phase 9


def sorted_by_key(kl):
    """(keys, counts) of a KmerList in lexicographic key order: the sharded
    list is in rank order, then mixed-key order."""
    order = np.lexsort(kl.keys.T[::-1])
    return kl.keys[order], kl.counts[order]


def require_same_result(what: str, got, want) -> None:
    """A sharded (KmerList, histogram) against a one-shot one, after
    sorting by key."""
    (gk, gc), (wk, wc) = sorted_by_key(got[0]), sorted_by_key(want[0])
    if not (np.array_equal(gk, wk) and np.array_equal(gc, wc)
            and np.array_equal(got[1], want[1])):
        raise AssertionError(f"{what} differs from the one-shot result")


def sharded_run_stats(run, repeats: int) -> dict:
    """Run `run` `repeats` times under fresh counters; the counters and the
    peak device memory of the last run, every run's wall time."""
    import torch

    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.parallel import exchange

    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        exchange.reset_traffic()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(result=result, walls=walls, peak=torch.cuda.max_memory_allocated(),
                launches={k: v for k, v in _build.launches.items() if v},
                traffic=dict(exchange.traffic))


def phase9_rank(rank: int, inputs: str, fields: dict, out_dir: str,
                repeats: int) -> None:
    """One rank of phase 9 (b) or (c), in a process of its own: the sharded
    count on the reads of `inputs`; rank 0 writes the result, every rank its
    measurements."""
    import torch.distributed as dist

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.parallel import pipeline as sharded

    data = np.load(inputs)
    cfg = ht.KmerConfig(**fields)
    stats = sharded_run_stats(lambda: sharded.count_reads_sharded(
        data["codes"], data["lengths"], cfg), repeats)
    kl, hist = stats.pop("result")
    if rank == 0:
        np.savez(os.path.join(out_dir, "result.npz"), keys=kl.keys,
                 counts=kl.counts, hist=hist)
    stats["backend"] = dist.get_backend()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)


def log_sharded(tag: str, ranks: list[dict], n_kept: int) -> None:
    for r, st in enumerate(ranks):
        t = st["traffic"]
        log(f"phase9{tag} rank {r} ({st['backend']}): walls "
            f"{', '.join(f'{w:.4f}' for w in st['walls'])} s; peak device memory "
            f"{st['peak'] / 2**30:.3f} GiB; sent {t['bytes_sent']} B in "
            f"{t['calls']} exchange(s), {t['seconds'] * 1e3:.1f} ms in the exchange; "
            f"launches {json.dumps(st['launches'])}")
    log(f"phase9{tag} {n_kept} k-mers, keys, counts and histogram equal to the "
        f"one-shot result after sorting by key")


def phase9_stages(codes, lengths, cfg) -> None:
    """One rank's sharded call stage by stage, a synchronize after each
    (inside phase 9(a)'s group: the exchange is one rank's)."""
    import torch

    from hysortk_tpu_torch.ops import keybuild, mixkey, radix_sort, wire
    from hysortk_tpu_torch.parallel import exchange
    from hysortk_tpu_torch.parallel import pipeline as sharded

    stages = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.append(f"{name} {(time.perf_counter() - t0) * 1e3:.1f}")
        return out

    for _ in range(2):
        stages.clear()
        exchange.reset_traffic()

        def host_pack():
            shards = sharded._shard_reads(codes, lengths, 1)
            block_len, lmax = sharded._wire_dims(shards, cfg)
            return sharded._pack_shard(shards[0][0], shards[0][1], block_len,
                                       lmax), block_len

        (packed, lens), block_len = timed("host partition + pack", host_pack)
        codes_d, valid_d = timed("H2D + decode", lambda: wire.decode_block(
            torch.from_numpy(packed.view(np.int32)).cuda(),
            torch.from_numpy(lens).cuda(), cfg.k, block_len))
        marked = timed("keybuild", lambda: keybuild.canonical_keys_fused(
            codes_d, valid_d, cfg.k))
        mixed = timed("mix", lambda: mixkey.mix_keys(marked))
        del marked
        mixed_s = timed("radix sort", lambda: radix_sort.sort_words(mixed)[0])
        del mixed
        capacity = sharded.range_capacity(block_len, 1, cfg)
        merged, _, _, _ = timed(
            "offsets + all_reduce + pack + exchange + mask + merge",
            lambda: sharded._range_exchange_merge(
                mixed_s, [], valid_d.sum(), cfg, 1, capacity))
        del mixed_s
        cnt, keep = timed("fused count", lambda: sharded._count_merged(merged, cfg))
        timed("compact + D2H + unmix + all_gather + histogram",
              lambda: sharded._gather_result(merged, cnt, keep, cfg, None, True))
        del codes_d, valid_d, merged, cnt, keep
    log(f"phase9a stages of one sharded call, second of two, ms: {'; '.join(stages)} "
        f"(the exchange itself {exchange.traffic['seconds'] * 1e3:.1f})")


def phase9_sharded(workdir, codes, lengths, one_shot):
    """The sharded range exchange on phase 2's reads: (a) one rank with
    NCCL in this process, (b) 4 spawned ranks sharing the card over gloo
    (host staging), (c) the combiner forced on 2 spawned ranks on the first
    2^24 bases. Returns (a)'s launch counts (one call), the one-shot result
    on the first 2^24 bases and (a)'s exchange traffic."""
    import dataclasses

    import torch.distributed as dist

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.parallel import group
    from hysortk_tpu_torch.parallel import pipeline as sharded
    from hysortk_tpu_torch.parallel.spawn import spawn_ranks

    cfg = slice_config()
    group.init("file://" + os.path.join(workdir, "rendezvous-a"), 0, 1, "cuda")
    try:
        backend = dist.get_backend()
        a = sharded_run_stats(lambda: sharded.count_reads_sharded(
            codes, lengths, cfg), 3)
        phase9_stages(codes, lengths, cfg)
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        raise AssertionError(f"one rank with its own card took {backend}")
    require_same_result("phase 9(a)", a.pop("result"), one_shot)
    a["backend"] = backend
    for name in ("keybuild", "mix_keys", "radix_sort", "fused_count"):
        if not a["launches"].get(name):
            raise AssertionError(f"phase 9(a) did not launch {name}")
    log(f"phase9a 1 rank, best wall {min(a['walls']):.4f} s")
    log_sharded("a", [a], len(one_shot[0]))

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    runs = (("b", 4, codes, lengths, fields, one_shot),)
    sub_codes, sub_lengths = ext_stream_reads(codes, lengths)
    sub_one_shot = ht.kmer_count(sub_codes, sub_lengths, cfg, device="cuda")
    runs += (("c", 2, sub_codes, sub_lengths, dict(fields, combiner=True),
              sub_one_shot),)
    for tag, ranks, c, l, f, want in runs:
        out_dir = os.path.join(workdir, f"phase9{tag}")
        os.makedirs(out_dir)
        inputs = os.path.join(out_dir, "reads.npz")
        np.savez(inputs, codes=c, lengths=l)
        t0 = time.perf_counter()
        spawn_ranks(phase9_rank, ranks, (inputs, f, out_dir, 2), workdir=out_dir,
                    device="cuda", timeout=400)
        log(f"phase9{tag} {ranks} ranks on one card, {int(c.size)} bases: "
            f"{time.perf_counter() - t0:.1f} s with process start and a warm-up call")
        res = np.load(os.path.join(out_dir, "result.npz"))
        got = (ht.KmerList(res["keys"], res["counts"], K), res["hist"])
        require_same_result(f"phase 9({tag})", got, want)
        stats = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                stats.append(json.load(fh))
        needed = ["keybuild", "mix_keys", "radix_sort", "merge_runs", "fused_count"]
        if f["combiner"]:
            needed.append("run_length_sum")
        for r, st in enumerate(stats):
            if st["backend"] != "gloo":
                raise AssertionError(f"rank {r} of ranks sharing a card took "
                                     f"{st['backend']}")
            for name in needed:
                if not st["launches"].get(name):
                    raise AssertionError(f"phase 9({tag}) rank {r} did not launch {name}")
        log_sharded(tag, stats, len(want[0]))
    return a["launches"], sub_one_shot, a["traffic"]


# --------------------------------------------------------------------------
# Phase 10

STREAM_BATCH = 1 << 24  # phase 4(a)'s batches: four of phase 2's reads
# The kernels every phase-10 run launches, and those of some of them.
CORE_KERNELS = ("keybuild", "radix_sort", "fused_count")


def ext_occurrence_rows(kl):
    """Every occurrence of an extension-mode list as (key words, rid, pos)
    columns on the card, sorted (the plain sort, which no launch count
    sees): two lists are equal when these columns are."""
    import torch

    from hysortk_tpu_torch.ops import radix_sort

    counts = torch.from_numpy(kl.counts.astype(np.int64)).cuda()
    keys = torch.from_numpy(np.ascontiguousarray(kl.keys).view(np.int32)).cuda()
    keys = torch.repeat_interleave(keys, counts, dim=0)
    cols = [keys[:, i].contiguous() for i in range(keys.shape[1])]
    cols += [torch.from_numpy(kl.occ_rid).cuda(),
             torch.from_numpy(kl.occ_pos.view(np.int32)).cuda()]
    return radix_sort.sort_words_plain(cols)[0]


def require_same_ext(what: str, got, want, want_rows=None) -> None:
    """A sharded extension-mode (list, histogram) against a one-shot one:
    keys, counts and histogram after sorting by key, then every occurrence
    as sorted (key, rid, pos) rows (`want_rows`: the reference's, where the
    caller holds them already)."""
    import torch

    require_same_result(what, got, want)
    a = ext_occurrence_rows(got[0])
    b = ext_occurrence_rows(want[0]) if want_rows is None else want_rows
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: the occurrences differ from the one-shot result")
    del a, b
    torch.cuda.empty_cache()


def phase10_call(entry: str, codes, lengths, fields: dict, args: tuple = (),
                 kwargs: dict | None = None) -> dict:
    """One call of a sharded entry under fresh counters (sharded_run_stats)
    with its step passes counted, the streaming final merge timed and the
    calls of the extension-mode host flatteners (the feed of the bucketed
    routes before the wire) counted."""
    import contextlib
    from unittest import mock

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.parallel import pipeline as sharded

    cfg = ht.KmerConfig(**fields)
    merge_ms = []
    real_merge = sharded._merge_partials

    def timed_merge(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_merge(*a, **k)
        torch.cuda.synchronize()
        merge_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    flattens = []

    def counted(mod, name):
        real = getattr(mod, name)
        return mock.patch.object(
            mod, name, lambda *a, **k: flattens.append(name) or real(*a, **k))

    with contextlib.ExitStack() as stack:
        calls = testing.call_counters(stack, sharded)
        stack.enter_context(mock.patch.object(sharded, "_merge_partials", timed_merge))
        stack.enter_context(counted(fasta_io, "flatten_for_device_ext"))
        stack.enter_context(counted(sharded, "build_ext_blocks"))
        stats = sharded_run_stats(lambda: getattr(sharded, entry)(
            codes, lengths, cfg, *args, **(kwargs or {})), 1)
    stats["host_flattens"] = len(flattens)
    stats["passes"] = sum(n for name, n in calls.items() if "_shard_body" in name)
    stats["calls"] = dict(calls)
    stats["merge_ms"] = merge_ms
    return stats


def phase10_rank(rank: int, jobs: list, out_dir: str) -> None:
    """One rank of phase 10's spawned runs, in a process of its own: each
    job (entry, inputs, config fields, args, kwargs) in turn; rank 0 writes
    each result, every rank its measurements."""
    import torch.distributed as dist

    import hysortk_tpu_torch as ht

    for job in jobs:
        data = np.load(job["inputs"])
        stats = phase10_call(job["entry"], data["codes"], data["lengths"],
                             job["cfg"], tuple(job["args"]), job["kwargs"])
        kl, hist = stats.pop("result")
        if rank == 0:
            out = dict(keys=kl.keys, counts=kl.counts, hist=hist)
            if isinstance(kl, ht.KmerListExt):
                out.update(rid=kl.occ_rid, pos=kl.occ_pos)
            np.savez(os.path.join(out_dir, f"{job['tag']}.npz"), **out)
        del kl, hist
        stats["backend"] = dist.get_backend()
        with open(os.path.join(out_dir, f"{job['tag']}.rank{rank}.json"), "w") as f:
            json.dump(stats, f)


def load_phase10_result(path: str):
    import hysortk_tpu_torch as ht

    # Each item of an npz file is read anew when it is indexed: read once.
    res = dict(np.load(path))
    if "rid" not in res:
        return ht.KmerList(res["keys"], res["counts"], K), res["hist"]
    return ht.KmerListExt.from_flat(res["keys"], res["counts"], K, res["rid"],
                                    res["pos"]), res["hist"]


def log_phase10(tag: str, what: str, ranks: list[dict], n_kept: int,
                needed: tuple, phase: int = 10) -> None:
    """Check that every rank launched `needed`, and print each rank's line
    (the step passes count the step bodies of parallel/pipeline.py; the
    supermer route has none)."""
    for r, st in enumerate(ranks):
        for name in needed:
            if not st["launches"].get(name):
                raise AssertionError(f"phase {phase}({tag}) rank {r} did not launch "
                                     f"{name}")
        t = st["traffic"]
        merge = (f"; final merge {st['merge_ms'][0]:.1f} ms" if st["merge_ms"] else "")
        log(f"phase{phase}{tag} {what} rank {r}/{len(ranks)} ({st['backend']}): wall "
            f"{st['walls'][0]:.4f} s; peak device memory {st['peak'] / 2**30:.3f} GiB; "
            f"{st['passes']} step passes; sent {t['bytes_sent']} B in {t['calls']} "
            f"exchange(s), {t['seconds'] * 1e3:.1f} ms in the exchange{merge}; "
            f"launches {json.dumps(st['launches'])}")
    log(f"phase{phase}{tag} {what}: {n_kept} k-mers equal to the reference")


def phase10_minimizer_stages(codes, lengths, cfg) -> None:
    """One rank's minimizer call stage by stage, a synchronize after each
    (inside phase 10's one-rank group)."""
    import torch

    from hysortk_tpu_torch.ops import keybuild, minimizer, radix_sort, wire
    from hysortk_tpu_torch.parallel import exchange
    from hysortk_tpu_torch.parallel import pipeline as sharded

    stages = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.append(f"{name} {(time.perf_counter() - t0) * 1e3:.1f}")
        return out

    dev = torch.device("cuda", torch.cuda.current_device())
    for _ in range(2):
        stages.clear()
        packed, lens, block_len = timed(
            "host partition + pack + H2D",
            lambda: sharded._rank_wire(*sharded._rank_share(codes, lengths, None)[:2],
                                       cfg, None, dev))
        codes_d, valid_d = timed("decode", lambda: wire.decode_block(
            packed, lens, cfg.k, block_len))
        bucket = timed("minimizer scan", lambda: minimizer.kmer_destinations(
            codes_d, cfg.k, cfg.m, sharded._num_buckets(cfg, 1)))
        _, assign, capacity, _ = timed(
            "bucket sizes + plan (a second scan inside)",
            lambda: sharded.plan_sharded_step(codes_d, valid_d, cfg, 1, block_len))
        words = timed("keybuild", lambda: keybuild.canonical_keys_fused(
            codes_d, valid_d, cfg.k))
        send, counts, overflow = timed(
            "pack by destination", lambda: exchange.pack_by_destination(
                valid_d, assign[bucket.to(torch.int64)], words, [], 1, capacity))

        def all_reduce_exchange_mask():  # sharded._bucketed_exchange after its pack
            sharded._global_stats(counts, overflow, dev, None)
            recv, _, recv_valid = exchange.all_to_all_exchange(send, counts, None)
            return [w.reshape(-1) for w in exchange.mask_invalid_slots(
                [recv[:, r] for r in range(cfg.words)], recv_valid)]

        rows = timed("all_reduce + exchange + mask", all_reduce_exchange_mask)
        del send, words, bucket
        words_s, _ = timed("receive sort", lambda: radix_sort.sort_words(rows))
        del rows
        cnt, keep = timed("fused count", lambda: sharded._count_merged(words_s, cfg))
        timed("compact + D2H + all_gather + histogram",
              lambda: sharded._gather_result(words_s, cnt, keep, cfg, None, False))
        del codes_d, valid_d, words_s, cnt, keep, packed, lens
    log(f"phase10d stages of one minimizer call, second of two, ms: {'; '.join(stages)}")


def phase10_sharded(workdir, codes, lengths, one_shot, ext_one_shot,
                    sub_one_shot, ext_sub_one_shot) -> None:
    """The rest of the sharded pipeline on phase 2's reads (configuration
    of phase 2): (a) sharded streaming, one rank, NCCL; (b) the same on two
    ranks sharing the card over gloo; (c) extension mode, one rank at 2^26
    bases, and on two ranks on the first 2^24 bases one-shot and streamed
    in batches of 2^22; (d) minimizer routing with the balanced dispatcher,
    one rank (with its stages) and four ranks; (e) on two ranks at 2^24
    bases: minimizer with round_robin and the combiner, kmer_hash, kmer_hash
    with extension mode. Every result exactly equal to the one-shot result
    it is held against, after sorting by key (extension mode: every
    occurrence as sorted (key, rid, pos) rows)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from hysortk_tpu_torch.parallel import group

    cfg = slice_config()
    base = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    ext = dict(base, extension=True)
    mini = dict(base, routing="minimizer")
    stream_needed = CORE_KERNELS + ("mix_keys", "merge_runs", "run_length_sum")

    t_phase = time.perf_counter()
    group.init("file://" + os.path.join(workdir, "rendezvous-10"), 0, 1, "cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"one rank with its own card took {dist.get_backend()}")
        a = phase10_call("count_reads_sharded_streaming", codes, lengths, base,
                         (STREAM_BATCH,))
        require_same_result("phase 10(a)", a.pop("result"), one_shot)
        a["backend"] = "nccl"
        log_phase10("a", f"count_reads_sharded_streaming, {int(codes.size)} bases in "
                    f"batches of {STREAM_BATCH}", [a], len(one_shot[0]), stream_needed)
        torch.cuda.empty_cache()
        c = phase10_call("count_reads_sharded_ext", codes, lengths, ext)
        if c["host_flattens"]:
            raise AssertionError("phase 10(c) one rank ran the host flatten")
        got = c.pop("result")
        t0 = time.perf_counter()
        require_same_ext("phase 10(c) one rank", got, ext_one_shot)
        del got
        c["backend"] = "nccl"
        log_phase10("c", f"count_reads_sharded_ext, {int(codes.size)} bases (held against "
                    f"phase 8(a) in {time.perf_counter() - t0:.1f} s)", [c],
                    len(ext_one_shot[0]), CORE_KERNELS + ("mix_keys",))
        torch.cuda.empty_cache()
        d = phase10_call("count_reads_sharded", codes, lengths, mini)
        require_same_result("phase 10(d) one rank", d.pop("result"), one_shot)
        d["backend"] = "nccl"
        log_phase10("d", f"minimizer (balanced), {int(codes.size)} bases", [d],
                    len(one_shot[0]), CORE_KERNELS)
        phase10_minimizer_stages(codes, lengths, dataclasses.replace(
            cfg, routing="minimizer"))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    sub_codes, sub_lengths = ext_stream_reads(codes, lengths)
    inputs = {}
    for name, (c_, l_) in (("all", (codes, lengths)), ("sub", (sub_codes, sub_lengths))):
        inputs[name] = os.path.join(workdir, f"phase10-{name}.npz")
        np.savez(inputs[name], codes=c_, lengths=l_)
    rid0 = dict(read_id_offset=EXT_RID0)
    spawns = {
        2: [  # (tag, what, entry, inputs, cfg, args, kwargs, reference, kernels)
            ("b", "count_reads_sharded_streaming, 2^26 bases in batches of 2^24",
             "count_reads_sharded_streaming", "all", base, (STREAM_BATCH,), {},
             one_shot, stream_needed),
            ("c", "count_reads_sharded_ext, 2^24 bases", "count_reads_sharded_ext",
             "sub", ext, (), rid0, ext_sub_one_shot, CORE_KERNELS + ("mix_keys",)),
            ("c", "count_reads_sharded_ext_streaming, 2^24 bases in batches of 2^22",
             "count_reads_sharded_ext_streaming", "sub", ext, (EXT_STREAM_BATCH,), rid0,
             ext_sub_one_shot, CORE_KERNELS + ("mix_keys",) + STREAMING_KERNELS),
            ("e", "minimizer, round_robin + combiner, 2^24 bases", "count_reads_sharded",
             "sub", dict(mini, dispatcher="round_robin", combiner=True), (), {},
             sub_one_shot, CORE_KERNELS + ("run_length_sum",)),
            ("e", "kmer_hash, 2^24 bases", "count_reads_sharded", "sub",
             dict(base, routing="kmer_hash"), (), {}, sub_one_shot, CORE_KERNELS),
            ("e", "kmer_hash + extension, 2^24 bases", "count_reads_sharded_ext", "sub",
             dict(ext, routing="kmer_hash"), (), rid0, ext_sub_one_shot, CORE_KERNELS),
        ],
        4: [
            ("d", "minimizer (balanced), 2^26 bases", "count_reads_sharded", "all", mini,
             (), {}, one_shot, CORE_KERNELS),
        ],
    }
    def no_host_flatten(tag, stats):
        flattens = [st["host_flattens"] for st in stats]
        if any(flattens):
            raise AssertionError(f"phase 10({tag}) ran the host flatten {flattens} times")
        no_host_merge(10, tag, stats)
        log(f"phase10{tag} host flatten calls per rank: {flattens}")

    # The reference of three runs: its sorted occurrence rows once.
    sub_rows = ext_occurrence_rows(ext_sub_one_shot[0])
    run_spawned(workdir, 10, spawns, inputs, ext_sub_one_shot, sub_rows,
                no_host_flatten)
    del sub_rows
    log(f"phase10 {time.perf_counter() - t_phase:.1f} s in all")


def no_host_merge(phase: int, tag: str, stats: list[dict]) -> None:
    """A spawned run's ranks merged their extension partials on the card
    only: the host merge is the drain's, and nothing here drains."""
    merges = [(st["calls"]["merge_ext_partials_device"], st["calls"]["merge_ext_partials"])
              for st in stats]
    if any(host for _, host in merges):
        raise AssertionError(f"phase {phase}({tag}) took the host merge: {merges}")
    if any(device for device, _ in merges):
        log(f"phase{phase}{tag} extension merges per rank (device, host): {merges}")


def run_spawned(workdir, phase: int, spawns: dict, inputs: dict, ext_ref, ext_rows,
                check=None) -> None:
    """The spawned runs of phase 10 or 11: per rank count, one spawn of
    ranks sharing the card over gloo running its jobs (tag, what, entry,
    inputs key, config fields, args, kwargs, reference, kernels) in turn;
    each result held against its reference (extension mode against
    `ext_rows`, the sorted occurrence rows of `ext_ref`, where that is the
    reference), each rank's line printed, and check(tag, rank stats) where
    given."""
    from hysortk_tpu_torch.parallel.spawn import spawn_ranks

    for ranks, runs in spawns.items():
        out_dir = os.path.join(workdir, f"phase{phase}-{ranks}")
        os.makedirs(out_dir)
        jobs = [dict(tag=f"{tag}{i}", entry=entry, inputs=inputs[which], cfg=fields,
                     args=list(args), kwargs=kwargs)
                for i, (tag, _, entry, which, fields, args, kwargs, _, _) in enumerate(runs)]
        t0 = time.perf_counter()
        spawn_ranks(phase10_rank, ranks, (jobs, out_dir), workdir=out_dir,
                    device="cuda", timeout=600)
        log(f"phase{phase} {ranks} ranks on one card, {len(jobs)} run(s): "
            f"{time.perf_counter() - t0:.1f} s with process start")
        for job, (tag, what, entry, _, fields, _, _, want, needed) in zip(jobs, runs):
            got = load_phase10_result(os.path.join(out_dir, f"{job['tag']}.npz"))
            if fields.get("extension"):
                require_same_ext(f"phase {phase}({tag}) {what}", got, want,
                                 ext_rows if want is ext_ref else None)
            else:
                require_same_result(f"phase {phase}({tag}) {what}", got, want)
            del got
            stats = []
            for r in range(ranks):
                with open(os.path.join(out_dir, f"{job['tag']}.rank{r}.json")) as fh:
                    stats.append(json.load(fh))
            if any(st["backend"] != "gloo" for st in stats):
                raise AssertionError("ranks sharing a card took another backend than gloo")
            if check is not None:
                check(tag, stats)
            log_phase10(tag, what, stats, len(want[0]), needed, phase)


# --------------------------------------------------------------------------
# Phase 11

POLY_A_SHARE = 0.25  # of the k-mers of 11(c)'s reads: one dominant bucket
# 11(c)'s second case: few enough bases that the poly-A key's count stays
# within U = 65535, so that its pre-counted total reaches the result
HEAVY_KEPT_BASES = 1 << 17


def phase11_hard_cases() -> None:
    """The supermer hard cases of hysortk_tpu_torch.testing on the card,
    inside phase 11's one-rank group: each encoder case's reads through the
    route, equal to kmer_count's result; each fill_run_meta case on the
    card, equal to its CPU result."""
    import dataclasses

    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import testing
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.ops import wire
    from hysortk_tpu_torch.parallel import pipeline as sharded

    n = 0
    for kind in testing.SUPERMER_KINDS:
        for k, m in ((15, 7), (31, 17)):
            reads = testing.supermer_reads(kind, k, 11)
            codes, lengths = fasta_io.reads_to_codes(reads)
            cfg = ht.KmerConfig(k=k, m=m, lower=1, upper=2**15)
            want = ht.kmer_count(codes, lengths, cfg, device="cuda")
            got = sharded.count_reads_sharded(
                codes, lengths, dataclasses.replace(cfg, routing="supermer"))
            require_same_result(f"phase 11 hard case {kind} k={k}", got, want)
            n += 1
    cases = testing.fill_meta_cases()
    for name, lens, rid0, pos0, size in cases:
        args = (torch.from_numpy(lens), torch.from_numpy(rid0),
                torch.from_numpy(pos0.view(np.int32)))
        cpu = wire.fill_run_meta(*args, size)
        dev = wire.fill_run_meta(*(a.cuda() for a in args), size)
        if not all(torch.equal(c, d.cpu()) for c, d in zip(cpu, dev)):
            raise AssertionError(f"phase 11 fill_run_meta case {name} differs on the card")
    log(f"phase11 hard cases: {n} encoder cases through the route equal to kmer_count, "
        f"{len(cases)} fill_run_meta cases equal to the CPU's")


def phase11_send_cases(errs) -> None:
    """The send side's hard cases on the card, inside phase 11's one-rank
    group: the run table's cases (testing.run_table_cases), then every
    encoder case at K = 15, 31, 55 and 95 on 1, 2 and 4 destinations,
    extension mode off and on: each kernel equal to its plain version on
    the same CUDA tensors, and the send tensor equal to the host encoder's
    `_segments(_encode(...))` on the same share."""
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import pipeline, testing
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.ops import supermer as sm_ops
    from hysortk_tpu_torch.ops import wire
    from hysortk_tpu_torch.parallel import supermer_route as sr

    dev = torch.device("cuda", torch.cuda.current_device())
    cases = testing.run_table_cases()
    for name, valid, dest, m in cases:
        args = (torch.from_numpy(valid).to(dev), torch.from_numpy(dest).to(dev), m)
        e = max_abs_err(sm_ops.run_table(*args), sm_ops.run_table_plain(*args))
        require_equal(f"supermer_runs case {name}", e)
        errs["supermer_runs"] = max(errs["supermer_runs"], e)
    n = 0
    for kind in testing.SUPERMER_KINDS:
        for k, m in ((15, 7), (31, 17), (55, 13), (95, 17)):
            codes, lengths = fasta_io.reads_to_codes(testing.supermer_reads(kind, k, 5))
            lengths = lengths.astype(np.int32)
            flat, valid = fasta_io.flatten_for_device(codes, lengths, k, 256)
            for num_dest in (1, 2, 4):
                shard_of = testing.supermer_case_dest(kind, flat.size, num_dest, 5)
                for ext in (False, True):
                    what = f"{kind} k={k} S={num_dest}{' ext' if ext else ''}"
                    cfg = ht.KmerConfig(k=k, m=m, pad_multiple=256, extension=ext)
                    rid0 = 2**31 - 5 if ext else 0
                    want = sr._segments(sr._encode(flat, valid, shard_of, cfg, num_dest,
                                                   lengths, rid0, ext), cfg, dev, None)[0]
                    packed, lens_d, n_slots = pipeline.wire_batch(codes, lengths, cfg, dev)
                    codes_d, valid_d = wire.decode_block(packed, lens_d, k, n_slots)
                    args = (valid_d, torch.from_numpy(shard_of).to(dev), sm_ops.max_kmers(k))
                    runs = sm_ops.run_table(*args)
                    e = max_abs_err(runs, sm_ops.run_table_plain(*args))
                    require_equal(f"supermer_runs {what}", e)
                    errs["supermer_runs"] = max(errs["supermer_runs"], e)
                    layout = sm_ops.segment_layout(*runs, k, num_dest)
                    dims = sm_ops.segment_dims(layout.cmax, layout.smax, 256)
                    headers = sm_ops.run_headers(layout.src, lens_d, rid0) if ext else ()
                    got = sm_ops.pack_segments(codes_d, layout, *dims, headers)
                    e = max_abs_err([got], [sm_ops.pack_segments_plain(codes_d, layout,
                                                                       *dims, headers)])
                    require_equal(f"supermer_pack {what}", e)
                    errs["supermer_pack"] = max(errs["supermer_pack"], e)
                    if not torch.equal(got, want):
                        raise AssertionError(f"phase 11 send case {what}: the send tensor "
                                             f"differs from the host encoder's")
                    n += 1
    log(f"phase11 send cases: {len(cases)} run-table cases and {n} encoder cases, each "
        f"kernel equal to its plain version, each send tensor equal to the host "
        f"encoder's")


def phase11_kernels(codes, lengths, cfg, errs) -> dict:
    """The send side's two kernels against their plain versions on the
    inputs 11(a)'s step gives them (phase 2's reads on one rank: the wire
    decoded, the destination ranks of the one-rank plan), timed beside
    their bounds; then the send tensor against the host encoder's
    `_segments(_encode(...))` on phase 2's reads at one destination, and at
    four (the plan's buckets of four ranks) with and without extension
    mode. Inside phase 11's one-rank group. Returns the kernels'
    measurements and the share's wire (supermers, bases, segment dims)."""
    import dataclasses

    import torch

    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.ops import minimizer, wire
    from hysortk_tpu_torch.ops import supermer as sm_ops
    from hysortk_tpu_torch.parallel import dispatch
    from hysortk_tpu_torch.parallel import pipeline as sharded
    from hysortk_tpu_torch.parallel import supermer_route as sr

    dev = torch.device("cuda", torch.cuda.current_device())
    lens = lengths.astype(np.int32)
    packed, lens_d, n = pipeline.wire_batch(codes, lens, cfg, dev)
    codes_d, valid = wire.decode_block(packed, lens_d, cfg.k, n)
    del packed
    dest = minimizer.kmer_destinations(codes_d, cfg.k, cfg.m, sharded._num_buckets(cfg, 1))
    _, assign = sr._plan(dest, valid, cfg, None, True, dev, None)
    shard_of = torch.from_numpy(assign.astype(np.int32)).to(dev)[dest.to(torch.int64)]
    mk = sm_ops.max_kmers(cfg.k)
    runs = sm_ops.run_table(valid, shard_of, mk)
    e = max_abs_err(runs, sm_ops.run_table_plain(valid, shard_of, mk))
    require_equal("supermer_runs main path", e)
    errs["supermer_runs"] = max(errs["supermer_runs"], e)
    r = runs[0].numel()
    # In: valid + int32 destination a position; out: 16 B a run. Per
    # position a head test, a modulo and two scan steps in each of two
    # passes.
    rt_bound = bound(5 * n + 16 * r, 20 * n)
    rt = dict(
        ms=cuda_ms(lambda: sm_ops.run_table(valid, shard_of, mk), 10),
        plain_ms=cuda_ms(lambda: sm_ops.run_table_plain(valid, shard_of, mk), 3),
        bound_ms=rt_bound[0], bound_by=rt_bound[1], library_ms=None,
    )
    layout = sm_ops.segment_layout(*runs, cfg.k, 1)
    dims = sm_ops.segment_dims(layout.cmax, layout.smax, cfg.pad_multiple)
    send = sm_ops.pack_segments(codes_d, layout, *dims)
    e = max_abs_err([send], [sm_ops.pack_segments_plain(codes_d, layout, *dims)])
    require_equal("supermer_pack main path", e)
    errs["supermer_pack"] = max(errs["supermer_pack"], e)
    gathered = int(layout.bases.sum())
    # In: the bases the runs cover, each once (a run's first k - 1 bases
    # may be the run before's last: runs ascend in flat order, so do their
    # ends), 20 B of rows a run (src, off, length) and the destinations'
    # bounds; out: the send tensor. Per gathered base a load, a mask, a
    # shift and an or; per word a binary search over the runs.
    starts, kmers = runs[0], runs[1]
    ends = starts + kmers.to(torch.int64) + (cfg.k - 1)
    covered = int(ends[-1] - starts[0]) - int(
        (starts[1:] - ends[:-1]).clamp(min=0).sum()) if r else 0
    pk_bound = bound(covered + 20 * r + 8 * layout.dest_begin.numel() + 4 * send.numel(),
                     4 * gathered + (gathered // 16) * 3 * max(r, 2).bit_length())
    pk = dict(
        ms=cuda_ms(lambda: sm_ops.pack_segments(codes_d, layout, *dims), 10),
        plain_ms=cuda_ms(lambda: sm_ops.pack_segments_plain(codes_d, layout, *dims), 3),
        bound_ms=pk_bound[0], bound_by=pk_bound[1], library_ms=None,
    )
    log_kernel(f"phase11 supermer_runs main path n={n} ({r} runs)", rt)
    log_kernel(f"phase11 supermer_pack main path {gathered} bases of {r} runs "
               f"({covered} distinct) into {send.numel()} words", pk)

    # The send tensors against the host encoder's on the same share.
    flat, flat_valid = fasta_io.flatten_for_device(codes, lens, cfg.k, cfg.pad_multiple)
    dest4 = minimizer.kmer_destinations(codes_d, cfg.k, cfg.m, sharded._num_buckets(cfg, 4))
    sizes = dispatch.bucket_sizes_device(dest4, valid, sharded._num_buckets(cfg, 4))
    assign4 = dispatch.balanced_assignment(sizes.cpu().numpy().astype(np.int64), 4)
    shard4 = torch.from_numpy(assign4.astype(np.int32)).to(dev)[dest4.to(torch.int64)]
    checked = []
    for num_dest, shard_d, ext in ((1, shard_of, False), (4, shard4, False),
                                   (4, shard4, True)):
        c = dataclasses.replace(cfg, extension=ext)
        rid0 = EXT_RID0 if ext else 0
        t0 = time.perf_counter()
        got = sr._device_send(codes_d, valid, shard_d, lens_d, c, num_dest, rid0, ext,
                              dev, None)[0]
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = sr._segments(sr._encode(flat, flat_valid, pipeline.to_host([shard_d])[0],
                                       c, num_dest, lens, rid0, ext), c, dev, None)[0]
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        if not torch.equal(got, want):
            raise AssertionError(f"phase 11: the send tensor of phase 2's reads at "
                                 f"{num_dest} destination(s), ext={ext}, differs from "
                                 f"the host encoder's")
        checked.append(f"S={num_dest}{' ext' if ext else ''} {tuple(got.shape)} "
                       f"device {t_dev * 1e3:.1f} ms, host {t_host * 1e3:.1f} ms")
        del got, want
    log(f"phase11 send tensors of phase 2's reads equal to the host encoder's: "
        f"{'; '.join(checked)}")
    wire_info = dict(supermers=r, bases=gathered, dims=dims)
    return {"supermer_runs": rt, "supermer_pack": pk}, wire_info


# The spans of one supermer call (runtime/timer.stage, in the order entered)
# that 11(a)'s stage line must show: the route's, nested as in
# supermer_route._supermer_step, and the wire feed's (pipeline.stage_wire).
SUPERMER_SPANS = (
    "pack", "feed", "wire feed", "staging", "host pack", "wire decode", "plan", "scan",
    "sizes", "sizes all_reduce", "encode", "destination ranks", "run table", "layout",
    "dims all_reduce", "segment pack", "step", "exchange", "receive decode + keybuild",
    "radix sort", "fused count", "result")


def phase11_stages(codes, lengths, cfg, range_traffic, wire_info) -> None:
    """11(a)'s call twice more under the route's own stage spans
    (runtime/timer.record_stages: each span ends with a synchronize), the
    second's line logged, with the wire bytes beside the range route's of
    9(a). Inside phase 11's one-rank group."""
    import dataclasses

    from hysortk_tpu_torch.parallel import exchange
    from hysortk_tpu_torch.parallel import pipeline as sharded
    from hysortk_tpu_torch.runtime import timer

    sm = dataclasses.replace(cfg, routing="supermer")
    for _ in range(2):
        exchange.reset_traffic()
        t0 = time.perf_counter()
        with timer.record_stages() as seconds:
            sharded.count_reads_sharded(codes, lengths, sm)
        wall = time.perf_counter() - t0
    missing = [name for name in SUPERMER_SPANS if name not in seconds]
    if missing:
        raise AssertionError(f"phase 11(a)'s call entered no {missing} span")
    if "heavy pre-count" in seconds:
        raise AssertionError("phase 2's reads flagged a heavy bucket")
    h2d = seconds["wire feed"] - seconds["staging"] - seconds["host pack"]
    log(f"phase11a stages of one supermer call under its spans, second of two (wall "
        f"{wall * 1e3:.1f} ms), ms: "
        + "; ".join(f"{name} {sec * 1e3:.1f}" for name, sec in seconds.items())
        + f"; H2D (wire feed less staging and host pack) {h2d * 1e3:.1f}")
    supermers, bases, dims = (wire_info[key] for key in ("supermers", "bases", "dims"))
    payload = -(-bases // 4) + 4 * supermers
    log(f"phase11a wire: {supermers} supermers, {payload} B of supermer payload "
        f"(2 bits a base + 4 B a supermer), {exchange.traffic['bytes_sent']} B sent "
        f"(segments padded to {dims[0]} bases, lmax {dims[1]}); the range route's "
        f"9(a): {range_traffic['bytes_sent']} B sent")


def phase11_heavy_stage(codes, lengths, cfg) -> None:
    """The device heavy pre-count timed on 11(c)'s first reads as one rank
    holding all of them sees them under four ranks' buckets (on one rank's
    three buckets the poly-A bucket is not heavy), against the host
    pre-count on the same inputs. Inside phase 11's one-rank group."""
    import torch

    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.io import fasta as fasta_io
    from hysortk_tpu_torch.ops import minimizer, wire
    from hysortk_tpu_torch.parallel import dispatch
    from hysortk_tpu_torch.parallel import pipeline as sharded
    from hysortk_tpu_torch.parallel import supermer_route as sr

    dev = torch.device("cuda", torch.cuda.current_device())
    lens = lengths.astype(np.int32)
    packed, lens_d, n = pipeline.wire_batch(codes, lens, cfg, dev)
    codes_d, valid = wire.decode_block(packed, lens_d, cfg.k, n)
    nb = sharded._num_buckets(cfg, 4)
    dest = minimizer.kmer_destinations(codes_d, cfg.k, cfg.m, nb)
    sizes = dispatch.bucket_sizes_device(dest, valid, nb).cpu().numpy().astype(np.int64)
    types = dispatch.classify(sizes, cfg.heavy_ratio)
    if not (types == dispatch.HEAVY).any():
        raise AssertionError("phase 11(c)'s reads flagged no heavy bucket on 12 buckets")
    assign = dispatch.balanced_assignment(np.where(types == dispatch.HEAVY, 0, sizes), 4)
    assign_d = torch.from_numpy(assign.astype(np.int32)).to(dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_valid, got = sr.heavy_precount_device(codes_d, valid, dest, types, assign_d,
                                                  cfg.k, 4)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    flat, flat_valid = fasta_io.flatten_for_device(codes, lens, cfg.k, cfg.pad_multiple)
    t0 = time.perf_counter()
    want_valid, want = sr.heavy_precount(flat, flat_valid, pipeline.to_host([dest])[0],
                                         types, assign, cfg.k, 4, dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(pipeline.to_host([got_valid])[0], want_valid) or not all(
            np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            for g, w in zip(got, want)):
        raise AssertionError("phase 11: the device heavy pre-count differs from the host's")
    log(f"phase11 heavy pre-count on {int(codes.size)} bases, {int(sizes.sum())} k-mers, "
        f"{int(sizes[types == dispatch.HEAVY].sum())} in heavy buckets, "
        f"{sum(g[0].shape[0] for g in got)} distinct heavy keys: device "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms, the host pre-count {host_ms:.1f} ms, "
        f"equal")


def heavy_reads(codes, lengths, n_bases):
    """11(c)'s reads: the first `n_bases` bases (whole reads), then poly-A
    reads of the same length making POLY_A_SHARE of the k-mers. Returns
    (codes, lengths, the poly-A k-mers)."""
    n_reads = n_bases // READ_LEN
    sub_codes, sub_lengths = codes[: n_reads * READ_LEN], lengths[:n_reads]
    n_poly = int(sub_lengths.size * POLY_A_SHARE / (1 - POLY_A_SHARE))
    poly = np.zeros(n_poly * READ_LEN, dtype=sub_codes.dtype)  # A codes as 0
    return (np.concatenate([sub_codes, poly]),
            np.concatenate([sub_lengths, np.full(n_poly, READ_LEN, sub_lengths.dtype)]),
            n_poly * (READ_LEN - K + 1))


def phase11_supermer(workdir, codes, lengths, one_shot, ext_sub_one_shot,
                     range_traffic, errs) -> tuple[dict, dict]:
    """Supermer routing on phase 2's reads and configuration: the hard
    cases, the send side's kernels, then (a)-(e) of the docstring, every
    result exactly equal to its reference. Returns the send-side kernels'
    measurements and 11(a)'s first call's launches."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from hysortk_tpu_torch.io import native
    from hysortk_tpu_torch.parallel import group

    cfg = slice_config()
    base = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    sm = dict(base, routing="supermer")
    heavy_f = dict(sm, upper=65535)  # the most U may be: 11(c)'s two cases
    ext = dict(sm, extension=True)
    rid0 = dict(read_id_offset=EXT_RID0)
    needed = CORE_KERNELS + SUPERMER_KERNELS
    stream_needed = needed + ("merge_runs", "run_length_sum")
    sub_codes, sub_lengths = ext_stream_reads(codes, lengths)
    h_codes, h_lengths, poly_kmers = heavy_reads(codes, lengths, EXT_STREAM_BASES)
    hk_codes, hk_lengths, kept_kmers = heavy_reads(codes, lengths, HEAVY_KEPT_BASES)

    t_phase = time.perf_counter()
    group.init("file://" + os.path.join(workdir, "rendezvous-11"), 0, 1, "cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"one rank with its own card took {dist.get_backend()}")
        phase11_hard_cases()
        phase11_send_cases(errs)
        times, wire_info = phase11_kernels(codes, lengths, cfg, errs)
        torch.cuda.empty_cache()
        native.reset_calls()
        a = phase10_call("count_reads_sharded", codes, lengths, sm)
        walls = list(a["walls"])
        for _ in range(2):
            walls += phase10_call("count_reads_sharded", codes, lengths, sm)["walls"]
        require_same_result("phase 11(a)", a.pop("result"), one_shot)
        a.update(backend="nccl", walls=walls)
        log_phase10("a", f"count_reads_sharded, routing supermer, {int(codes.size)} "
                    f"bases (walls {', '.join(f'{w:.4f}' for w in walls)} s; the first "
                    f"call's line)", [a], len(one_shot[0]), needed, 11)
        if a["launches"]["keybuild"] < 2:
            raise AssertionError("phase 11(a) did not build the m-mer words by the kernel")
        phase11_stages(codes, lengths, cfg, range_traffic, wire_info)
        # The send side ran on the card: the host library packed the wire
        # feed and found no run boundary and gathered no run.
        if (native.calls["run_boundaries"] or native.calls["gather_runs"]
                or not native.calls["pack_2bit"]):
            raise AssertionError(f"phase 11(a) ran the host encoder or fed no wire: "
                                 f"host library calls {native.calls}")
        log(f"phase11a host library calls in the three calls and the stage line: "
            f"{json.dumps(native.calls)}")
        torch.cuda.empty_cache()
        phase11_heavy_stage(h_codes, h_lengths, dataclasses.replace(cfg, upper=65535))
        torch.cuda.empty_cache()
        h_ref = phase10_call("count_reads_sharded", h_codes, h_lengths,
                             dict(heavy_f, routing="range"))["result"]
        hk_ref = phase10_call("count_reads_sharded", hk_codes, hk_lengths,
                              dict(heavy_f, routing="range"))["result"]
        if not kept_kmers <= hk_ref[0].counts.max() <= heavy_f["upper"]:
            raise AssertionError("phase 11(c) second case: the poly-A key is not kept")
        d = phase10_call("count_reads_sharded_ext", sub_codes, sub_lengths, ext, (), rid0)
        got = d.pop("result")
        require_same_ext("phase 11(d) one rank", got, ext_sub_one_shot)
        del got
        d["backend"] = "nccl"
        log_phase10("d", "count_reads_sharded_ext, routing supermer, 2^24 bases",
                    [d], len(ext_sub_one_shot[0]), needed, 11)
        torch.cuda.empty_cache()
        e = phase10_call("count_reads_sharded_streaming", codes, lengths, sm,
                         (STREAM_BATCH,))
        require_same_result("phase 11(e) one rank", e.pop("result"), one_shot)
        e["backend"] = "nccl"
        log_phase10("e", f"count_reads_sharded_streaming, routing supermer, "
                    f"{int(codes.size)} bases in batches of {STREAM_BATCH}", [e],
                    len(one_shot[0]), stream_needed, 11)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    inputs = {}
    for name, (c_, l_) in (("all", (codes, lengths)), ("sub", (sub_codes, sub_lengths)),
                           ("heavy", (h_codes, h_lengths)),
                           ("heavy_kept", (hk_codes, hk_lengths))):
        inputs[name] = os.path.join(workdir, f"phase11-{name}.npz")
        np.savez(inputs[name], codes=c_, lengths=l_)
    spawns = {
        4: [  # (tag, what, entry, inputs, cfg, args, kwargs, reference, kernels)
            ("c", f"heavy pre-count, 2^24 bases + {poly_kmers} poly-A k-mers",
             "count_reads_sharded", "heavy", heavy_f, (), {}, h_ref, needed),
            ("c", f"heavy pre-count, 2^17 bases + {kept_kmers} poly-A k-mers, the "
             "poly-A key kept", "count_reads_sharded", "heavy_kept", heavy_f, (), {},
             hk_ref, needed),
            ("b", "count_reads_sharded, routing supermer, 2^26 bases",
             "count_reads_sharded", "all", sm, (), {}, one_shot, needed),
        ],
        2: [
            ("d", "count_reads_sharded_ext, routing supermer, 2^24 bases",
             "count_reads_sharded_ext", "sub", ext, (), rid0, ext_sub_one_shot, needed),
            ("d", "count_reads_sharded_ext_streaming, routing supermer, 2^24 bases in "
             "batches of 2^22", "count_reads_sharded_ext_streaming", "sub", ext,
             (EXT_STREAM_BATCH,), rid0, ext_sub_one_shot, needed + STREAMING_KERNELS),
            ("e", "count_reads_sharded_streaming, routing supermer, 2^26 bases in "
             "batches of 2^24", "count_reads_sharded_streaming", "all", sm,
             (STREAM_BATCH,), {}, one_shot, stream_needed),
        ],
    }

    def check(tag, stats):
        no_host_merge(11, tag, stats)
        if any(st["calls"]["_supermer_step"] < 1 for st in stats):
            raise AssertionError(f"phase 11({tag}) did not take the supermer step")
        if tag == "c" and any(st["calls"]["heavy_precount_device"] != 1 for st in stats):
            raise AssertionError("phase 11(c) flagged no heavy bucket")
        if any(st["calls"]["heavy_precount"] for st in stats):
            raise AssertionError(f"phase 11({tag}) ran the host heavy pre-count")

    sub_rows = ext_occurrence_rows(ext_sub_one_shot[0])
    run_spawned(workdir, 11, spawns, inputs, ext_sub_one_shot, sub_rows, check)
    del sub_rows
    log(f"phase11 {time.perf_counter() - t_phase:.1f} s in all")
    return times, a["launches"]


# --------------------------------------------------------------------------
# Phase 12

CLI_BOUNDS = ["-k", str(K), "-m", str(M), "-l", str(LOWER), "-u", str(UPPER)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli_processes(fasta: str, out_dir: str, n: int, flags: list) -> tuple[str, list]:
    """python -m hysortk_tpu_torch.cli as n processes joined at --coordinator
    on this host, all on this card, each with its share of the host's cores
    as torch's thread count (which the host library takes): rank 0's
    standard output and each process's wall, start to exit."""
    import torch

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // n)))
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hysortk_tpu_torch.cli", fasta, out_dir, *CLI_BOUNDS,
         "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(r), *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs, walls = [], []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=400)
            walls.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"phase 12 process {r} exited {proc.returncode}:\n"
                                     f"{out[-2000:]}\n{err[-4000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs[0], walls


def sorted_lines(paths) -> list:
    """Every `kmer\tcount` line of the files, sorted; a file without one
    fails (every rank owns a share)."""
    lines = []
    for path in paths:
        with open(path, "rb") as f:
            part = f.read().splitlines()
        if not part:
            raise AssertionError(f"{path} holds no k-mer")
        lines += part
    lines.sort()
    return lines


def histogram_block(text: str) -> str:
    start = text.index("#count")
    return text[start: text.index("\n\n", start) + 2]


def phase12_run(tag: str, what: str, fasta: str, out_root: str, n: int, flags: list,
                want_lines: list, want_hist: str, kernels: tuple, backend: str) -> None:
    """One multi-process CLI run: the union of its <rank>.out files equal
    to the reference's lines (so the shares are disjoint), its histogram to
    the reference's, every rank's kernels launched; every rank's line
    logged."""
    out_dir = os.path.join(out_root, tag)
    out, walls = run_cli_processes(fasta, out_dir, n, flags)
    if f"{n} processes ({backend})" not in out:
        raise AssertionError(f"phase 12({tag}) did not join {n} processes over {backend}")
    ranks = [line for line in out.splitlines() if line.startswith("[proc ")]
    if len(ranks) != n:
        raise AssertionError(f"phase 12({tag}): {len(ranks)} rank lines of {n}")
    for r, line in enumerate(ranks):
        launches = json.loads(line[line.index("launches ") + len("launches "):])
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"phase 12({tag}) rank {r} launched no {missing}")
        log(f"phase12{tag} {line}; process wall {walls[r]:.2f} s")
    got = sorted_lines([os.path.join(out_dir, f"{r}.out") for r in range(n)])
    if got != want_lines:
        raise AssertionError(f"phase 12({tag}): the union of {n} shares ({len(got)} "
                             f"lines) is not the reference's ({len(want_lines)})")
    if histogram_block(out) != want_hist:
        raise AssertionError(f"phase 12({tag}): the histogram differs")
    log(f"phase12{tag} {what}: {n} processes over {backend}, {len(got)} k-mers in "
        f"{n} disjoint shares, their union and the histogram equal to the reference")
    shutil.rmtree(out_dir, ignore_errors=True)


def phase12_multiprocess(workdir: str, one_shot, ext_one_shot) -> None:
    """The CLI's multi-process run on phase 2's FASTA: (a) two processes
    sharing the card over gloo, (b) one process over NCCL, (c) supermer
    routing on two processes, each against phase 2; (d) extension mode
    streamed in batches of STREAM_BATCH on two processes against phase
    8(a)'s one-shot extension result."""
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.io import writer

    t_phase = time.perf_counter()
    fasta = os.path.join(workdir, "reads.fa")
    want_lines = sorted_lines([os.path.join(workdir, "out", "0.out")])
    want_hist = writer.format_histogram(one_shot[1])
    range_kernels = CORE_KERNELS + ("mix_keys",)
    phase12_run("a", "range, one-shot", fasta, workdir, 2, [], want_lines, want_hist,
                range_kernels, "gloo")
    phase12_run("b", "range, one-shot", fasta, workdir, 1, [], want_lines, want_hist,
                range_kernels, "nccl")
    phase12_run("c", "supermer routing, one-shot", fasta, workdir, 2,
                ["--routing", "supermer"], want_lines, want_hist,
                CORE_KERNELS + SUPERMER_KERNELS, "gloo")
    del want_lines

    ext_kl, ext_hist = ext_one_shot
    want_ext = sorted(writer.format_output_lines(
        ht.KmerList(ext_kl.keys, ext_kl.counts, K)).splitlines())
    phase12_run("d", f"extension mode streamed in batches of {STREAM_BATCH}", fasta,
                workdir, 2, ["--extension", "--stream-batch-bases", str(STREAM_BATCH)],
                want_ext, writer.format_histogram(ext_hist), range_kernels + STREAMING_KERNELS,
                "gloo")
    log(f"phase12 {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# The copy-out: where a result's time goes between the card and the host


def empty_host_cache() -> bool:
    """Return torch's cached pinned blocks to CUDA, so that the next pinned
    allocation misses the cache; False where this torch has no such call."""
    import torch

    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return True
    return False


def pinned_footprint() -> dict:
    """The page-locked bytes of this process: the copy-out ring's blocks
    against its cap, and torch's whole pinned pool (the ring, the feed's
    staging blocks, the host-held merge's uploads, gloo's exchange
    staging), where torch.cuda.host_memory_stats gives it."""
    import torch

    from hysortk_tpu_torch import pipeline

    pool = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return {"ring": pipeline.RING.nbytes, "cap": pipeline.RING.cap,
            "torch_pinned_pool": pool.get("allocated_bytes.current")}


def host_facts() -> dict:
    """The host's transparent huge page modes and thread counts."""
    import torch

    thp = {}
    for what in ("enabled", "defrag"):
        try:
            with open(f"/sys/kernel/mm/transparent_hugepage/{what}") as f:
                thp[what] = f.read().strip()
        except OSError as e:
            thp[what] = f"unreadable: {e.strerror}"
    return {"thp": thp, "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads()}


def _rate(nbytes: int, ms: float) -> dict:
    return {"ms": round(ms, 4), "GB/s": round(nbytes / ms / 1e6, 3) if ms > 0 else None}


def former_to_host(t):
    """The copy-out before the ring (kept here for the turns below): the
    whole array into one pinned block from torch's cache, a synchronous
    D2H, then torch's host copy into a fresh torch.empty."""
    import torch

    stage = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stage.copy_(t)
    return torch.empty(t.shape, dtype=t.dtype).copy_(stage).numpy()


def copy_out_breakdown(arrays: dict, reps: int = 3) -> dict:
    """Where the copy-out of a result's arrays (name -> CUDA tensor) goes,
    per array, the median of `reps` in ms and GB/s: (v) a pinned
    allocation of the array's size when torch's pinned cache misses (one
    run, after emptying it), (i) the D2H alone into that block by CUDA
    events, (ii) the host copy from it into a destination already touched,
    (iii) the same into a fresh torch.empty, (iv) into a fresh np.empty
    (the ring's destination) and (vi) into a fresh anonymous mapping made
    present by MAP_POPULATE, the mmap call included (fresh: each run's
    destination is kept alive until all runs are done, so none reuses
    another's pages), and the port's copy-out of the array alone
    (pipeline.to_host); then the whole result in one copy-out, and the
    same result by the port's copy-out, by a ring of 16 MiB pieces and by
    the former copy-out (former_to_host, an array a call) in turns,
    `2 * reps` each, every result dropped before the next, as a caller
    drops it. Every copy is
    checked equal to the array."""
    import mmap

    import torch

    from hysortk_tpu_torch import pipeline

    def median_ms(run):
        times, kept = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept.append(run())
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), kept

    def populated(shape, dtype):
        nbytes = max(1, int(np.prod(shape)) * np.dtype(dtype).itemsize)
        region = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                           | mmap.MAP_POPULATE)
        return np.frombuffer(region, np.uint8)[:nbytes].view(dtype).reshape(shape)

    out = {}
    for name, t in arrays.items():
        flat = t.reshape(-1)
        nbytes = flat.numel() * flat.element_size()
        want = flat.cpu().numpy()
        row = {"bytes": nbytes, "dtype": str(flat.dtype).replace("torch.", "")}
        missed = empty_host_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        alloc_ms = (time.perf_counter() - t0) * 1e3
        row["v_pinned_alloc"] = _rate(nbytes, alloc_ms) if missed else None
        d2h = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pinned.copy_(flat, non_blocking=True)
            end.record()
            end.synchronize()
            d2h.append(start.elapsed_time(end))
        row["i_d2h_pinned"] = _rate(nbytes, float(np.median(d2h)))
        touched = torch.empty(flat.shape, dtype=flat.dtype)
        touched.copy_(pinned)
        ms, _ = median_ms(lambda: touched.copy_(pinned))
        row["ii_host_copy_touched"] = _rate(nbytes, ms)
        ms, kept = median_ms(lambda: torch.empty(flat.shape, dtype=flat.dtype).copy_(pinned))
        row["iii_host_copy_fresh_torch_empty"] = _rate(nbytes, ms)
        kept = [k.numpy() for k in kept + [touched]]
        for what, empty in (("iv_host_copy_fresh_np_empty", np.empty),
                            ("vi_host_copy_fresh_map_populate", populated)):
            ms, got = median_ms(lambda: torch.from_numpy(
                empty(tuple(flat.shape), want.dtype)).copy_(pinned).numpy())
            row[what] = _rate(nbytes, ms)
            kept += got
        ms, got = median_ms(lambda: pipeline.to_host([t])[0].reshape(-1))
        row["copy_out"] = _rate(nbytes, ms)
        if not all(np.array_equal(k, want) for k in kept + got):
            raise AssertionError(f"copy-out breakdown: {name} copied unequal")
        del kept, got, touched, pinned
        out[name] = row
    total = sum(r["bytes"] for r in out.values())
    tensors = list(arrays.values())
    ms, kept = median_ms(lambda: pipeline.to_host(tensors))
    del kept
    small = pipeline.CopyRing(16 << 20)
    runs = {"port": pipeline.to_host,
            "ring of 16 MiB pieces": lambda ts: small.copy_out(ts, [None] * len(ts)),
            "former": lambda ts: [former_to_host(x) for x in ts]}
    turns = {who: [] for who in runs}
    for turn in range(2 * reps):
        for who in list(runs) if turn % 2 == 0 else list(runs)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = runs[who](tensors)
            turns[who].append((time.perf_counter() - t0) * 1e3)
            del got
    out["whole result, one copy-out"] = {
        "bytes": total, "copy_out": _rate(total, ms),
        "in_turns_ms": {who: {"median": round(float(np.median(v)), 4),
                              "runs": [round(x, 4) for x in v]}
                        for who, v in turns.items()}}
    empty_host_cache()
    return out


def copy_out_phase(one_shot, ext_one_shot, footprints: dict) -> dict:
    """The copy-out's breakdown (copy_out_breakdown) on phase 2's result
    (key rows, counts narrowed to uint8 as compact_keys sends them) and
    8(c)'s (keys, counts, read ids, positions; equal to 8(a)'s), uploaded
    to the card as the device result was; the host's huge page modes and
    threads; the pinned footprints after phases 2, 8 and 12, each at or
    under the ring's cap."""
    import torch

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    kl = one_shot[0]
    phase2 = {"keys": card(kl.keys.view(np.int32)), "counts": card(kl.counts.astype(np.uint8))}
    ext = ext_one_shot[0]
    ext_arrays = {"keys": card(ext.keys.view(np.int32)), "counts": card(ext.counts),
                  "occ_rid": card(ext.occ_rid), "occ_pos": card(ext.occ_pos.view(np.int32))}
    for when, fp in footprints.items():
        if fp["ring"] > fp["cap"]:
            raise AssertionError(f"copy-out ring {when}: {fp['ring']} B pinned, over its "
                                 f"cap of {fp['cap']} B")
    record = {"copy_out": {
        "host": host_facts(), "pinned_footprint": footprints,
        "phase2": copy_out_breakdown(phase2), "phase8c": copy_out_breakdown(ext_arrays)}}
    log(f"copy-out: ring {footprints['after phase 12']['cap']} B cap, pinned footprints "
        f"{json.dumps(footprints)}; host {json.dumps(record['copy_out']['host'])}")
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import hysortk_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase0_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = phase1_synthetic(gen)
    torch.cuda.empty_cache()

    scratch_root = os.path.join(ROOT, "build")
    os.makedirs(scratch_root, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch_root)
    try:
        codes, lengths, launches, one_shot, peak, best_wall = phase2_slice(workdir, rng)
        footprints = {"after phase 2": pinned_footprint()}
        phase2_host_functions(workdir, codes, lengths, one_shot)
        torch.cuda.empty_cache()
        times = phase1_main_path(codes, lengths, errs)
        fasta, reads = phase3_small(workdir, rng)
        stream_launches, stream_times = phase4_streaming(
            codes, lengths, one_shot, peak, errs)
        phase4_drains(codes, lengths, one_shot)
        phase5_cli(workdir, fasta, reads)
        torch.cuda.empty_cache()
        fused_launches, fused_wall = phase6_fused_sort(codes, lengths, one_shot)
        log(f"phase6 best wall {fused_wall:.4f} s beside phase 2's {best_wall:.4f} s")
        roll_launches = phase7_roll(codes, lengths, one_shot)
        torch.cuda.empty_cache()
        ext_one_shot, ext_sub_one_shot = phase8_extension(
            workdir, codes, lengths, one_shot, peak, fasta, reads, errs)
        footprints["after phase 8"] = pinned_footprint()
        torch.cuda.empty_cache()
        sharded_launches, sub_one_shot, range_traffic = phase9_sharded(
            workdir, codes, lengths, one_shot)
        torch.cuda.empty_cache()
        phase10_sharded(workdir, codes, lengths, one_shot, ext_one_shot, sub_one_shot,
                        ext_sub_one_shot)
        torch.cuda.empty_cache()
        supermer_times, supermer_launches = phase11_supermer(
            workdir, codes, lengths, one_shot, ext_sub_one_shot, range_traffic, errs)
        torch.cuda.empty_cache()
        phase12_multiprocess(workdir, one_shot, ext_one_shot)
        footprints["after phase 12"] = pinned_footprint()
        copy_out = copy_out_phase(one_shot, ext_one_shot, footprints)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    times.update(stream_times)
    times.update(supermer_times)
    for name in SUPERMER_KERNELS:
        launches[name] = supermer_launches[name]
    for name in STREAMING_KERNELS:
        launches[name] = stream_launches[name]
    launches["fused_sort"] = fused_launches["fused_sort"]
    launches["block_sort"] = roll_launches["block_sort"]
    launches["mix_keys"] = sharded_launches["mix_keys"]

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], **times[name]}
        for name in KERNELS
    ]}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps(copy_out))
    log(smi)  # again beside the record: the card every number above ran on
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
