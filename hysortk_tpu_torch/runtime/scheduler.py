"""Streaming device-batch scheduler: bounded device memory whatever the
input size.

The port of hysortk_tpu/runtime/scheduler.py. The
reference bounds memory by exchanging fixed-size rounds (MAX_SEND_BATCH,
src/kmerops.cpp:587-1007). Here the *input* streams: reads are processed in
device batches of a fixed base budget; each batch is counted unfiltered (a
per-batch combiner pass producing compacted {key, partial_count} lists,
the reference's ScatteredKmerList idea, src/kmerops.cpp:363-417), and the
partial lists are merged in a final device pass: a merge of sorted runs
(ops/merge.py) + a weighted run-length sum (ops/run_length_sum.py), the
analogue of count_sorted_kmerlist, src/kmerops.cpp:1447-1476.

The stages carry trace spans (`stream/pack`: the pack into pinned staging
and its copy to the device queued, `stream/count_batch`,
`stream/consolidate`, `stream/final_merge`; runtime/profiling.annotate)
that a torch.profiler trace sums by name.

Partials are held on the host by default. Under cfg.device_compact they
stay on the device as sorted sentinel-padded runs, folded together every
`group` batches, and only the final filtered result crosses to the host.

Extension mode streams the same batches (count_reads_streaming_ext): each
runs the extension pipeline unfiltered, the per-batch (key, count,
occurrences) partials stay on the device and merge there once
(ExtPartialStore, shared with the sharded and multi-process extension
streams), draining to the host merge only past the memory budget or on
running out of device memory.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..config import KmerConfig
from ..ops import count as count_ops
from ..ops import merge as merge_ops
from ..ops import run_length_sum as sum_ops
from ..pipeline import (
    UNFILTERED as _UNFILTERED,
    ExtPartial,
    KmerList,
    KmerListExt,
    _count_device_ext_packed,
    _count_device_packed,
    _count_device_packed_compact,
    ascending_partial,
    compact_keys,
    ext_partial,
    feed_wire,
    host_histogram,
    kept_result,
    kept_slots,
    merge_ext_partials,
    merge_ext_partials_device,
    pull_prefix,
    resolve_device,
    to_device,
)
from . import memcheck
from .profiling import annotate

_LOG = logging.getLogger("hysortk_tpu_torch.stream")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def read_batch_spans(
    lengths: np.ndarray, batch_bases: int
) -> list[tuple[int, int]]:
    """Read-index spans of ~batch_bases whole-read batches (one searchsorted
    per batch over the base prefix sums)."""
    cum = np.cumsum(lengths.astype(np.int64))
    n = lengths.size
    spans = []
    start = 0
    base0 = 0
    while start < n:
        end = int(np.searchsorted(cum, base0 + batch_bases, side="right"))
        if end == start:  # single read larger than the budget
            end = start + 1
        spans.append((start, end))
        base0 = int(cum[end - 1])
        start = end
    return spans


def iter_read_batches(
    codes: np.ndarray,
    lengths: np.ndarray,
    batch_bases: int,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Split (codes, lengths) into batches of whole reads, ~batch_bases each."""
    offsets = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    for start, end in read_batch_spans(lengths, batch_bases):
        yield (
            codes[offsets[start] : offsets[end]],
            lengths[start:end],
        )


def snap_batch_to_pow2_flat(batch_bases: int, pad_multiple: int) -> int:
    """Largest batch_bases <= the given one whose flattened device size
    (ceil((n+16)/pad)*pad) is EXACTLY a power of two.

    Kept so that this package cuts the same batches as the JAX package
    (whose sorts pad to a power of two) and because device-resident runs
    need a power-of-two run length (ops/merge.py).
    """
    # Pick the pow2 from batch_bases+16 itself, NOT from the padded size:
    # a pow2 inside (batch+16, padded] would yield flat-16 > batch_bases,
    # overshooting the (memory-derived) budget the caller handed in.
    flat = 1 << (max(int(batch_bases) + 16, 2).bit_length() - 1)
    if flat % pad_multiple or flat <= 16:
        return int(batch_bases)  # non-pow2 pad granularity: no snap
    return flat - 16


def suggest_batch_bases(cfg: KmerConfig, device) -> int:
    """Pick a streaming batch size from the device's memory headroom.

    The analogue of the reference's sort_decision (src/kmerops.cpp:1344-1379),
    which sizes its sorter from 90% of MemFree: the device pipeline needs
    roughly codes(4) + 2 x W key words x 4 (pre/post sort) + counts/masks
    bytes per base, with 2x slack for temporaries. The result is snapped so
    the flattened batch is exactly a power of two."""
    per_base = 4 + 2 * cfg.words * 4 + 8
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        batch = 1 << 26
    else:
        batch = int(headroom / (2 * per_base))
        batch = max(min(batch, 1 << 28), 1 << 20)
    return snap_batch_to_pow2_flat(batch, cfg.pad_multiple)


def suggest_pipe_depth(
    batch_elems: int, words: int, device, max_depth: int = 8
) -> int:
    """How many batches may stay in flight before a sync.

    Each in-flight batch holds its outputs alive (W key words + count +
    keep, ~(words + 2) x flat x 4 B) and the batch currently executing
    needs ~3x that for its sort. Depth therefore scales down with key width
    (the depth analogue of suggest_batch_bases)."""
    per_batch = (words + 2) * max(batch_elems, 1) * 4
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        return min(2, max_depth)
    d = int((headroom - 4 * per_batch) // per_batch)
    return max(1, min(d, max_depth))


# Device bytes that merge_ext_partials_device takes beyond the partials it
# merges, per byte held (ExtPartialStore's budget): the rows' concatenation,
# the run merge's output and ping-pong buffer, the sum's totals, the
# occurrences' concatenation, the gather's int64 index and its output.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 8(c)):
# 3.57x at 2^26 bases in batches of 2^24 (678 MiB held), 3.99x at 2^24 in
# batches of 2^22; 6 keeps a margin.
EXT_MERGE_FACTOR = 6.0


class ExtPartialStore:
    """The per-batch extension-mode partials of one streamed call, held on
    their device (pipeline.ExtPartial, made ascending as they arrive) and
    merged there once (pipeline.merge_ext_partials_device).

    The budget: a partial is held while EXT_MERGE_FACTOR x the bytes held
    with it fits the device's headroom (memcheck.hbm_headroom_bytes, as
    _consolidation_group_size sizes its group; no budget on the CPU) and
    the occurrences held stay below 2^31. The drain: when a partial would
    not fit, or the device merge raises torch.cuda.OutOfMemoryError
    (nothing wider: a failed kernel build or launch ends the run), the held
    partials go to the host (`to_host`), every later partial goes there
    too, and the host merge (pipeline.merge_ext_partials) finishes, with a
    logged warning. Nothing else takes the host merge."""

    def __init__(self, cfg: KmerConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.held: list[ExtPartial] = []
        self.drained: list[KmerListExt] | None = None  # the host's, after a drain

    def held_bytes(self) -> int:
        return sum(p.nbytes for p in self.held)

    def _fits(self, part: ExtPartial) -> bool:
        if sum(p.n_occ for p in self.held) + part.n_occ >= 2**31:
            return False
        headroom = memcheck.hbm_headroom_bytes(self.device)
        need = EXT_MERGE_FACTOR * (self.held_bytes() + part.nbytes)
        return headroom is None or need <= headroom

    def _drain(self) -> None:
        t0 = time.perf_counter()
        nbytes = self.held_bytes()
        self.drained = (self.drained or []) + [p.to_host(self.cfg.k) for p in self.held]
        self.held.clear()
        _LOG.warning("extension partials drained to the host: %.1f MB in %.2fs; the "
                     "host merge finishes", nbytes / 1e6, time.perf_counter() - t0)

    def add(self, part: ExtPartial) -> None:
        """Hold one batch's partial on the store's device (copied there where
        it lies elsewhere, as a gloo gather leaves it; sorted first where it
        is not ascending), or send it to the host after a drain."""
        if self.drained is None:
            part = part.to(self.device)
            if not self._fits(part):
                _LOG.warning("extension partials: %d held and the next would pass the "
                             "device budget; draining to the host", len(self.held))
                self._drain()
        if self.drained is not None:
            self.drained.append(part.to_host(self.cfg.k))
        else:
            self.held.append(ascending_partial(part))

    def result(self) -> tuple[KmerListExt, np.ndarray]:
        """The merged, filtered list and its histogram over [0, cfg.upper]."""
        if self.drained is None:
            try:
                return merge_ext_partials_device(self.held, self.cfg)
            except torch.cuda.OutOfMemoryError:
                # The held partials are unmodified; the drain runs outside
                # this handler, where the failed merge's frames are gone.
                _LOG.warning("device merge of extension partials ran out of device "
                             "memory; draining to the host")
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self._drain()
        merged = merge_ext_partials(self.drained, self.cfg.lower, self.cfg.upper,
                                    self.cfg.k, self.cfg.words)
        return merged, host_histogram(merged.counts, self.cfg.upper)


def count_reads_streaming_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    read_id_offset: int = 0,
    device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Bounded-memory extension-mode counting on one device: each device
    batch runs the extension pipeline UNFILTERED, its (key, count,
    occurrences) partial stays on the device (pipeline.ext_partial), and
    the partials merge there once (ExtPartialStore) with the [L, U] filter
    applied to the merged totals only, the reference's EXT-indifferent
    bounded round loop (src/kmerops.cpp:906-1007). Peak device memory is set
    by batch_bases and the held partials. Read ids count from
    read_id_offset across the batches."""
    dev = resolve_device(device)
    snapped = snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple)
    if 0 < snapped <= batch_bases:
        batch_bases = snapped
    target = -(-(batch_bases + 16) // cfg.pad_multiple) * cfg.pad_multiple
    spans = read_batch_spans(lengths, batch_bases)
    lmax = max((end - start for start, end in spans), default=1)

    store = ExtPartialStore(cfg, dev)
    rid_off = read_id_offset
    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        # 2-bit wire feed; (rid, pos) are derived on the device from the
        # read lengths, zero-padded to the longest batch's read count.
        n = target
        if b_codes.size + 16 > target:
            n = -(-(b_codes.size + 16) // cfg.pad_multiple) * cfg.pad_multiple
        packed, lens = feed_wire(b_codes, b_lengths, n, dev, max(lmax, 1))
        outs = _count_device_ext_packed(packed, lens, rid_off, cfg.k, n, *_UNFILTERED)
        del packed, lens
        store.add(ext_partial(*outs))
        del outs
        rid_off += b_lengths.size
    return store.result()


def _consolidation_group_size(target: int, words: int, device) -> int:
    """How many run_len-slot runs the device-resident accumulator may hold.

    Per-batch compacted partials stay in device memory; whenever `group`
    runs have accumulated, a consolidation cycle (merge + duplicate-sum +
    compact, all on the device) folds them into ceil(union/run_len) runs.
    The transient peak of a cycle is about the held runs + their
    concatenation + the merge's buffers + the summed and compacted output,
    budgeted as 4.5x the held bytes: group = headroom // (4.5 x run_len x
    (words+1) x 4 B), rounded down to a power of two and capped at 8.
    Returns 0 to disable device-resident accumulation (host-held partials):
    always on the CPU.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 4b:
    17 batches, run_len 2^22, W=2, group 8, so 403 MB held): the whole
    stream peaked at 1.139 GiB of device memory, 3.0x the held bytes, so
    4.5x keeps a margin.

    HYSORTK_DEVICE_RESIDENT_GROUP overrides the rule.
    """
    forced = os.environ.get("HYSORTK_DEVICE_RESIDENT_GROUP")
    if forced is not None:
        return int(forced)
    per_run = target * (words + 1) * 4
    headroom = memcheck.hbm_headroom_bytes(device)
    if headroom is None:
        return 0
    g = int(headroom // int(4.5 * per_run))
    if g < 2:
        return 0
    return 1 << min(g.bit_length() - 1, 3)


def _run_length_sum_auto(words_s, pay):
    """Weighted run-length sum, dispatched on the tensors' device: the CUDA
    kernel on the card, its plain version on the CPU (both inside
    ops/run_length_sum.run_length_sum_fused)."""
    return sum_ops.run_length_sum_fused(list(words_s), pay)


def _concat_runs(parts_words, parts_cnts, words, run_len, pad_runs):
    """The runs' rows end to end, with pad_runs all-sentinel runs (counts 0)
    after them: W word tensors and the counts tensor."""
    dev = parts_cnts[0].device
    pad = pad_runs * run_len
    rows = [
        torch.cat([p[w] for p in parts_words]
                  + [torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        for w in range(words)
    ]
    rows.append(torch.cat(
        list(parts_cnts) + [torch.zeros(pad, dtype=torch.int32, device=dev)]
    ))
    return rows


def _merge_runs_sum(parts_words, parts_cnts, lower, upper, *, words,
                    run_len, pad_runs):
    """Concatenate sorted runs + run merge + weighted run-length sum +
    [lower, upper] filter. Consolidation passes (1, 2**31-1), since partial
    counts must survive unfiltered until the final merge, and the final
    merge passes the real bounds. The parts are not modified: the caller's
    fallback drains the same partials to the host when this runs out of
    device memory. Returns (words_s, total, keep) over
    (len(parts) + pad_runs) * run_len slots."""
    # The concatenation lives only in the call: the merge lets it go after
    # its first pass (ops/merge.merge_sorted_runs).
    merged = merge_ops.merge_sorted_runs(
        _concat_runs(parts_words, parts_cnts, words, run_len, pad_runs),
        words, run_len,
    )
    words_s, pay = merged[:words], merged[words]
    head, total = _run_length_sum_auto(words_s, pay)
    keep = count_ops.frequency_filter(head, total, lower, upper)
    return words_s, total, keep


def _consolidate_device_runs(dev_words, dev_cnts, cfg, run_len):
    """Fold the held device-resident runs into ceil(union/run_len)
    compacted, sentinel-padded sorted runs, duplicate keys summed, NO [L,U]
    filter (partial counts must survive until the final merge).

    Device-only: nothing crosses to the host but the union's size. This is
    what lets arbitrarily long streams stay on the device: the run count
    shrinks back to the union size every `group` batches, the analogue of
    the reference's ScatteredKmerList pre-count (src/kmerops.cpp:363-417)
    applied transitively. Returns (words per run, counts per run, kept
    rows per run).
    """
    t0 = time.perf_counter()
    g = len(dev_words)
    words_s, total, keep = _merge_runs_sum(
        dev_words, dev_cnts, *_UNFILTERED,
        words=cfg.words, run_len=run_len, pad_runs=_next_pow2(g) - g,
    )
    # The merged rows are in key order, so the kept ones, gathered in
    # order and cut into run_len pieces, are sorted runs already.
    idx = torch.nonzero(keep).squeeze(1)
    del keep
    union = int(idx.shape[0])
    n_runs = -(-union // run_len)
    rows = []
    for src, fill in [(w, -1) for w in words_s] + [(total, 0)]:
        flat = torch.full((n_runs * run_len,), fill, dtype=torch.int32,
                          device=src.device)
        flat[:union] = src[idx]
        rows.append(flat.split(run_len))
    new_w = [[r[i] for r in rows[:-1]] for i in range(n_runs)]
    new_c = [rows[-1][i] for i in range(n_runs)]
    new_n = [min(run_len, union - i * run_len) for i in range(n_runs)]
    _LOG.info(
        "consolidate: %d runs -> %d (union %d rows) in %.2fs",
        g, n_runs, union, time.perf_counter() - t0,
    )
    return new_w, new_c, new_n


def count_reads_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Count k-mers of an arbitrarily large read set in bounded device memory.

    Equivalent to count_reads() (asserted in tests); peak device memory is
    set by batch_bases, not by the input size.

    Under cfg.device_compact, when the per-batch compacted partials plus the
    final merge fit the device, the partials STAY ON THE DEVICE and only the
    final filtered result crosses back to the host. Falls back to
    host-accumulated partials (chunked merge) otherwise, and when a device
    pass runs out of memory (torch.cuda.OutOfMemoryError, nothing wider: a
    failed kernel build or launch ends the run).

    Each batch is fed through `feed_wire` (pinned staging on CUDA). On the
    device-resident route a batch's step reads nothing on the host, so the
    host packs the next batch while the device counts this one; the kept
    row counts are read only where a shape needs them (a drain, a
    consolidation's union).
    """
    dev = resolve_device(device)
    # Snap ANY requested budget onto a pow2 flat shape (<= the request, so
    # the memory bound holds): the same batches as the JAX package cuts.
    snapped = snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple)
    if 0 < snapped <= batch_bases:
        batch_bases = snapped
    partial_keys: list[np.ndarray] = []
    partial_cnts: list[np.ndarray] = []
    dev_words: list = []
    dev_cnts: list = []
    dev_nks: list = []

    target = -(-(batch_bases + 16) // cfg.pad_multiple) * cfg.pad_multiple
    spans = read_batch_spans(lengths, batch_bases)
    # Device-resident accumulation needs a pow2 run length (the run
    # merge's geometry), guaranteed when batch_bases is pow2-snapped.
    # `group` runs are held at a time; consolidation folds them back down
    # on the device, so stream length does not force host copies.
    group = 0
    if cfg.device_compact and target & (target - 1) == 0:
        group = _consolidation_group_size(target, cfg.words, dev)
    device_resident = group >= 2
    if cfg.device_compact:
        _LOG.info(
            "streaming: %d batches, target=%d, device_resident=%s group=%d",
            len(spans), target, device_resident, group,
        )

    def _append_host_partial(words, cnt, n_kept):
        pulled = pull_prefix(list(words) + [cnt], n_kept)
        partial_keys.append(np.stack(pulled[:-1], axis=-1).view(np.uint32))
        partial_cnts.append(pulled[-1])
        return sum(p.nbytes for p in pulled)

    def _drain_device_partials():
        """Copy retained device partials to the host (fallback path)."""
        t0 = time.perf_counter()
        nbytes = sum(
            _append_host_partial(kw, kc, knk)
            for kw, kc, knk in zip(dev_words, dev_cnts, dev_nks)
        )
        dev_words.clear()
        dev_cnts.clear()
        dev_nks.clear()
        dt = time.perf_counter() - t0
        _LOG.info(
            "drain: %.1f MB copied in %.2fs (%.1f MB/s)",
            nbytes / 1e6, dt, nbytes / 1e6 / max(dt, 1e-9),
        )

    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        # Feed over the 2-bit wire (~2 bits/base + 4 B/read to the device).
        n = target
        if b_codes.size + 16 > target:
            # One read larger than the batch budget: rare one-off shape.
            n = -(-(b_codes.size + 16) // cfg.pad_multiple) * cfg.pad_multiple
        with annotate("stream/pack"):
            packed, lens = feed_wire(b_codes, b_lengths, n, dev)
        # Unfiltered per-batch pre-count. The upper bound here must be
        # unbounded (NOT cfg.upper, and not 65535): dropping a partial count
        # whose single-batch frequency exceeds any cap would silently
        # corrupt the merged totals; the final merge's [lower, upper]
        # filter is the only real bound.
        args = (packed, lens, cfg.k, n, *_UNFILTERED)
        del packed, lens
        if device_resident and n != target:
            # Oversized one-off batch breaks the uniform run length:
            # revert to host accumulation for the whole stream.
            device_resident = False
            _drain_device_partials()
        if not device_resident:
            # Gather the kept rows on the device, copy only those out
            # (through one pinned bounce buffer, reused batch to batch).
            with annotate("stream/count_batch"):
                words, cnt, keep = _count_device_packed(*args)
                partial = compact_keys(words, cnt, kept_slots(keep), cfg.k, _UNFILTERED[1])
                del words, cnt, keep
            partial_keys.append(partial.keys)
            partial_cnts.append(partial.counts)
            continue
        with annotate("stream/count_batch"):
            keys, cnt, n_kept = _count_device_packed_compact(*args)
        # Partials stay on the device; nothing crosses to the host, and
        # n_kept stays a device scalar.
        dev_words.append(keys)
        dev_cnts.append(cnt)
        dev_nks.append(n_kept)
        if len(dev_words) < group:
            continue
        try:
            with annotate("stream/consolidate"):
                dev_words, dev_cnts, dev_nks = _consolidate_device_runs(
                    dev_words, dev_cnts, cfg, target
                )
        except torch.cuda.OutOfMemoryError:
            # _merge_runs_sum leaves the held runs as they were, so they
            # survive a cycle that ran out of memory: recover like the
            # final merge below instead of ending the stream. The drain
            # runs outside this handler, where the failed cycle's frames
            # (and the tensors they hold) are gone.
            device_resident = False
        if not device_resident:
            _LOG.warning(
                "device-resident consolidation ran out of device memory; "
                "draining partials and continuing host-side"
            )
            # Give the failed cycle's blocks back to the device before the
            # drain allocates its copies.
            torch.cuda.empty_cache()
            _drain_device_partials()
            continue
        if len(dev_words) >= max(group - 1, 2):
            # The union occupies ~all held slots (distinct-heavy input):
            # device memory is effectively full, and at group-1 every
            # further batch would trigger another union-sized consolidation
            # (O(batches x union) device work). Drain the already-summed
            # runs to the host and finish there. The max(.., 2) keeps
            # group=2 (where union <= 1 run is the steady state) on the
            # device-resident path.
            device_resident = False
            _drain_device_partials()

    if dev_words:
        try:
            with annotate("stream/final_merge"):
                return _merge_device_resident(dev_words, dev_cnts, cfg, target)
        except torch.cuda.OutOfMemoryError:
            # The merge did not fit the device after all (the budget rule
            # missed): copy the compacted partials out and finish host-side.
            _LOG.warning(
                "device-resident merge ran out of device memory; draining "
                "to host"
            )
        torch.cuda.empty_cache()
        _drain_device_partials()

    if not partial_keys:
        return (
            KmerList(np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32), cfg.k),
            np.zeros(cfg.upper + 1, np.int32),
        )

    with annotate("stream/final_merge"):
        keys_np, cnts_np, hist = merge_partial_lists(
            partial_keys, partial_cnts, cfg,
            budget_elems=4 * snap_batch_to_pow2_flat(batch_bases, cfg.pad_multiple),
            device=dev,
        )
    return KmerList(keys_np, cnts_np, cfg.k), hist


def _merge_device_resident(dev_words, dev_cnts, cfg, run_len):
    """Merge device-retained per-batch (keys, counts) runs entirely on the
    device; only the final filtered, compacted result crosses to the host.

    Shares _merge_runs_sum with the consolidation cycle: concatenation + run
    merge + weighted run-length sum + [L,U] filter (the reference's
    count_sorted_kmerlist, src/kmerops.cpp:1447-1476), then a gather of the
    kept rows. The held runs are not modified: the caller's handler drains
    them to the host when the merge runs out of device memory. Returns
    (KmerList, histogram), the histogram computed on the device.
    """
    runs = _next_pow2(len(dev_words))
    t0 = time.perf_counter()
    _LOG.info("device-resident merge: %d runs x %d", runs, run_len)
    lower, upper = (
        _UNFILTERED if cfg.unfiltered else (cfg.lower, cfg.upper)
    )
    words_s, total, keep = _merge_runs_sum(
        dev_words, dev_cnts, lower, upper,
        words=cfg.words, run_len=run_len, pad_runs=runs - len(dev_words),
    )
    result, hist = kept_result(words_s, total, keep, cfg, upper)
    _LOG.info(
        "device-resident merge + final copy: %.1f MB in %.2fs",
        (result.keys.nbytes + result.counts.nbytes) / 1e6, time.perf_counter() - t0,
    )
    return result, hist


def merge_partial_lists(
    partial_keys: list[np.ndarray],
    partial_cnts: list[np.ndarray],
    cfg: KmerConfig,
    budget_elems: int,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Merge ascending host (keys, partial_count) lists with bounded device
    memory.

    Each partial is already sorted (compacted device output), so the device
    pass MERGES runs instead of re-sorting (ops/merge.py). When the padded
    composition exceeds `budget_elems` total elements (a distinct-heavy
    stream can make the union as large as the input) the merge runs in
    KEY-RANGE CHUNKS: boundaries on the leading key word are chosen so every
    chunk fits the budget, each partial contributes a contiguous slice per
    chunk (host searchsorted), and the filtered outputs concatenate in range
    order. The reference's memory bound comes from its fixed-size exchange
    rounds (src/kmerops.cpp:587-1007); chunked merging is the analogue on
    the result side (count_sorted_kmerlist, :1447-1476).

    Each partial's rows go to the device as they are (contiguous (m, W)
    keys and (m,) counts); the sentinel-padded (runs x run_len) layout the
    merge takes is made there, one slice copy a partial. Returns (keys (M,
    W) uint32, counts (M,) int32, histogram over [0, cfg.upper]), the
    histogram computed on the device.
    """
    dev = resolve_device(device)
    n_runs = _next_pow2(len(partial_keys))
    run_len_1 = _next_pow2(max(max(p.shape[0] for p in partial_keys), 1))

    def run_merge(chunk_keys, chunk_cnts, run_len):
        keys = torch.full((cfg.words, n_runs, run_len), -1, dtype=torch.int32, device=dev)
        cnts = torch.zeros((n_runs, run_len), dtype=torch.int32, device=dev)
        for i, (pk, pc) in enumerate(zip(chunk_keys, chunk_cnts)):
            m = pk.shape[0]
            if m:
                rows = np.ascontiguousarray(pk, dtype=np.uint32).view(np.int32)
                keys[:, i, :m] = to_device(rows, dev).T
                cnts[i, :m] = to_device(np.asarray(pc).astype(np.int32, copy=False), dev)
        rows = [keys[w].reshape(-1) for w in range(cfg.words)] + [cnts.reshape(-1)]
        del keys, cnts
        merged = merge_ops.merge_sorted_runs(rows, cfg.words, run_len)
        del rows
        words_s, pay = merged[: cfg.words], merged[cfg.words]
        head, total = _run_length_sum_auto(words_s, pay)
        keep = count_ops.frequency_filter(head, total, cfg.lower, cfg.upper)
        result, hist = kept_result(words_s, total, keep, cfg, cfg.upper)
        return result.keys, result.counts, hist

    if n_runs * run_len_1 <= max(budget_elems, 1 << 20):
        return run_merge(partial_keys, partial_cnts, run_len_1)

    # Chunked path: oversampled uniform edges on the leading word, grouped
    # greedily so each chunk's padded size fits the budget.
    total = sum(p.shape[0] for p in partial_keys)
    n_chunks_min = -(-total // max(budget_elems // 2, 1))
    s = 8 * _next_pow2(n_chunks_min)
    edges = (np.arange(1, s, dtype=np.uint64) * (1 << 32) // s).astype(
        np.uint32
    )
    offs = [
        np.concatenate(
            [
                [0],
                np.searchsorted(pk[:, 0], edges, side="left"),
                [pk.shape[0]],
            ]
        ).astype(np.int64)
        for pk in partial_keys
    ]
    interval_sizes = np.sum(
        [o[1:] - o[:-1] for o in offs], axis=0
    )  # (s,) totals
    # Greedy grouping of consecutive intervals under the element budget.
    groups: list[tuple[int, int]] = []
    lo = 0
    acc = 0
    for idx in range(s):
        if acc and acc + interval_sizes[idx] > budget_elems // 2:
            groups.append((lo, idx))
            lo, acc = idx, 0
        acc += int(interval_sizes[idx])
    groups.append((lo, s))
    # One shape for every chunk: pad to the global max slice length.
    run_len = _next_pow2(
        max(
            int(np.max([o[b] - o[a] for o in offs]))
            for a, b in groups
        )
        or 1
    )
    out_keys = [np.zeros((0, cfg.words), np.uint32)]
    out_cnts = [np.zeros(0, np.int32)]
    hist = np.zeros(cfg.upper + 1, np.int32)
    for a, b in groups:
        ck = [pk[o[a] : o[b]] for pk, o in zip(partial_keys, offs)]
        cc = [pc[o[a] : o[b]] for pc, o in zip(partial_cnts, offs)]
        if not any(x.shape[0] for x in ck):
            continue
        k_np, c_np, h = run_merge(ck, cc, run_len)
        out_keys.append(k_np)
        out_cnts.append(c_np)
        hist += h
    return np.concatenate(out_keys), np.concatenate(out_cnts), hist
