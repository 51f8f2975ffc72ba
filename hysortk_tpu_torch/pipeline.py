"""Single-device end-to-end k-mer counting pipeline in PyTorch.

The port of hysortk_tpu/pipeline.py's single-device path. The device
computation mirrors the reference's three phases (kmer_count,
src/hysortk.cpp:36-95):

  prepare  canonical keys              ops/keybuild.canonical_keys_fused
  sort     multiword key sort          ops/radix_sort.sort_words
  count    run length + [L,U] filter   ops/fused_count.run_length_count_filter

On a CUDA device each step is a hand-written kernel; on the CPU each is its
plain PyTorch version. The device is always explicit: asking for CUDA where
there is none raises, and nothing moves to the CPU by itself.

With HYSORTK_FUSED_SORT set (non-empty) in the environment the keys-only
paths take ops/fused_sort.sort_codes_fused for prepare + sort, the key build
fused into the sort's first pass, as the JAX package does under the same
variable. Extension mode ((ReadId, PosInRead) payloads riding the sort,
`count_flat_ext`, `count_reads_ext`) keeps the unfused pair.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections.abc import Sequence

import numpy as np
import torch

from .config import KmerConfig
from .io.fasta import segment_positions
from .ops import compact
from .ops import count as count_ops
from .ops import fused_count
from .ops import fused_sort
from .ops import keybuild
from .ops import kmer as kmer_ops
from .ops import merge as merge_ops
from .ops import radix_sort
from .ops import run_length_sum
from .ops import wire
from .ops.compact import gather_runs
from .runtime import prefault, timer
from .runtime.timer import stage


@dataclasses.dataclass
class KmerList:
    """Filtered {kmer, count} result on host.

    keys:   (M, W) uint32 packed canonical keys
    counts: (M,) int32 frequencies, all within [lower, upper]
    Laid out as hysortk_tpu.pipeline.KmerList (reference KmerListS,
    include/kmer.hpp:348-360), so the two compare with np.array_equal.
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.decoded().tolist(), self.counts.tolist()))


class Runs(Sequence):
    """A read-only sequence of per-k-mer views into one flat array: item j
    is flat[offsets[j]:offsets[j + 1]]. Integer items are views, slices
    lists of views; it equals any sequence of equal arrays."""

    __slots__ = ("flat", "offsets")

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [self[i] for i in range(*j.indices(len(self)))]
        j = range(len(self))[j]
        return self.flat[self.offsets[j]:self.offsets[j + 1]]

    def __iter__(self):
        bounds = self.offsets.tolist()
        flat = self.flat
        return (flat[a:b] for a, b in zip(bounds[:-1], bounds[1:]))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sequence) or len(self) != len(other):
            return False
        return all(np.array_equal(a, b) for a, b in zip(self, other))

    __hash__ = None

    def __add__(self, other) -> list:
        return list(self) + list(other)


class KmerListExt:
    """Extension-mode result: per-kmer occurrence payloads.

    pos[j]/rid[j] are the PosInRead / global ReadId arrays of all counts[j]
    occurrences of keys[j] (the reference's EXTENSION=1 KmerListEntryS,
    include/kmer.hpp:346-400, populated at src/kmerops.cpp:1430-1438), laid
    out as hysortk_tpu.pipeline.KmerListExt. They are views (`Runs`) into
    flat storage that the list owns: occ_rid (int32) and occ_pos (uint32)
    hold every occurrence end to end, k-mer j's at
    [offsets[j], offsets[j + 1]) (offsets int64, len + 1 long). The
    producers build it flat (`from_flat`); the constructor also takes lists
    of arrays. The order of a k-mer's occurrences is not part of the
    result: compare by as_dict().
    """

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int,
                 pos: Sequence[np.ndarray] = (), rid: Sequence[np.ndarray] = ()):
        if not len(pos) == len(rid) == keys.shape[0]:
            raise ValueError(f"{keys.shape[0]} keys with {len(pos)} position and "
                             f"{len(rid)} read id arrays")
        offsets = np.zeros(len(pos) + 1, dtype=np.int64)
        np.cumsum([np.size(p) for p in pos], out=offsets[1:])
        self._set(keys, counts, k,
                  np.concatenate([np.zeros(0, np.int32), *rid]).astype(np.int32),
                  np.concatenate([np.zeros(0, np.uint32), *pos]).astype(np.uint32),
                  offsets)

    @classmethod
    def from_flat(cls, keys: np.ndarray, counts: np.ndarray, k: int,
                  occ_rid: np.ndarray, occ_pos: np.ndarray,
                  offsets: np.ndarray | None = None) -> "KmerListExt":
        """The list over flat occurrences; offsets default to the exclusive
        prefix sum of counts."""
        if offsets is None:
            offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
        self = cls.__new__(cls)
        self._set(keys, counts, k, occ_rid, occ_pos, offsets)
        return self

    def _set(self, keys, counts, k, occ_rid, occ_pos, offsets) -> None:
        if offsets.shape != (keys.shape[0] + 1,) or int(offsets[-1]) != occ_rid.shape[0] \
                or occ_pos.shape != occ_rid.shape:
            raise ValueError("occurrence offsets do not match the keys and occurrences")
        self.keys, self.counts, self.k = keys, counts, k
        self.occ_rid = np.asarray(occ_rid, dtype=np.int32)
        self.occ_pos = np.asarray(occ_pos, dtype=np.uint32)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    @property
    def pos(self) -> Runs:
        return Runs(self.occ_pos, self.offsets)

    @property
    def rid(self) -> Runs:
        return Runs(self.occ_rid, self.offsets)

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def __repr__(self) -> str:
        return (f"KmerListExt({len(self)} k-mers, k={self.k}, "
                f"{self.occ_rid.shape[0]} occurrences)")

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, tuple[int, set]]:
        """kmer -> (count, {(rid, pos), ...}) for order-free comparison."""
        pairs = list(zip(self.occ_rid.tolist(), self.occ_pos.tolist()))
        bounds = self.offsets.tolist()
        return {
            km: (int(c), set(pairs[a:b]))
            for km, c, a, b in zip(self.decoded().tolist(), self.counts.tolist(),
                                   bounds[:-1], bounds[1:])
        }


def resolve_device(device) -> torch.device:
    """torch.device of `device`; raises where CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _count_core(
    codes: torch.Tensor, valid: torch.Tensor, k: int, lower: int, upper: int
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """codes (N,) int8, valid (N,) bool -> sorted key words, counts, keep."""
    dev = codes.device
    if os.environ.get("HYSORTK_FUSED_SORT"):  # read at call time
        with stage("fused sort", dev, events=True):
            words_s = fused_sort.sort_codes_fused(codes, valid, k)
    else:
        with stage("key build", dev, events=True):
            marked = keybuild.canonical_keys_fused(codes, valid, k)
        with stage("radix sort", dev, events=True):
            words_s, _ = radix_sort.sort_words(marked)
    with stage("fused count", dev, events=True):
        cnt, keep = fused_count.run_length_count_filter(words_s, lower, upper)
    return words_s, cnt, keep


def host_staging(shape, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An empty host tensor for a copy to or from `dev`. Where dev is CUDA
    it comes from torch's pinned host allocator, which caches page-locked
    blocks and reuses one only once the copies recorded on it have
    finished; on the CPU, ordinary memory (the CPU device's own route)."""
    return torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")


# The copy-out's pinned blocks (CopyRing): two of COPY_CHUNK_BYTES.
COPY_CHUNK_BYTES = 64 << 20


def copy_plan(sizes, chunk_bytes: int) -> list[tuple[int, int, int]]:
    """How a result's arrays cross through pinned blocks of chunk_bytes, in
    array order: sizes[i] = (elements, bytes an element) of array i; one
    piece (array, lo, hi) a block, elements [lo, hi) of the flattened
    array, as many as fill a block; an empty array has no piece."""
    pieces = []
    for i, (numel, itemsize) in enumerate(sizes):
        step = chunk_bytes // itemsize
        if step < 1:
            raise ValueError(f"{itemsize} B elements do not fit a {chunk_bytes} B block")
        pieces += [(i, lo, min(numel, lo + step)) for lo in range(0, numel, step)]
    return pieces


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class CopyRing:
    """The device-to-host copy-out of whole results through two pinned
    blocks of `chunk_bytes` (`host_staging`), allocated at first use and
    kept for the ring's life: the page-locked memory it holds is at most
    2 x chunk_bytes (`cap`), whatever the size of a result or of a stream
    of them.

    A result's pieces (copy_plan) take the blocks in turn: the copy of
    piece p + 1 is queued (non_blocking, on the current stream, after the
    work that made the arrays) with an event while the host waits for piece
    p's event and copies it out of the other block into its destination (by
    torch's threaded copy, widening where a dtype is asked for), so the
    card's copy runs while the host's does. The destinations are the
    caller's arrays where given, else fresh np.empty arrays that the result
    owns. A failed copy raises; nothing
    retries through pageable memory. Calls are serialized by a lock."""

    def __init__(self, chunk_bytes: int = COPY_CHUNK_BYTES):
        if chunk_bytes <= 0:
            raise ValueError(f"a block of {chunk_bytes} B")
        self.chunk_bytes = chunk_bytes
        self.blocks: list[torch.Tensor] = []
        self._lock = threading.Lock()

    @property
    def cap(self) -> int:
        return 2 * self.chunk_bytes

    @property
    def nbytes(self) -> int:
        """The page-locked bytes the ring holds."""
        return sum(b.numel() for b in self.blocks)

    def copy_out(self, tensors, dtypes, out=None) -> list[np.ndarray]:
        """tensors on one device -> C-contiguous host arrays of their shapes,
        each of dtypes[i] where that is not None, else of the tensor's: the
        arrays of `out` where given (each C-contiguous, of its tensor's size
        and that dtype), else fresh ones."""
        if len({t.device for t in tensors}) > 1:
            raise ValueError("a copy-out takes tensors on one device")
        srcs = [t.contiguous().reshape(-1) for t in tensors]
        outs = list(out) if out is not None else [
            np.empty(tuple(t.shape), dtype=numpy_dtype(d or t.dtype))
            for t, d in zip(tensors, dtypes)]
        dsts = [torch.from_numpy(o.reshape(-1)) for o in outs]
        plan = copy_plan([(s.numel(), s.element_size()) for s in srcs], self.chunk_bytes)
        if not plan:
            return outs
        dev = srcs[0].device

        def send(p):  # piece p into block p % 2: its view there and its event
            i, lo, hi = plan[p]
            if len(self.blocks) <= p % 2:
                self.blocks.append(host_staging((self.chunk_bytes,), torch.uint8, dev))
            src = srcs[i][lo:hi]
            view = self.blocks[p % 2][:src.numel() * src.element_size()].view(src.dtype)
            view.copy_(src, non_blocking=True)
            if dev.type != "cuda":
                return view, None
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            return view, event

        with self._lock, stage("copy-out"):
            pending = send(0)
            for p, (i, lo, hi) in enumerate(plan):
                view, event = pending
                if p + 1 < len(plan):
                    pending = send(p + 1)
                with stage("copy-out wait"):
                    if event is not None:
                        event.synchronize()
                with stage("copy-out host copy"):
                    dsts[i][lo:hi].copy_(view)
        return outs


# The process's copy-out ring (its blocks are allocated at first use).
RING = CopyRing()


def to_host(tensors, dtypes=None, out=None) -> list[np.ndarray]:
    """A device result, a list of tensors on one device, as ordinary
    C-contiguous host arrays of their shapes (of dtypes[i], where given and
    not None: a narrowed count widened on the host). From CUDA the whole
    result crosses in one pass through the process's pinned ring (RING:
    at most 2 x COPY_CHUNK_BYTES = 128 MiB page-locked), into fresh arrays
    that own their memory; on the CPU each tensor is turned into an array
    as it is, with no pinned memory. `out`, where given, holds the arrays
    to fill instead (C-contiguous, each of its tensor's size and dtype: views
    into a caller's larger result, or pages faulted in beforehand): they are
    filled and returned, on the CPU by one copy each."""
    tensors = list(tensors)
    dtypes = [None] * len(tensors) if dtypes is None else list(dtypes)
    if len(dtypes) != len(tensors) or (out is not None and len(out) != len(tensors)):
        raise ValueError(f"{len(dtypes)} dtypes and {len(out or tensors)} arrays for "
                         f"{len(tensors)} tensors")
    if out is not None:
        for t, d, o in zip(tensors, dtypes, out):
            if (o.size != t.numel() or o.dtype != numpy_dtype(d or t.dtype)
                    or not o.flags.c_contiguous):
                raise ValueError(f"a {o.dtype} array of {o.size} for a tensor of "
                                 f"{t.numel()}")
    if not tensors or tensors[0].device.type == "cpu":
        arrays = [(t if d is None else t.to(d)).contiguous().numpy()
                  for t, d in zip(tensors, dtypes)]
        if out is None:
            return arrays
        for o, a in zip(out, arrays):
            o.reshape(-1)[:] = a.reshape(-1)
        return list(out)
    arrays = (RING.copy_out(tensors, dtypes) if out is None
              else RING.copy_out(tensors, dtypes, out))
    # Every event-timed span queued before the copy-out has passed its last
    # piece's event: their seconds are read with no wait.
    timer.resolve()
    return arrays


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`: on CUDA copied into a pinned bounce buffer by
    torch's threaded copy, then to the device, one array at a time."""
    t = torch.from_numpy(a)
    if dev.type == "cpu":
        return t
    stage = host_staging(t.shape, t.dtype, dev)
    stage.copy_(t)
    return stage.to(dev)


def stage_wire(
    codes: np.ndarray, lengths: np.ndarray, n: int, dev: torch.device, lmax: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The host half of `feed_wire`: the 2-bit wire in fresh staging
    tensors (`host_staging`: pinned where dev is CUDA), the unpadded codes
    packed straight into them: ((n/16,) int32 words, 16 codes a word and
    zeros past the last code; (max(R, lmax),) int32 read lengths,
    zero-padded). n % 16 == 0 and n >= len(codes) + 16 (the decode's spare
    slots)."""
    from .io import supermer as supermer_io

    total = int(codes.size)
    if n % 16 or n < total + 16:
        raise ValueError(f"feed_wire: {n} slots for {total} bases (need a multiple of "
                         f"16 with 16 to spare)")
    r = int(np.size(lengths))
    with stage("staging"):
        packed = host_staging((n // 16,), torch.int32, dev)
        lens = host_staging((max(r, lmax),), torch.int32, dev)
    with stage("host pack"):
        supermer_io.pack_codes_2bit_into(codes, packed.numpy())
        lens_np = lens.numpy()
        lens_np[:r] = lengths
        lens_np[r:] = 0
    return packed, lens


def feed_wire(
    codes: np.ndarray, lengths: np.ndarray, n: int, dev: torch.device, lmax: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host reads -> the 2-bit packed wire on `dev` (`stage_wire`'s words
    and lengths), copied with non_blocking=True. Every call takes its own
    staging, so a batch packed while the one before still copies cannot
    overwrite it."""
    packed, lens = stage_wire(codes, lengths, n, dev, lmax)
    with stage("wire copy", dev, events=True):
        return packed.to(dev, non_blocking=True), lens.to(dev, non_blocking=True)


def kept_result(
    words: list[torch.Tensor], cnt: torch.Tensor, keep: torch.Tensor, cfg: KmerConfig,
    upper: int, histogram: bool = True, pages: prefault.Reservation | None = None,
) -> tuple[KmerList, np.ndarray | None]:
    """A filtered device result at its final size on the host: the kept rows
    compacted on the device (ops/compact.compact_kept: the counts at the
    narrowest width the filter's `upper` fits, widened to int32 on the
    host) and, where `histogram`, their histogram over [0, cfg.upper],
    binned in the same pass; all of it in one copy-out (`to_host`). The
    keys and counts land in fresh arrays, or, where `pages` is given (a
    reservation of at least the kept rows, being faulted in), in its pages:
    its faulting is stopped once the compaction has read the kept rows."""
    try:
        with stage("compaction", cnt.device, events=True):
            kept = compact.compact_kept(words, cnt, keep, upper=upper,
                                        hist_upper=cfg.upper if histogram else None)
            if pages is not None:
                pages.stop(kept.m)
        tensors = [kept.keys, kept.counts] + ([kept.hist] if histogram else [])
        dtypes = [None, torch.int32, torch.int32][: len(tensors)]
        out = None if pages is None else pages.arrays()
        if out is None:
            out = to_host(tensors, dtypes)
        else:
            hist = [np.empty(tuple(kept.hist.shape), np.int32)] if histogram else []
            out = to_host(tensors, dtypes, out + hist)
    finally:
        if pages is not None:
            pages.close()
    return KmerList(keys=out[0].view(np.uint32), counts=out[1], k=cfg.k), (
        out[2] if histogram else None)


def pull_prefix(tensors, n) -> list[np.ndarray]:
    """The first n elements of each device tensor, as host arrays (n an int
    or a 0-d device tensor, read here): only the prefixes cross to the
    host, in one copy-out (`to_host`), not the padded tail."""
    n = int(n)
    return to_host([t[:n] for t in tensors])


def _count_device_packed(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int,
    lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Wire-fed single-device step: (n/16,) packed words + (R,) read lengths
    -> decode on the device -> sorted key words, counts, keep. The bounds
    are arguments: streaming pre-counts pass (1, 2**31 - 1)."""
    with stage("wire decode", packed.device, events=True):
        codes, valid = wire.decode_block(packed, lengths, k, n)
    return _count_core(codes, valid, k, lower, upper)


def _count_device_packed_compact(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int,
    lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Wire-fed step + on-device compaction: the kept (key, count) rows as
    an ascending prefix [0, n_kept) of (n,) tensors whose tail is the
    all-ones sentinel (counts 0), i.e. one sorted sentinel-padded run.
    Returns (words, counts, n_kept), n_kept a 0-d device tensor: nothing is
    read on the host, so the caller's next batch can pack while this one
    runs.

    The JAX package folds dropped slots to the sentinel and sorts once more;
    the rows are already in key order here, so the kept rows compacted in
    slot order, the dropped slots' places filled with the sentinel
    (ops/compact.compact_kept with sync=False), give the same prefix."""
    words_s, cnt, keep = _count_device_packed(packed, lengths, k, n, lower, upper)
    kept = compact.compact_kept(words_s, cnt, keep, rows=True, sync=False)
    return kept.keys, kept.counts, kept.m


def host_histogram(counts: np.ndarray, upper: int) -> np.ndarray:
    """hist[c] = number of kept kmers with frequency c (c in [0, upper]), on
    the host: the streams' host merges use it."""
    return np.bincount(
        np.asarray(counts, dtype=np.int64), minlength=upper + 1
    ).astype(np.int32)[: upper + 1]


def count_flat(
    codes: np.ndarray, valid: np.ndarray, cfg: KmerConfig, device="cuda"
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers of a flat batch. Returns (list, histogram)."""
    dev = resolve_device(device)
    words, cnt, keep = _count_core(
        torch.as_tensor(np.asarray(codes, dtype=np.int8)).to(dev),
        torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev),
        cfg.k, cfg.lower, cfg.upper,
    )
    return kept_result(words, cnt, keep, cfg, cfg.upper)


def wire_batch(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig, device
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Host reads -> the 2-bit packed wire on the device (`feed_wire`):
    (packed words (n/16,) int32, read lengths (R,) int32, n), n the length
    padded to cfg.pad_multiple with at least 16 spare slots: ~2 bits/base +
    4 B/read cross to the device."""
    dev = resolve_device(device)
    pad = cfg.pad_multiple
    n = -(-(int(codes.size) + 16) // pad) * pad
    return (*feed_wire(codes, lengths, n, dev), n)


def device_batch(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host reads -> (codes int8 (n,), valid bool (n,)) on the device: the
    packed wire (`wire_batch`) decoded there (ops/wire.decode_block)."""
    packed, lens, n = wire_batch(codes, lengths, cfg, device)
    with stage("wire decode", packed.device, events=True):
        return wire.decode_block(packed, lens, cfg.k, n)


def count_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Full single-device pipeline from host reads, fed over the 2-bit
    packed wire (`device_batch`); the result leaves the device at its final
    size (`kept_result`), its histogram computed there.

    `cfg.device_compact` selects nothing here: the JAX count_reads uses it
    to compact on the device before the host copy, and `kept_result`
    already compacts the kept rows on the device in every configuration, so
    the result is the same KmerList either way.

    On a card the result's host pages are reserved once the device core is
    queued and faulted in while it runs (runtime/prefault), so the copy-out
    writes into touched pages; the bound on the kept rows comes from the
    read lengths."""
    codes_d, valid_d = device_batch(codes, lengths, cfg, device)
    words, cnt, keep = _count_core(
        codes_d, valid_d, cfg.k, cfg.lower, cfg.upper
    )
    pages = None
    if codes_d.device.type == "cuda":  # the device core runs: fault the result in
        pages = prefault.reserve(prefault.rows_bound(lengths, cfg.k, cfg.lower), len(words))
    return kept_result(words, cnt, keep, cfg, cfg.upper, pages=pages)


# --------------------------------------------------------------------------
# Extension mode: (ReadId, PosInRead) payloads ride the sort.

# Unfiltered bounds (cfg.unfiltered, and streaming's per-batch passes).
UNFILTERED = (1, 2**31 - 1)


def _count_device_ext(
    codes: torch.Tensor, valid: torch.Tensor, rid: torch.Tensor,
    pos: torch.Tensor, k: int, lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extension-mode device pipeline: rid and pos (int32 bit patterns) ride
    the sort as payload rows (the reference instead widens KmerSeedStruct,
    include/kmer.hpp:402-430). Returns (sorted words, cnt, keep, sorted rid,
    sorted pos). The sort is stable, so a k-mer's occurrences come out in
    ascending flat position."""
    dev = codes.device
    with stage("key build", dev, events=True):
        marked = keybuild.canonical_keys_fused(codes, valid, k)
    with stage("radix sort", dev, events=True):
        words_s, (rid_s, pos_s) = radix_sort.sort_words(marked, [rid, pos])
    with stage("fused count", dev, events=True):
        cnt, keep = fused_count.run_length_count_filter(words_s, lower, upper)
    return words_s, cnt, keep, rid_s, pos_s


def _count_device_ext_packed(
    packed: torch.Tensor, lengths: torch.Tensor, rid_base: int, k: int,
    n: int, lower: int, upper: int,
):
    """Wire-fed extension step: (rid, pos) are derived on the device from
    the read lengths (ops/wire.rid_pos_from_lengths), so the feed is the
    packed wire of the non-extension step plus one scalar."""
    with stage("wire decode", packed.device, events=True):
        codes, valid, rid, pos = wire.decode_block_ext(packed, lengths, k, n, rid_base)
    return _count_device_ext(codes, valid, rid, pos, k, lower, upper)


def split_occurrences(
    starts: np.ndarray, counts: np.ndarray, *arrays: np.ndarray
) -> list[list[np.ndarray]]:
    """Slice per-kmer occurrence runs [start, start+count) out of flat
    payload streams as views (no copies), over pre-tolist'ed bounds: plain
    int slicing is several times faster than np.split or numpy-scalar
    indices, which matters at 10^6+ distinct k-mers."""
    s_list = starts.tolist()
    e_list = (starts + counts).tolist()
    return [
        [a[s:e] for s, e in zip(s_list, e_list)] for a in arrays
    ]


def kept_occurrences(words, cnt, keep, rid_s, pos_s, mixed: bool = False,
                     hist_upper: int | None = None) -> tuple[compact.Kept, torch.Tensor,
                                                             torch.Tensor]:
    """The kept runs of the extension step's sorted outputs, on the device:
    their rows (ops/compact.compact_kept: keys unmixed where `mixed`, int32
    counts, slots, occurrence offsets, the histogram over [0, hist_upper]
    where asked) and their occurrences laid end to end in run order
    (gather_runs from those slots and offsets)."""
    with stage("compaction", cnt.device, events=True):
        kept = compact.compact_kept(words, cnt, keep, mixed=mixed, hist_upper=hist_upper,
                                    slots=True, offsets=True)
        rid, pos = gather_runs(kept.slots, kept.counts, rid_s, pos_s,
                               offsets=kept.offsets, total=kept.occ)
    return kept, rid, pos


def kept_partial(words, cnt, keep, rid_s, pos_s, mixed: bool = False,
                 hist_upper: int | None = None) -> tuple["ExtPartial", torch.Tensor | None]:
    """The kept runs of the extension step's sorted outputs as an ExtPartial
    on the device (kept_occurrences; the JAX package copies both whole
    streams and slices them on the host; a range route's keys unmixed, so
    its rows are not ascending), and their histogram where asked."""
    kept, rid, pos = kept_occurrences(words, cnt, keep, rid_s, pos_s, mixed, hist_upper)
    return ExtPartial(kept.keys, kept.counts, rid, pos, ascending=not mixed), kept.hist


def ext_result(words, cnt, keep, rid_s, pos_s, cfg: KmerConfig
               ) -> tuple[KmerListExt, np.ndarray]:
    """The kept runs (kept_partial), crossing to the host at their final
    size (ExtPartial.to_host), and the histogram of the kept counts over [0,
    cfg.upper], binned on the device in the same compaction."""
    part, hist = kept_partial(words, cnt, keep, rid_s, pos_s, hist_upper=cfg.upper)
    return part.to_host_with_hist(cfg.k, hist)


def count_flat_ext(
    codes: np.ndarray, valid: np.ndarray, rid: np.ndarray, pos: np.ndarray,
    cfg: KmerConfig, device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Extension-mode counting of a flat batch with its per-position read id
    and position in read. Returns (list with occurrences, histogram)."""
    dev = resolve_device(device)
    lower, upper = UNFILTERED if cfg.unfiltered else (cfg.lower, cfg.upper)
    outs = _count_device_ext(
        torch.as_tensor(np.asarray(codes, dtype=np.int8)).to(dev),
        torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev),
        torch.as_tensor(np.asarray(rid).astype(np.int32)).to(dev),
        torch.as_tensor(np.asarray(pos).astype(np.uint32).view(np.int32)).to(dev),
        cfg.k, lower, upper,
    )
    return ext_result(*outs, cfg)


def count_reads_ext(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig,
    read_id_offset: int = 0, device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Extension-mode single-device pipeline from host reads; read ids
    count from read_id_offset. Fed over the 2-bit packed wire, as
    count_reads is (`wire_batch`); each slot's read id and position are
    derived on the device from the read lengths
    (`_count_device_ext_packed`), so no per-slot array is built on the host."""
    lower, upper = UNFILTERED if cfg.unfiltered else (cfg.lower, cfg.upper)
    packed, lens, n = wire_batch(codes, lengths, cfg, device)
    outs = _count_device_ext_packed(packed, lens, read_id_offset, cfg.k, n, lower, upper)
    del packed, lens
    return ext_result(*outs, cfg)


def _key_order(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The stable ascending order of (M, W) uint32 key rows, word 0 first,
    unsigned, and the group heads in that order (True where a row's key
    differs from the row before). Where W <= 2, one stable torch.sort of
    the words packed into int64 with the sign bit flipped (so signed order
    is the unsigned one; several times faster than np.lexsort, and the
    sorted values give the heads); else np.lexsort."""
    if keys.shape[1] <= 2:
        packed = keys[:, 0].astype(np.int64) << 32
        if keys.shape[1] == 2:
            packed |= keys[:, 1].astype(np.int64)
        packed ^= np.int64(-(2**63))
        values, order = torch.sort(torch.from_numpy(packed), stable=True)
        values = values.numpy()
        head = np.ones(values.shape[0], dtype=bool)
        head[1:] = values[1:] != values[:-1]
        return order.numpy(), head
    order = np.lexsort(tuple(keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)))
    keys_s = keys[order]
    head = np.ones(keys_s.shape[0], dtype=bool)
    head[1:] = (keys_s[1:] != keys_s[:-1]).any(axis=1)
    return order, head


def merge_ext_partials(
    partials: list[KmerListExt], lower: int, upper: int, k: int, words: int
) -> KmerListExt:
    """Merge unfiltered per-batch extension partials into one filtered
    result, on the host.

    Each partial holds distinct keys with their occurrence runs from one
    bounded device batch; equal keys across batches are summed and their
    occurrence lists concatenated (order-free semantics, matching the
    reference's EXTENSION count_sorted_kmers accumulation,
    src/kmerops.cpp:1430-1438). The [L, U] filter applies to the merged
    totals only, exactly the reference's bounded-round behaviour, where
    nothing in the exchange loop is EXT-conditional (kmerops.cpp:906-1007).

    On the partials' flat arrays: their keys, counts and occurrences
    concatenated, the keys sorted once (`_key_order`), and one gather that
    lays the kept groups' occurrence runs out in key order (a group's runs
    in partial order); the merged offsets are the prefix sums of the kept
    groups' sizes.
    """
    nonempty = [p for p in partials if len(p)]
    if not nonempty:
        return KmerListExt(
            keys=np.zeros((0, words), np.uint32),
            counts=np.zeros(0, np.int32),
            k=k,
        )
    all_keys = np.concatenate([p.keys for p in nonempty], axis=0)
    all_cnts = np.concatenate([p.counts for p in nonempty]).astype(np.int64)
    flat_rid = np.concatenate([p.occ_rid for p in nonempty])
    flat_pos = np.concatenate([p.occ_pos for p in nonempty])
    # Entry i's occurrences sit at flat[entry_starts[i]:][:lens[i]].
    base = np.cumsum([0] + [p.occ_rid.shape[0] for p in nonempty[:-1]])
    entry_starts = np.concatenate([p.offsets[:-1] + b for p, b in zip(nonempty, base)])
    lens = np.concatenate([np.diff(p.offsets) for p in nonempty])

    order, head = _key_order(all_keys)
    group_starts = np.flatnonzero(head)
    # Integer segment sums (np.bincount weights would accumulate in f64,
    # exact only below 2^53).
    totals = np.add.reduceat(all_cnts[order], group_starts)
    keep = (totals >= lower) & (totals <= upper)

    # The entries of kept groups, in key order, and one gather of their
    # occurrence runs.
    sizes = np.diff(np.append(group_starts, order.size))
    entries = order[np.repeat(keep, sizes)]
    l_sel = lens[entries]
    gather_idx = segment_positions(entry_starts[entries], l_sel)
    offsets = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    if entries.size:
        first = np.cumsum(sizes[keep]) - sizes[keep]
        np.cumsum(np.add.reduceat(l_sel, first), out=offsets[1:])
    return KmerListExt.from_flat(
        all_keys[order[group_starts[keep]]], totals[keep].astype(np.int32), k,
        flat_rid[gather_idx], flat_pos[gather_idx], offsets,
    )


# --------------------------------------------------------------------------
# Extension-mode partials held on the device, and their merge there.


@dataclasses.dataclass
class ExtPartial:
    """One batch's unfiltered extension-mode partial on its device: distinct
    keys (m, W) int32 (uint32 bit patterns), their counts (m,) int32, and
    every occurrence as read ids and positions (n,) int32 (n = the counts'
    sum), row j's counts[j] occurrences contiguous and in row order.
    `ascending`: the rows are one run of keys in ascending unsigned order,
    word 0 first, as the device merge takes them (`ascending_partial`)."""

    keys: torch.Tensor
    counts: torch.Tensor
    occ_rid: torch.Tensor
    occ_pos: torch.Tensor
    ascending: bool = True

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    @property
    def n_occ(self) -> int:
        return int(self.occ_rid.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.counts, self.occ_rid, self.occ_pos))

    def to(self, device) -> "ExtPartial":
        """The partial on `device` (itself where it lies there)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in ("keys", "counts", "occ_rid", "occ_pos")})

    def to_host(self, k: int) -> KmerListExt:
        """The partial as a host KmerListExt: its four arrays in one
        copy-out (`to_host`)."""
        keys, counts, rid, pos = to_host([self.keys, self.counts, self.occ_rid, self.occ_pos])
        return KmerListExt.from_flat(keys.view(np.uint32), counts, k, rid, pos.view(np.uint32))

    def to_host_with_hist(self, k: int, hist: torch.Tensor) -> tuple[KmerListExt, np.ndarray]:
        """`to_host` and a histogram on the partial's device (int64), as
        int32, in the same copy-out."""
        keys, counts, rid, pos, h = to_host(
            [self.keys, self.counts, self.occ_rid, self.occ_pos, hist],
            [None, None, None, None, torch.int32])
        with stage("result assembly"):
            return KmerListExt.from_flat(keys.view(np.uint32), counts, k, rid,
                                         pos.view(np.uint32)), h


def ext_partial(words, cnt, keep, rid_s, pos_s) -> ExtPartial:
    """The partial of an extension step run under UNFILTERED bounds, from its
    sorted outputs. Every run but the sentinel's is kept there and the
    sentinel sorts last, so the kept runs' occurrences laid end to end are
    the first n_valid slots of rid_s / pos_s: copied as they are, with no
    gather (kept_occurrences gives the same); the kept rows by
    ops/compact.compact_kept, whose occurrence count is n_valid."""
    kept = compact.compact_kept(words, cnt, keep, offsets=True)
    return ExtPartial(kept.keys, kept.counts, rid_s[:kept.occ].clone(),
                      pos_s[:kept.occ].clone())


def ascending_partial(part: ExtPartial) -> ExtPartial:
    """`part` with its rows in ascending key order: the radix sort
    (ops/radix_sort.sort_words) of its key words with the counts and the row
    index riding as payloads, then its occurrences laid out again in the new
    row order (gather_runs). A partial already ascending is returned as it
    is."""
    if part.ascending or len(part) == 0:
        return dataclasses.replace(part, ascending=True)
    n_words = part.keys.shape[1]
    row = torch.arange(len(part), dtype=torch.int32, device=part.keys.device)
    words, (counts, row) = radix_sort.sort_words(
        [part.keys[:, w].contiguous() for w in range(n_words)], [part.counts, row])
    starts = (torch.cumsum(part.counts, 0, dtype=torch.int32) - part.counts)[row.to(torch.int64)]
    rid, pos = gather_runs(starts, counts, part.occ_rid, part.occ_pos)
    return ExtPartial(torch.stack(words, dim=-1), counts, rid, pos)


def merge_ext_rows(parts: Sequence[ExtPartial]) -> tuple[list[torch.Tensor],
                                                        torch.Tensor, torch.Tensor]:
    """Step 1 of `merge_ext_partials_device`: the ascending partials' rows end
    to end, merged by key at the partials' bounds (ops/merge.merge_runs_at)
    with two payload rows, each row's count and the start of its
    occurrences in the partials' occurrences end to end. Returns (W sorted
    words, counts, starts), int32. The merge is stable: a key's rows come in
    partial order."""
    n_occ = sum(p.n_occ for p in parts)
    if n_occ >= 2**31:
        raise ValueError(f"extension merge takes fewer than 2^31 occurrences, got {n_occ}")
    counts = torch.cat([p.counts for p in parts])
    # Each partial's occurrences are its rows' runs in row order, so the
    # exclusive prefix sum of the counts end to end is each row's start.
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    n_words = parts[0].keys.shape[1]
    rows = [torch.cat([p.keys[:, w] for p in parts]) for w in range(n_words)]
    bounds = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    merged = merge_ops.merge_runs_at(rows + [counts, starts], n_words, bounds)
    return merged[:n_words], merged[n_words], merged[n_words + 1]


def gather_kept_ext(parts: Sequence[ExtPartial], words_s, counts_s, starts_s, head,
                    total, keep, hist_upper: int) -> tuple[ExtPartial, torch.Tensor]:
    """Step 3 of `merge_ext_partials_device`: the kept groups (keep, at their
    heads) as one ascending partial, each group's rows' occurrences gathered
    end to end from the partials' occurrences (gather_runs), and the kept
    totals' histogram over [0, hist_upper]. Two compactions
    (ops/compact.compact_kept): the kept heads' keys and totals, and the
    rows of the kept groups (each row's group numbered by a cumsum of the
    heads, its keep set at the head by a scatter and read back at every
    row) with their occurrence offsets."""
    heads = compact.compact_kept(words_s, total, keep, hist_upper=hist_upper)
    n = head.shape[0]
    group = torch.cumsum(head, 0) - 1
    group_keep = torch.zeros(n + 1, dtype=torch.bool, device=head.device)
    group_keep.scatter_(0, torch.where(head, group, n), keep)
    rows = compact.compact_kept([starts_s], counts_s, group_keep[group], offsets=True)
    del group, group_keep
    rid, pos = gather_runs(
        rows.keys[:, 0], rows.counts,
        torch.cat([p.occ_rid for p in parts]), torch.cat([p.occ_pos for p in parts]),
        offsets=rows.offsets, total=rows.occ)
    return ExtPartial(heads.keys, heads.counts, rid, pos), heads.hist


def merge_ext_partials_device(parts: Sequence[ExtPartial], cfg: KmerConfig
                              ) -> tuple[KmerListExt, np.ndarray]:
    """`merge_ext_partials` on the partials' device: equal keys' counts
    summed and their occurrences laid end to end (in partial order), [L, U]
    on the totals; the same keys, counts and occurrences in the same order.
    The partials must be ascending (`ascending_partial`) and are not
    modified. On the device: the run merge of their rows (merge_ext_rows),
    the weighted run-length sum of the counts
    (ops/run_length_sum.run_length_sum_fused) and the filter, one gather of
    the kept groups' occurrences (gather_kept_ext); then only the result
    crosses to the host, in one copy-out with its histogram over [0,
    cfg.upper], binned on the device (ExtPartial.to_host_with_hist)."""
    if not all(p.ascending for p in parts):
        raise ValueError("the device merge takes ascending partials (ascending_partial)")
    parts = [p for p in parts if len(p)]
    if not parts:
        return (KmerListExt(np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32),
                            cfg.k), np.zeros(cfg.upper + 1, np.int32))
    words_s, counts_s, starts_s = merge_ext_rows(parts)
    head, total = run_length_sum.run_length_sum_fused(words_s, counts_s)
    keep = count_ops.frequency_filter(head, total, cfg.lower, cfg.upper)
    merged, hist = gather_kept_ext(parts, words_s, counts_s, starts_s, head, total, keep,
                                   cfg.upper)
    return merged.to_host_with_hist(cfg.k, hist)
