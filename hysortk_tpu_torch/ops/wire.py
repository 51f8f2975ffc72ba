"""Decode of the 2-bit packed read wire: a kernel of the slice on a CUDA
tensor, plain torch on a CPU tensor.

The port of hysortk_tpu/ops/wire.py (the receive-side parse of the
reference's 2-bit supermer wire, src/kmerops.cpp:1096-1148): the host feeds
(packed words, read lengths) — ~2 bits/base + 4 B/read — and the device
rebuilds the flat (codes, valid) stream, in extension mode with every
position's (read id, position in read):

  decode_block[_ext]   on a CUDA tensor the hand-written kernel
                       csrc/wire_decode.cu (two launches: the reads' ends by
                       a look-back scan, then a block a tile of 16384
                       positions with its reads' ends staged in shared
                       memory, a thread four 16-base words; the look-back's
                       descriptors kept zeroed between calls per device and
                       stream, no memset); on a CPU tensor
                       decode_block[_ext]_plain, the JAX version's dense bit
                       math in torch: one shift/mask broadcast per word
                       (unpack_codes), the last k-1 positions of each read
                       (and everything past the last read) marked invalid by
                       a scatter-add of +/-1 deltas at read boundaries and
                       one cumsum (valid_from_lengths), read ids and
                       positions by cumulative scans (rid_pos_from_lengths).

decode_block also takes S segments at once (the supermer route's received
segments, one launch for all). Under supermer routing extension mode fills
every position's (read id, position) from per-run headers instead:
`decode_block_runs`, the same kernel's run-header mode, S segments with
their headers in one launch (its plain version decode_block_plain +
`fill_run_meta`, the JAX version's diff scatter and cumsum in torch). The
host packs the wire (pipeline.stage_wire: io/supermer.pack_codes_2bit_into,
the host library's 2-bit pack).
"""

from __future__ import annotations

import functools
import threading

import torch

from .. import _build


def unpack_codes(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(n/16,) int32 words (uint32 bit patterns) -> (n,) int8 base codes.

    Word w holds bases 16w..16w+15, base b at bit shift 30 - 2*(b%16)
    (big-endian within the word, include/dnaseq.hpp:33-172).
    """
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=packed.device)
    wide = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (wide[:, None] >> shifts[None, :]) & 3
    return codes.reshape(-1)[:n].to(torch.int8)


def valid_from_lengths(
    lengths: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """(R,) int32 read lengths (zero-padded) -> (n,) k-mer-start validity.

    Reads are concatenated from flat position 0; position p starts a valid
    k-mer iff it lies at offset <= len-k inside its read. Equivalent to the
    host flattener (io/fasta.flatten_for_device) by construction.
    """
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    ends = torch.cumsum(lengths, 0)
    starts = ends - lengths
    zone_start = torch.maximum(ends - (k - 1), starts)
    total = ends[-1:] if lengths.shape[0] else torch.zeros(
        1, dtype=torch.int64, device=dev
    )

    delta = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    plus = torch.ones_like(zone_start, dtype=torch.int32)
    delta.scatter_add_(0, zone_start.clamp(max=n), plus)
    delta.scatter_add_(0, ends.clamp(max=n), -plus)
    # Tail padding is invalid.
    delta.scatter_add_(0, total.clamp(max=n), torch.ones_like(total, dtype=torch.int32))
    invalid = torch.cumsum(delta[:-1], 0) > 0
    return ~invalid


def _check_wire(packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int,
                segments_allowed: bool) -> None:
    if packed.dtype != torch.int32:
        raise TypeError(f"need int32 packed words, got {packed.dtype}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f"need integer read lengths, got {lengths.dtype}")
    if packed.device != lengths.device:
        raise ValueError(f"packed words on {packed.device}, lengths on {lengths.device}")
    dims = (1, 2) if segments_allowed else (1,)
    if packed.dim() not in dims or lengths.dim() != packed.dim():
        raise ValueError(f"need packed words and lengths of {' or '.join(map(str, dims))} "
                         f"matching dimension(s), got {tuple(packed.shape)} and "
                         f"{tuple(lengths.shape)}")
    if packed.dim() == 2 and not 1 <= packed.shape[0] == lengths.shape[0]:
        raise ValueError(f"need one row of words and of lengths a segment, got "
                         f"{tuple(packed.shape)} and {tuple(lengths.shape)}")
    if k < 1 or n < 0:
        raise ValueError(f"need k >= 1 and n >= 0, got k={k} n={n}")
    if packed.shape[-1] < -(-n // 16):
        raise ValueError(f"{packed.shape[-1]} words a segment hold fewer than {n} bases")


def decode_block_plain(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the decode kernel, on any device: the
    segments one after another, each by unpack_codes and valid_from_lengths."""
    if packed.dim() == 2:
        parts = [decode_block_plain(packed[s], lengths[s], k, n)
                 for s in range(packed.shape[0])]
        return torch.cat([c for c, _ in parts]), torch.cat([v for _, v in parts])
    return unpack_codes(packed, n), valid_from_lengths(lengths, k, n)


def decode_block(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire block -> (codes int8 (S * n,), valid bool (S * n,)).

    One segment: packed (>= ceil(n/16),) int32 words, lengths (R,) read
    lengths, zero-padded. S segments of n positions each, decoded back to
    back: packed (S, >= ceil(n/16)) and lengths (S, R), a row a segment
    (strided rows, as views of the received exchange, are read in place)."""
    _check_wire(packed, lengths, k, n, True)
    if packed.device.type == "cpu":
        return decode_block_plain(packed, lengths, k, n)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return _decode_cuda(packed, lengths, k, n, None)


def _decode_cuda(packed, lengths, k: int, n: int, rid_base: int | None, runs=None):
    """The kernel's launch: codes and flags; with rid_base the read ids and
    positions; with runs = (rid0, pos0) (int32, shaped as lengths) the
    run-header mode."""
    dev = packed.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _decode_cuda(packed, lengths, k, n, rid_base, runs)
    if packed.dim() == 1:
        packed, lengths = packed[None], lengths[None]
        if runs is not None:
            runs = tuple(r[None] for r in runs)
    if runs is not None:
        runs = tuple(r if r.stride(1) == 1 else r.contiguous() for r in runs)
    if packed.stride(1) != 1:
        packed = packed.contiguous()
    lengths = lengths.to(torch.int32)
    if lengths.stride(1) != 1:
        lengths = lengths.contiguous()
    segments, reads = lengths.shape
    if segments > 65535 or n >= 2**31 - 128 or k > 128:
        raise ValueError(f"the decode takes at most 65535 segments of fewer than "
                         f"2^31 - 128 positions and k <= 128, got {segments} of {n}, "
                         f"k={k}")
    total = segments * n
    out = [torch.empty(total, dtype=torch.int8, device=dev),
           torch.empty(total, dtype=torch.bool, device=dev)]
    if rid_base is not None and not -2**31 <= rid_base < 2**31:
        raise ValueError(f"rid_base must fit int32, got {rid_base}")
    if rid_base is not None or runs is not None:
        out += [torch.empty(total, dtype=torch.int32, device=dev) for _ in range(2)]
    if total == 0:
        return tuple(out)
    lib = _build.lib()
    ext = [t.data_ptr() for t in out[2:]] or [None, None]
    with _STATE_LOCK:
        stream = torch.cuda.current_stream().cuda_stream
        state, work = _buffers(dev, stream, *_decode_bytes(lib, segments, reads, n))
        if runs is None:
            status = lib.hk_wire_decode(
                packed.data_ptr(), packed.stride(0), lengths.data_ptr(), lengths.stride(0),
                segments, reads, n, k, rid_base or 0, state.data_ptr(), work.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), *ext, stream)
        else:
            rid0, pos0 = runs
            status = lib.hk_wire_decode_runs(
                packed.data_ptr(), packed.stride(0), lengths.data_ptr(), lengths.stride(0),
                rid0.data_ptr(), rid0.stride(0), pos0.data_ptr(), pos0.stride(0),
                segments, reads, n, k, state.data_ptr(), work.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), *ext, stream)
        if status:
            # A launch that did not run may leave the state dirty.
            _STATE.pop((dev, stream), None)
    _build.check(status, "wire decode launch")
    _build.launches["wire_decode"] += 1
    return tuple(out)


# The decode's buffers, per device and stream: its state (the lengths'
# look-back descriptors in csrc/wire_decode.cu), zeroed once and left zero
# by every call, and its work buffer (the read ends and the tiles' first
# reads, written anew by every call). Calls on one stream run in order; the
# lock keeps two threads' launches from interleaving.
_STATE: dict = {}
_STATE_LOCK = threading.Lock()


@functools.lru_cache(maxsize=64)
def _decode_bytes(lib, segments: int, reads: int, n: int) -> tuple[int, int]:
    """(state bytes, work bytes) of a decode of these dimensions."""
    return (lib.hk_wire_decode_state(segments, reads),
            lib.hk_wire_decode_scratch(segments, reads, n))


def _buffers(dev, stream: int, state_bytes: int, work_bytes: int):
    bufs = _STATE.setdefault((dev, stream), [None, None])
    if bufs[0] is None or bufs[0].numel() < state_bytes:
        bufs[0] = torch.zeros(max(state_bytes, 1 << 12), dtype=torch.uint8, device=dev)
    if bufs[1] is None or bufs[1].numel() < work_bytes:
        bufs[1] = torch.empty(max(work_bytes, 1 << 12), dtype=torch.uint8, device=dev)
    return bufs


def rid_pos_from_lengths(
    lengths: torch.Tensor, n: int, rid_base: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R,) read lengths -> per-position (read id, pos in read), both int32
    (pos a uint32 bit pattern, like the key words).

    Extension payloads need not travel the wire at all: both follow from
    the lengths with one boundary scatter and cumulative scans (rid = the
    running count of read starts; pos = the distance from the last start,
    by a cumulative max of start positions). Only meaningful where
    valid_from_lengths is True.
    """
    dev = lengths.device
    lengths = lengths.to(torch.int32)
    ends = torch.cumsum(lengths, 0, dtype=torch.int32)
    starts = ends - lengths
    # EVERY read marks its start, zero-length records too: their marks
    # stack on the next read's start (hence a scatter-add, which sums
    # repeated indices), so read ids keep counting ALL records, like the
    # host flattener and the reference's global read numbering. The
    # zero-padding pseudo-reads of `lengths` mark at or after the real
    # total, where the valid mask is already False.
    marks = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    marks.scatter_add_(
        0, starts.clamp(max=n).to(torch.int64), torch.ones_like(starts)
    )
    rid = torch.cumsum(marks[:-1], 0, dtype=torch.int32) - 1 + rid_base
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    last_start = torch.cummax(
        torch.where(marks[:-1] > 0, idx, torch.zeros_like(idx)), 0
    ).values
    return rid, idx - last_start


def decode_block_ext_plain(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int, rid_base: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the decode kernel in extension mode, on
    any device."""
    codes, valid = decode_block_plain(packed, lengths, k, n)
    rid, pos = rid_pos_from_lengths(lengths, n, rid_base)
    return codes, valid, rid, pos


def decode_block_ext(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int, rid_base: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extension wire block of one segment -> (codes int8, valid bool, rid
    int32, pos int32 holding uint32 bits), each (n,); read ids count from
    rid_base."""
    _check_wire(packed, lengths, k, n, False)
    if packed.device.type == "cpu":
        return decode_block_ext_plain(packed, lengths, k, n, rid_base)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return _decode_cuda(packed, lengths, k, n, rid_base)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with the same low 32 bits (two's complement
    wrap, what JAX's int32 arithmetic gives)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def fill_run_meta(
    lengths: torch.Tensor, rid0: torch.Tensor, pos0: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position (read id, pos in read) from per-RUN headers, both int32
    (pos a uint32 bit pattern).

    Runs (supermers) are concatenated from flat position 0 by `lengths`;
    run s starts at position pos0[s] (a uint32 bit pattern in int32) of
    read rid0[s]: the decode of the reference's extension-mode supermer wire
    ({len, pos, rid} per supermer, include/kmer.hpp:348-360). A
    piecewise-constant fill of per-run values by a boundary DIFF scatter and
    one cumulative sum, as the JAX version; the sums run in int64 and wrap
    to int32 at the end, which equals JAX's int32 wrap at every step
    (addition mod 2^32). Zero-length pad runs stack their diffs on the next
    start (a scatter-add sums repeated indices), and the telescoped sum
    stays right. Only meaningful where valid_from_lengths is True.
    """
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    ends = torch.cumsum(lengths, 0)
    starts = ends - lengths
    at = starts.clamp(max=n)

    def fill(vals: torch.Tensor) -> torch.Tensor:
        diffs = torch.cat([vals[:1], vals[1:] - vals[:-1]])
        buf = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        buf.scatter_add_(0, at, diffs)
        return torch.cumsum(buf[:-1], 0)

    rid = fill(rid0.to(torch.int64))
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    pos = fill((pos0.to(torch.int64) & 0xFFFFFFFF) - starts) + idx
    return _wrap32(rid), _wrap32(pos)


def decode_block_runs_plain(
    packed: torch.Tensor, lengths: torch.Tensor, rid0: torch.Tensor, pos0: torch.Tensor,
    k: int, n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the decode kernel's run-header mode, on
    any device: decode_block_plain, then fill_run_meta segment by segment."""
    codes, valid = decode_block_plain(packed, lengths, k, n)
    if packed.dim() == 1:
        return (codes, valid, *fill_run_meta(lengths, rid0, pos0, n))
    meta = [fill_run_meta(lengths[s], rid0[s], pos0[s], n) for s in range(packed.shape[0])]
    return (codes, valid, torch.cat([m[0] for m in meta]),
            torch.cat([m[1] for m in meta]))


def decode_block_runs(
    packed: torch.Tensor, lengths: torch.Tensor, rid0: torch.Tensor, pos0: torch.Tensor,
    k: int, n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wire block of runs with headers -> (codes int8, valid bool, rid
    int32, pos int32 holding uint32 bits), each (S * n,): decode_block,
    and every position's read id and position in its read from the
    headers of the run that holds it (fill_run_meta's function: run i,
    the last whose start is at or before the position, gives rid0[i] and
    pos0[i] + the offset into the run).

    One segment: packed (>= ceil(n/16),), lengths, rid0, pos0 (R,); S
    segments: (S, ...) rows, a row a segment (strided rows, as views of the
    received exchange, are read in place). rid0 and pos0 are int32 (pos0
    holding uint32 bits), shaped as lengths. On a CUDA tensor the decode
    kernel's run-header mode, all S segments in one launch."""
    _check_wire(packed, lengths, k, n, True)
    for name, t in (("rid0", rid0), ("pos0", pos0)):
        if t.dtype != torch.int32 or t.shape != lengths.shape or t.device != lengths.device:
            raise ValueError(f"{name} must be int32 of the lengths' shape "
                             f"{tuple(lengths.shape)} on {lengths.device}, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")
    if packed.device.type == "cpu":
        return decode_block_runs_plain(packed, lengths, rid0, pos0, k, n)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return _decode_cuda(packed, lengths, k, n, None, (rid0, pos0))
