"""Decode of the 2-bit packed read wire, in plain torch on every device.

The port of hysortk_tpu/ops/wire.py (the receive-side parse of the
reference's 2-bit supermer wire, src/kmerops.cpp:1096-1148): the host feeds
(packed words, read lengths) — ~2 bits/base + 4 B/read — and the device
rebuilds the flat (codes, valid) stream with dense bit math:

  * unpack: one shift/mask broadcast per 16-base word;
  * validity: the last k-1 positions of each read (and everything past the
    last read) cannot start a k-mer — marked by a scatter-add of +/-1
    deltas at read boundaries (O(reads)) and one cumsum.

Under supermer routing the same decode parses the received supermers, each
one a short read, and extension mode fills every position's (read id,
position) from per-run headers (`fill_run_meta`).

This step is XLA code in the JAX package, not a Pallas kernel, so it stays
plain torch here too. Packing lives host-side in io/supermer.py.
"""

from __future__ import annotations

import torch


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


def decode_block(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire block -> (codes int8 (n,), valid bool (n,))."""
    return unpack_codes(packed, n), valid_from_lengths(lengths, k, n)


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


def decode_block_ext(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int, rid_base: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extension wire block -> (codes, valid, rid, pos)."""
    codes, valid = decode_block(packed, lengths, k, n)
    rid, pos = rid_pos_from_lengths(lengths, n, rid_base)
    return codes, valid, rid, pos


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
