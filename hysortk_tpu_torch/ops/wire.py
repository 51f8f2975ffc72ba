"""Decode of the 2-bit packed read wire, in plain torch on every device.

The port of hysortk_tpu/ops/wire.py (the receive-side parse of the
reference's 2-bit supermer wire, src/kmerops.cpp:1096-1148): the host feeds
(packed words, read lengths) — ~2 bits/base + 4 B/read — and the device
rebuilds the flat (codes, valid) stream with dense bit math:

  * unpack: one shift/mask broadcast per 16-base word;
  * validity: the last k-1 positions of each read (and everything past the
    last read) cannot start a k-mer — marked by a scatter-add of +/-1
    deltas at read boundaries (O(reads)) and one cumsum.

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
