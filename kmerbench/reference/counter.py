"""The plain reference: a canonical k-mer counter in plain PyTorch.

Written from the definition alone; it imports nothing of the program. A
k-mer starts at every position of a read with at least k bases left in the
read; its key is the 2k-bit number of its bases (A=0, C=1, G=2, T=3, the
first base highest), its canonical key the smaller of that and the key of
its reverse complement. The result keeps each distinct canonical key whose
count lies in [lower, upper], ascending, with the histogram of those counts
over [0, upper] and, in extension mode, every occurrence of a kept key as
its flat start position (read start + position in read).

Keys are int64, so k <= 31. The work runs in blocks of positions and, for
the counting, in partitions of the key space by a hash (`partition`), so a
read set of 2^31 bases fits one card beside nothing else.

`fingerprint_counts` is the control: the same counter with each key
narrowed to a 32-bit fingerprint, the step a faster counter might take.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 1 << 27          # positions whose keys are built at once
PART_KEYS = 1 << 28      # keys a partition of the counting holds, about
_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as a signed int64


def _levels(x: torch.Tensor, k: int, reverse: bool) -> dict[int, torch.Tensor]:
    """Packs of 1, 2, 4, ... bases at each position (int64): forward packs
    put the first base highest, reverse packs lowest."""
    out = {1: x}
    p = 1
    while 2 * p <= k:
        a = out[p]
        if reverse:
            out[2 * p] = a[: a.numel() - p] | (a[p:] << (2 * p))
        else:
            out[2 * p] = (a[: a.numel() - p] << (2 * p)) | a[p:]
        p *= 2
    return out


def _pack(levels: dict[int, torch.Tensor], k: int, n: int, reverse: bool) -> torch.Tensor:
    """The k-base key at each of the first n positions from the packs."""
    acc = None
    off = 0
    shift = 0
    p = max(levels)
    while p:
        if k - off >= p:
            part = levels[p][off: off + n]
            if acc is None:
                acc = part.clone()
            elif reverse:
                acc |= part << (2 * shift)
            else:
                acc = (acc << (2 * p)) | part
            off += p
            shift += p
        p //= 2
    return acc


def canonical_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n - k + 1,) int64 canonical keys of every k-window of a base stream
    (uint8 codes in [0, 3]); windows across read ends are the caller's to
    drop."""
    if not 0 < k <= 31:
        raise ValueError(f"the reference holds keys of k <= 31 bases, not {k}")
    x = codes.to(torch.int64)
    n = x.numel() - k + 1
    fwd = _pack(_levels(x, k, False), k, n, False)
    rev = _pack(_levels(3 - x, k, True), k, n, True)
    return torch.minimum(fwd, rev)


def read_offsets(lengths: np.ndarray) -> np.ndarray:
    """(R + 1,) int64 exclusive prefix sums of the read lengths."""
    offsets = np.zeros(np.size(lengths) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lengths, dtype=np.int64), out=offsets[1:])
    return offsets


def all_keys(codes: torch.Tensor, lengths: np.ndarray, k: int, with_starts: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Every k-mer of the read set: (canonical keys int64, flat start
    positions int64 or None), in position order, on codes' device."""
    dev = codes.device
    lens = np.asarray(lengths, dtype=np.int64)
    offsets = torch.from_numpy(read_offsets(lens)).to(dev)
    total = int(np.maximum(lens - k + 1, 0).sum())
    keys = torch.empty(total, dtype=torch.int64, device=dev)
    starts = torch.empty(total, dtype=torch.int64, device=dev) if with_starts else None
    n = codes.numel()
    filled = 0
    for lo in range(0, max(0, n - k + 1), BLOCK):
        hi = min(n - k + 1, lo + BLOCK)
        key = canonical_keys(codes[lo: hi + k - 1], k)
        pos = torch.arange(lo, hi, device=dev)
        # A start is valid when its read has k bases left from it.
        rid = torch.searchsorted(offsets, pos, right=True) - 1
        ok = pos + k <= offsets[rid + 1]
        got = int(ok.sum())
        keys[filled: filled + got] = key[ok]
        if with_starts:
            starts[filled: filled + got] = pos[ok]
        filled += got
        del key, pos, rid, ok
    if filled != total:
        raise RuntimeError(f"{filled} k-mers found where the lengths give {total}")
    return keys, starts


def partition(keys: torch.Tensor, parts: int) -> torch.Tensor:
    """The partition of each key, from the top bits of a multiplicative
    hash (parts a power of two)."""
    if parts == 1:
        return torch.zeros(keys.shape, dtype=torch.uint8, device=keys.device)
    bits = parts.bit_length() - 1
    return (((keys * _GOLDEN) >> (64 - bits)) & (parts - 1)).to(torch.uint8)


def partitions_for(n_keys: int) -> int:
    parts = 1
    while parts * PART_KEYS < n_keys:
        parts *= 2
    return parts


@dataclasses.dataclass
class Counted:
    """A kept partition: keys ascending, their counts, and (extension mode)
    the occurrences as (index into keys, flat start) ordered by both."""

    keys: torch.Tensor
    counts: torch.Tensor
    occ_row: torch.Tensor | None = None
    occ_start: torch.Tensor | None = None


def count_partition(keys: torch.Tensor, starts: torch.Tensor | None, lower: int,
                    upper: int) -> Counted:
    """The kept (key, count) rows of one partition's keys, and where starts
    are given, the kept keys' occurrences."""
    uniq, inverse, counts = torch.unique(keys, sorted=True, return_inverse=True,
                                         return_counts=True)
    keep = (counts >= lower) & (counts <= upper)
    out = Counted(uniq[keep], counts[keep])
    if starts is not None:
        row_of = torch.cumsum(keep.to(torch.int64), 0) - 1
        occ = keep[inverse]
        rows = row_of[inverse[occ]]
        st = starts[occ]
        order = torch.argsort(rows * (int(st.max()) + 1 if st.numel() else 1) + st)
        out.occ_row, out.occ_start = rows[order], st[order]
    return out


def count(codes: torch.Tensor, lengths: np.ndarray, k: int, lower: int, upper: int,
          extension: bool = False):
    """The reference result, one partition at a time: yields (partition
    index, parts, Counted) for each partition of the key space."""
    keys, starts = all_keys(codes, lengths, k, with_starts=extension)
    parts = partitions_for(keys.numel())
    part = partition(keys, parts)
    for p in range(parts):
        sel = part == p
        yield p, parts, count_partition(keys[sel], starts[sel] if extension else None,
                                        lower, upper)
        del sel


def fingerprint_counts(codes: torch.Tensor, lengths: np.ndarray, k: int, lower: int,
                       upper: int, extension: bool = False, bits: int = 32):
    """The control: every key narrowed to a `bits`-bit fingerprint (the top
    bits of the hash `partition` takes its bits from, so a fingerprint lies
    in one partition) before counting. A fingerprint's count is that of all
    keys that share it; it is reported under the smallest of those keys.
    Returns the whole result as (keys int64 ascending, counts, occ_row,
    occ_start) on codes' device (occurrences None outside extension mode)."""
    keys, starts = all_keys(codes, lengths, k, with_starts=extension)
    parts = partitions_for(keys.numel())
    part = partition(keys, parts)
    out_keys, out_counts, occ_keys, occ_starts = [], [], [], []
    for p in range(parts):
        sel = torch.nonzero(part == p).squeeze(1)
        kp = keys[sel]
        fp = ((kp * _GOLDEN) >> (64 - bits)) & ((1 << bits) - 1)
        uniq, inverse, counts = torch.unique(fp, sorted=True, return_inverse=True,
                                             return_counts=True)
        del fp
        rep = torch.full_like(uniq, torch.iinfo(torch.int64).max)
        rep.scatter_reduce_(0, inverse, kp, reduce="amin")
        keep = (counts >= lower) & (counts <= upper)
        out_keys.append(rep[keep])
        out_counts.append(counts[keep])
        if extension:
            occ = keep[inverse]
            occ_keys.append(rep[inverse[occ]])
            occ_starts.append(starts[sel][occ])
        del sel, kp, uniq, inverse, counts, rep, keep
    del keys, starts, part
    out_keys, out_counts = torch.cat(out_keys), torch.cat(out_counts)
    order = torch.argsort(out_keys)
    out_keys, out_counts = out_keys[order], out_counts[order]
    if not extension:
        return out_keys, out_counts, None, None
    rows = torch.searchsorted(out_keys, torch.cat(occ_keys))
    st = torch.cat(occ_starts)
    o = torch.argsort(rows * (int(st.max()) + 1 if st.numel() else 1) + st)
    return out_keys, out_counts, rows[o], st[o]


def histogram(counts: torch.Tensor, upper: int) -> torch.Tensor:
    """hist[c] = kept keys with count c, c in [0, upper] (int64)."""
    return torch.bincount(counts.to(torch.int64), minlength=upper + 1)[: upper + 1]
