"""The comparison that decides `correct`: a result against the reference.

A result is what the counter returned, read as plain arrays: key rows (M, W)
uint32 (16 bases a word, first base highest, the last word's bases in its
top bits), counts (M,), the histogram, and in extension mode the
occurrences as flat (read id, position in read) arrays with (M + 1,)
offsets. The reference (counter.count) is walked one partition of the key
space at a time; the result's rows and occurrences are split the same way.

Numbers, each exact and with the limit 0:
  rows_wrong  result rows absent from the reference with that count, plus
              reference rows absent from the result (a duplicate row
              counts once more)
  hist_wrong  sum over bins of |result - reference|, a bin missing on one
              side counted whole
  occ_wrong   (extension mode) occurrences in one and not the other, an
              occurrence outside its read counted as wrong
"""

from __future__ import annotations

import numpy as np
import torch

from . import counter

LIMITS = {"rows_wrong": 0, "hist_wrong": 0, "occ_wrong": 0}


def key_values(rows: np.ndarray, k: int) -> np.ndarray:
    """(M, W) uint32 key rows -> (M,) int64 keys (first base highest)."""
    rows = np.asarray(rows, dtype=np.uint32).reshape(np.shape(rows)[0], -1)
    words = rows.shape[1]
    if words != (k + 15) // 16 or k > 31:
        raise ValueError(f"{words} words a key for k = {k}")
    last = k - 16 * (words - 1)
    acc = np.zeros(rows.shape[0], dtype=np.int64)
    for w in range(words - 1):
        acc = (acc << 32) | rows[:, w].astype(np.int64)
    return (acc << (2 * last)) | (rows[:, -1].astype(np.int64) >> (32 - 2 * last))


def _int64(x, dev) -> torch.Tensor:
    """A host array or a tensor as an int64 tensor on dev."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=torch.int64)


class Result:
    """A result on the comparison's device: keys int64, counts int64, the
    histogram, and where given, each occurrence's row and flat start (-1
    for one outside its read)."""

    def __init__(self, keys, counts, hist, dev, occ_row=None, occ_start=None):
        self.keys = _int64(keys, dev)
        self.counts = _int64(counts, dev)
        self.hist = _int64(hist, dev)
        self.occ_row = occ_row
        self.occ_start = occ_start

    @classmethod
    def from_arrays(cls, rows, counts, hist, k: int, dev, lengths=None, occ_rid=None,
                    occ_pos=None, offsets=None) -> "Result":
        """From the counter's own arrays; occurrences where occ_rid is given,
        placed by the read lengths."""
        res = cls(key_values(rows, k), counts, hist, dev)
        if occ_rid is None:
            return res
        offs = torch.from_numpy(np.asarray(offsets, dtype=np.int64)).to(dev)
        res.occ_row = torch.repeat_interleave(
            torch.arange(offs.numel() - 1, device=dev), offs[1:] - offs[:-1])
        rid = torch.from_numpy(np.asarray(occ_rid).astype(np.int64)).to(dev)
        pos = torch.from_numpy(np.asarray(occ_pos).astype(np.int64)).to(dev)
        reads = torch.from_numpy(counter.read_offsets(lengths)).to(dev)
        inside = (rid >= 0) & (rid < reads.numel() - 1)
        r = rid.clamp(0, reads.numel() - 2)
        inside &= (pos >= 0) & (pos + k <= reads[r + 1] - reads[r])
        res.occ_start = torch.where(inside, reads[r] + pos, torch.full_like(pos, -1))
        return res


def _matched(sorted_ref: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Mask of values found in sorted_ref."""
    if sorted_ref.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    i = torch.searchsorted(sorted_ref, values).clamp_(max=sorted_ref.numel() - 1)
    return sorted_ref[i] == values


def compare(result: Result, codes: torch.Tensor, lengths: np.ndarray, k: int,
            lower: int, upper: int, extension: bool = False) -> dict[str, int]:
    """The numbers of the module docstring for `result` against the
    reference over (codes, lengths)."""
    dev = codes.device
    stride = codes.numel() + 1
    rows_wrong = 0
    occ_wrong = 0
    ref_hist = torch.zeros(upper + 1, dtype=torch.int64, device=dev)
    res_part = None
    if extension and result.occ_start is not None:
        bad = result.occ_start < 0
        occ_wrong += int(bad.sum())
    for p, parts, ref in counter.count(codes, lengths, k, lower, upper, extension):
        if res_part is None:
            res_part = counter.partition(result.keys, parts)
        ref_hist += counter.histogram(ref.counts, upper)
        sel = torch.nonzero(res_part == p).squeeze(1)
        keys, counts = result.keys[sel], result.counts[sel]
        order = torch.argsort(keys)
        keys, counts, sel = keys[order], counts[order], sel[order]
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        n_ref = ref.keys.numel()
        idx = torch.searchsorted(ref.keys, keys).clamp_(max=max(n_ref - 1, 0))
        found = _matched(ref.keys, keys)
        same = found & first & (ref.counts[idx] == counts) if n_ref else found
        ok = int(same.sum())
        rows_wrong += (keys.numel() - ok) + (n_ref - ok)
        if extension:
            occ_wrong += _compare_occurrences(result, ref, sel, idx, found & first, stride,
                                              res_part, p)
    hist = result.hist
    width = max(hist.numel(), ref_hist.numel())
    a = torch.zeros(width, dtype=torch.int64, device=dev)
    b = torch.zeros(width, dtype=torch.int64, device=dev)
    a[: hist.numel()] = hist
    b[: ref_hist.numel()] = ref_hist
    out = {"rows_wrong": rows_wrong, "hist_wrong": int((a - b).abs().sum())}
    if extension:
        out["occ_wrong"] = occ_wrong
    return out


def _compare_occurrences(result: Result, ref: counter.Counted, sel, idx, usable, stride,
                         res_part, p) -> int:
    """Occurrences of the partition's result rows against the reference's:
    a row whose key the reference does not keep has every occurrence
    wrong."""
    dev = idx.device
    if result.occ_row is None:
        return int(ref.occ_row.numel())
    ref_row_of = torch.full((result.keys.numel(),), -1, dtype=torch.int64, device=dev)
    ref_row_of[sel[usable]] = idx[usable]
    in_part = (res_part[result.occ_row] == p) & (result.occ_start >= 0)
    rows = ref_row_of[result.occ_row[in_part]]
    starts = result.occ_start[in_part]
    wrong = int((rows < 0).sum())
    codes = torch.unique(rows[rows >= 0] * stride + starts[rows >= 0])
    ref_codes = ref.occ_row * stride + ref.occ_start  # ascending by construction
    hit = int(_matched(ref_codes, codes).sum())
    dup = int(in_part.sum()) - wrong - codes.numel()
    return wrong + dup + (codes.numel() - hit) + (ref_codes.numel() - hit)
