"""Run-length counting of sorted keys + [L, U] frequency filter, plain torch.

The port of hysortk_tpu/ops/count.py (reference count_sorted_kmers,
src/kmerops.cpp:1410-1479): run extents come from dense scans instead of a
sequential run-length encoder.

  head[i]   = first position of a run of equal valid keys
  next head = suffix-min over (head ? index : N) -> run length by subtraction

Word equality is bitwise, so the int32 words need no widening here. The
hand-written CUDA kernels that fuse these scans are ops/fused_count.py
(count + filter) and ops/run_length_sum.py (weighted sum); these functions
are their plain versions. `chunked_bincount` (the bucket sizes of minimizer
routing) and `histogram` are a masked torch.bincount on either device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .kmer import narrow, widen


def run_length_count(
    sorted_valid: torch.Tensor, sorted_words: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Given validity-first sorted keys, return (head, count).

    head: bool (N,) — True at the first slot of each distinct valid key.
    count: int32 (N,) — at head slots, the number of equal keys; else 0.
    """
    n = sorted_valid.shape[0]
    dev = sorted_valid.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in sorted_words:
        neq = neq | (w != torch.roll(w, 1))
    if n:
        neq[0] = True
    head = sorted_valid & neq

    nvalid = sorted_valid.to(torch.int32).sum()
    head_pos = torch.where(head, idx, n)
    # next_head[i] = min over j >= i+1 of head_pos[j]
    suffix_min = torch.cummin(head_pos.flip(0), dim=0).values.flip(0)
    next_head = torch.cat(
        [suffix_min[1:], torch.full((1,), n, dtype=torch.int32, device=dev)]
    )[:n]
    run_end = torch.minimum(next_head, nvalid)
    count = torch.where(head, run_end - idx, 0).to(torch.int32)
    return head, count


def run_length_sum(
    sorted_valid: torch.Tensor,
    sorted_words: Sequence[torch.Tensor],
    weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like run_length_count but each slot contributes `weights[i]` to its run.

    Used where pre-aggregated (key, count) pairs meet again: the streaming
    merge of per-batch partial counts (the analogue of the reference's
    GatheredKmerList merge, src/kmerops.cpp:546-581). With weights == valid
    this reduces to run_length_count. Returns (head bool, total int32); the
    sums are int32 and wrap like the JAX version's: the prefix sums are
    taken in int64 and the difference is cut to its low 32 bits.
    """
    n = sorted_valid.shape[0]
    dev = sorted_valid.device
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in sorted_words:
        neq = neq | (w != torch.roll(w, 1))
    if n:
        neq[0] = True
    head = sorted_valid & neq

    w64 = torch.where(sorted_valid, widen(weights), 0)
    prefix = torch.cumsum(w64, 0)  # inclusive, nondecreasing
    # Run sum at a head i = prefix[last slot of i's run] - prefix[i] + w[i].
    # The last slot of a run is the one before the next head (or n-1);
    # invalid tail slots weigh 0, so letting the final run extend into the
    # sentinel tail changes nothing. A reverse cummin over
    # (pre-head ? prefix : max) carries each run's closing prefix back to
    # every slot of the run.
    pre_head = torch.cat(
        [head[1:], torch.ones(1, dtype=torch.bool, device=dev)]
    )[:n]
    closing = torch.where(pre_head, prefix, torch.iinfo(torch.int64).max)
    end_prefix = torch.cummin(closing.flip(0), dim=0).values.flip(0)
    total = narrow(end_prefix - prefix + w64)
    return head, torch.where(head, total, 0).to(torch.int32)


def frequency_filter(
    head: torch.Tensor, count: torch.Tensor, lower: int, upper: int
) -> torch.Tensor:
    """keep[i] — head slots whose run count is within [lower, upper].

    Mirrors the reference's [L, U] filter (src/kmerops.cpp:1430-1460).
    """
    return head & (count >= lower) & (count <= upper)


def chunked_bincount(
    values: torch.Tensor, valid: torch.Tensor, num_bins: int
) -> torch.Tensor:
    """(num_bins,) int32 count of the valid `values` in each bin [0,
    num_bins); values outside the bins count nowhere, as in the JAX
    version. The JAX version bounds its memory by scanning a one-hot one
    chunk at a time; torch.bincount needs no (N, num_bins) intermediate, so
    there is no chunk here."""
    v = values.to(torch.int64)
    inside = valid.to(torch.bool) & (v >= 0) & (v < num_bins)
    return torch.bincount(v[inside], minlength=num_bins).to(torch.int32)


def histogram(keep: torch.Tensor, count: torch.Tensor, upper: int) -> torch.Tensor:
    """hist[c] = number of kept k-mers with frequency c, c in [0, upper]
    (print_kmer_histogram, src/hysortk.cpp:98-136, histograms the filtered
    list)."""
    return chunked_bincount(count, keep, upper + 1)
