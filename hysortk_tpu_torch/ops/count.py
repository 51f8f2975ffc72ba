"""Run-length counting of sorted keys + [L, U] frequency filter, plain torch.

The port of hysortk_tpu/ops/count.py (reference count_sorted_kmers,
src/kmerops.cpp:1410-1479): run extents come from dense scans instead of a
sequential run-length encoder.

  head[i]   = first position of a run of equal valid keys
  next head = suffix-min over (head ? index : N) -> run length by subtraction

Word equality is bitwise, so the int32 words need no widening here. The
hand-written CUDA kernel that fuses this with the filter is
ops/fused_count.py; these functions are its plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch


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


def frequency_filter(
    head: torch.Tensor, count: torch.Tensor, lower: int, upper: int
) -> torch.Tensor:
    """keep[i] — head slots whose run count is within [lower, upper].

    Mirrors the reference's [L, U] filter (src/kmerops.cpp:1430-1460).
    """
    return head & (count >= lower) & (count <= upper)
