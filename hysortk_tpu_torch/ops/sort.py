"""Multiword key sort with the all-ones invalid sentinel.

The port of hysortk_tpu/ops/sort.py. Invalid and padding slots are folded
INTO the key as an all-ones sentinel rather than carried as a separate
leading sort operand: a valid canonical k-mer can never be all-T (its reverse
complement, all-A, is smaller, so GetRep would have chosen it — reference
include/kmer.hpp:316-321), hence the all-ones pattern in every word is
unreachable and sorts strictly after every real key.

The sort itself is ops/radix_sort.sort_words: the hand-written CUDA radix
sort on a CUDA tensor, its plain PyTorch version on a CPU tensor, or under
formulation="roll" the block sort followed by the run merge. The JAX
package's backend choice (`resolve_backend`, `sort_decision`) picks between
XLA and Pallas on a TPU and has no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import radix_sort

_FULL = -1  # 0xFFFFFFFF as an int32 word


def apply_sentinel(
    invalid: torch.Tensor, words: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Overwrite invalid slots with the unreachable all-ones key."""
    inv = invalid.to(torch.bool)
    full = torch.tensor(_FULL, dtype=torch.int32, device=inv.device)
    return [torch.where(inv, full, w) for w in words]


def sentinel_valid(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Recover the validity mask after sorting sentinel-folded keys."""
    all_ones = torch.ones(
        words[0].shape, dtype=torch.bool, device=words[0].device
    )
    for w in words:
        all_ones = all_ones & (w == _FULL)
    return ~all_ones


def sort_keys(
    invalid: torch.Tensor,
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    formulation: str = "member",
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """Sort by key words lexicographically, invalid slots last, carrying
    payloads. Returns (sorted_invalid, sorted_words, sorted_payloads), where
    sorted_invalid is int32 (0 = valid, 1 = invalid). `formulation` as in
    radix_sort.sort_words."""
    return sort_marked(apply_sentinel(invalid, words), payloads, formulation)


def sort_marked(
    marked: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    formulation: str = "member",
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """Sort keys already carrying the all-ones invalid sentinel."""
    sorted_words, sorted_payloads = radix_sort.sort_words(
        marked, payloads, formulation
    )
    inv_sorted = (~sentinel_valid(sorted_words)).to(torch.int32)
    return inv_sorted, sorted_words, sorted_payloads
