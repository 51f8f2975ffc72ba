"""Weighted run-length sum in one sweep: the kernel of the streaming merge.

The port of hysortk_tpu/ops/pallas_count.py run_length_sum_fused. On a CUDA
tensor the wrapper launches the hand-written kernel of
csrc/run_length_sum.cu; on a CPU tensor it runs the plain version,
ops/count.run_length_sum.

The TPU kernel carries the open run's partial sum in a scalar over a
sequential grid. On the card all tiles run at once, so one kernel does a
reverse segmented scan within each 4096-slot tile and hands the carry from
tile to tile by a decoupled look-back that runs right to left
(csrc/lookback.cuh, one 64-bit (status, sum) descriptor per tile, zeroed
per call): the words and the weights are read once, 16 bytes a thread, the
totals and the heads written once. What bounds it is the card's memory
rate: 4W + 4 bytes in and 5 out per slot.

Semantics, as in the TPU kernel: a run boundary is at slot 0 or wherever any
word differs from the slot before; all-ones (sentinel) slots weigh 0; the
first sentinel slot is a boundary and never a head; at a head total = the
int32 sum of its run's weights, else 0.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from . import count as count_ops
from . import sort as sort_ops

MAX_WORDS = 6


def run_length_sum_fused_plain(
    sorted_words: Sequence[torch.Tensor], weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    return count_ops.run_length_sum(
        sort_ops.sentinel_valid(sorted_words), sorted_words, weights
    )


def run_length_sum_fused(
    sorted_words: Sequence[torch.Tensor], weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted sentinel-marked (N,) int32 words + (N,) int32 weights ->
    (head bool, total int32)."""
    words = list(sorted_words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"need 1..{MAX_WORDS} words, got {len(words)}")
    n = words[0].shape[0]
    for w in words + [weights]:
        if w.dtype != torch.int32 or w.dim() != 1 or w.shape[0] != n:
            raise ValueError(
                "words and weights must be 1-D int32 tensors of one length"
            )
        if w.device != words[0].device:
            raise ValueError("words and weights must lie on one device")
    if words[0].device.type == "cpu":
        return run_length_sum_fused_plain(words, weights)
    if words[0].device.type != "cuda":
        raise ValueError(f"unsupported device {words[0].device}")
    if n >= 2**31:
        raise ValueError(f"run-length sum takes n < 2^31, got {n}")
    return _sum_cuda([w.contiguous() for w in words], weights.contiguous())


def _sum_cuda(
    words: list[torch.Tensor], weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = words[0].device
    n = words[0].shape[0]
    head = torch.empty(n, dtype=torch.bool, device=dev)
    total = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return head, total
    lib = _build.lib()
    scratch = torch.empty(
        lib.hk_run_length_sum_scratch(n), dtype=torch.uint8, device=dev
    )
    with torch.cuda.device(dev):
        status = lib.hk_run_length_sum(
            _build.pointer_array(words), len(words), weights.data_ptr(), n,
            head.data_ptr(), total.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "run-length sum launch")
    _build.launches["run_length_sum"] += 1
    return head, total
