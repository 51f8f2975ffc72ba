"""Run-length count + [L, U] filter in one sweep: kernel 3 of the slice.

The port of hysortk_tpu/ops/pallas_count.py run_length_count_filter. On a
CUDA tensor the wrapper launches the hand-written kernel of
csrc/fused_count.cu; on a CPU tensor it runs the plain version,
ops/count.run_length_count + frequency_filter.

The TPU kernel carries "the first boundary to the right" in a scalar over a
sequential grid. On the card all tiles run at once, so one kernel hands that
carry from tile to tile by a decoupled look-back that runs right to left
(csrc/lookback.cuh): the words are read once, 16 bytes a thread, the counts
and the mask written once, and the only scratch is one descriptor word per
4096-slot tile, zeroed per call. What bounds it is the card's memory rate:
4W bytes in and 5 out per slot.

Semantics, as in the TPU kernel: a run boundary is at slot 0 or wherever any
word differs from the slot before; the first sentinel slot is a boundary and
never a head; at a head cnt = next boundary - slot, else 0. On sorted,
sentinel-last input this equals the plain version's run length.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from . import count as count_ops
from . import sort as sort_ops

MAX_WORDS = 6


def run_length_count_filter_plain(
    sorted_words: Sequence[torch.Tensor], lower: int, upper: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    head, cnt = count_ops.run_length_count(
        sort_ops.sentinel_valid(sorted_words), sorted_words
    )
    return cnt, count_ops.frequency_filter(head, cnt, lower, upper)


def run_length_count_filter(
    sorted_words: Sequence[torch.Tensor], lower: int, upper: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted sentinel-marked (N,) int32 words -> (cnt int32, keep bool)."""
    words = list(sorted_words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"need 1..{MAX_WORDS} words, got {len(words)}")
    n = words[0].shape[0]
    for w in words:
        if w.dtype != torch.int32 or w.dim() != 1 or w.shape[0] != n:
            raise ValueError("every word must be a 1-D int32 tensor of one length")
        if w.device != words[0].device:
            raise ValueError("every word must lie on one device")
    if words[0].device.type == "cpu":
        return run_length_count_filter_plain(words, lower, upper)
    if words[0].device.type != "cuda":
        raise ValueError(f"unsupported device {words[0].device}")
    if n >= 2**31:
        # Run lengths are int32; a run longer than 2^31 needs n >= 2^31.
        raise ValueError(f"fused count takes n < 2^31, got {n}")
    return _count_cuda([w.contiguous() for w in words], lower, upper)


def _count_cuda(
    words: list[torch.Tensor], lower: int, upper: int
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = words[0].device
    n = words[0].shape[0]
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return cnt, keep
    lib = _build.lib()
    scratch = torch.empty(
        lib.hk_fused_count_scratch(n), dtype=torch.uint8, device=dev
    )
    with torch.cuda.device(dev):
        status = lib.hk_fused_count(
            _build.pointer_array(words), len(words), n, lower, upper,
            cnt.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "fused count launch")
    _build.launches["fused_count"] += 1
    return cnt, keep
