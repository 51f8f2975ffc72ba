"""Canonical k-mer key construction in one pass: kernel 1 of the slice.

The port of hysortk_tpu/ops/keybuild.py canonical_keys_fused. On a CUDA
tensor the wrapper launches the hand-written kernel csrc/keybuild.cu (a
2048-slot tile's codes plus their 16W-base halo packed 16 to a word in
shared memory, four slots a thread group, one 16-byte store a key row); on
a CPU tensor it runs the plain version,
ops/kmer.canonical_words + ops/sort.apply_sentinel, which defines the
semantics (reference Kmer<NLONGS> construction, include/kmer.hpp:107-345).
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import words_per_kmer
from . import kmer
from . import sort as sort_ops

MAX_WORDS = 6  # k <= 96


def canonical_keys_plain(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    return sort_ops.apply_sentinel(~valid, kmer.canonical_words(codes, k))


def canonical_keys_fused(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    """codes (N,) int8 in [0, 3], valid (N,) bool -> W int32 key word rows
    (uint32 bit patterns), the all-ones sentinel at invalid slots."""
    if codes.dtype != torch.int8 or valid.dtype != torch.bool:
        raise TypeError(f"need int8 codes and bool valid, got "
                        f"{codes.dtype} and {valid.dtype}")
    if codes.dim() != 1 or codes.shape != valid.shape:
        raise ValueError(f"need matching 1-D codes and valid, got "
                         f"{tuple(codes.shape)} and {tuple(valid.shape)}")
    if codes.device != valid.device:
        raise ValueError(f"codes on {codes.device}, valid on {valid.device}")
    if not 2 < k <= 16 * MAX_WORDS:
        raise ValueError(f"k must be in (2, {16 * MAX_WORDS}], got {k}")
    if codes.device.type == "cpu":
        return canonical_keys_plain(codes, valid, k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    return _canonical_keys_cuda(codes.contiguous(), valid.contiguous(), k)


def _canonical_keys_cuda(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    n = codes.shape[0]
    # Rows a multiple of four words apart: each starts 16-byte aligned.
    out = torch.empty(
        (words_per_kmer(k), -(-n // 4) * 4), dtype=torch.int32, device=codes.device
    )
    rows = [r[:n] for r in out.unbind(0)]
    if n == 0:
        return rows
    lib = _build.lib()
    with torch.cuda.device(codes.device):
        status = lib.hk_keybuild(
            codes.data_ptr(), valid.data_ptr(), n, k,
            _build.pointer_array(rows),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "keybuild launch")
    _build.launches["keybuild"] += 1
    return rows
