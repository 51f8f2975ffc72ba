"""Canonical keys built and sorted in one step, keys only.

The port of hysortk_tpu/ops/pallas_sort.py sort_codes_fused (the kernel
pallas_msort.block_sort_keybuild and the merge levels behind it): the
unsorted key words never reach device memory. On a CUDA tensor the wrapper
launches the hand-written kernels of csrc/fused_sort.cu, the key build fused
into the LSD radix sort (its histogram of all digits and its first pass
derive each slot's key from the codes; the later passes are
csrc/radix_sort.cu's); on a CPU tensor it runs the plain version,
keybuild.canonical_keys_plain then radix_sort.sort_words_plain.

A keys-only sort is fully determined, so kernel, plain version and the JAX
function compare bit for bit. Paths with payloads (extension mode) keep the
unfused pair, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import words_per_kmer
from . import keybuild, radix_sort

MAX_WORDS = keybuild.MAX_WORDS


def sort_codes_fused_plain(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    marked = keybuild.canonical_keys_plain(codes, valid, k)
    return radix_sort.sort_words_plain(marked)[0]


def sort_codes_fused(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    """codes (N,) int8 in [0, 3], valid (N,) bool -> W ascending int32 key
    word rows (uint32 bit patterns), the all-ones sentinel of the invalid
    slots last."""
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
        return sort_codes_fused_plain(codes, valid, k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if codes.shape[0] >= 2**31:
        raise ValueError(f"fused sort takes n < 2^31, got {codes.shape[0]}")
    return _sort_codes_cuda(codes.contiguous(), valid.contiguous(), k)


def _sort_codes_cuda(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> list[torch.Tensor]:
    n = codes.shape[0]
    w = words_per_kmer(k)
    # Neither buffer is initialised: pass 0 writes b from the codes, and the
    # odd last pass leaves the result in a.
    a = torch.empty((w, n), dtype=torch.int32, device=codes.device)
    rows_a = list(a.unbind(0))
    if n == 0:
        return rows_a
    lib = _build.lib()
    b = torch.empty_like(a)
    scratch = torch.empty(
        lib.hk_radix_sort_scratch(n), dtype=torch.int32, device=codes.device
    )
    with torch.cuda.device(codes.device):
        status = lib.hk_fused_sort(
            codes.data_ptr(), valid.data_ptr(), n, k,
            _build.pointer_array(rows_a), _build.pointer_array(list(b.unbind(0))),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "fused sort launch")
    _build.launches["fused_sort"] += 1
    return rows_a
