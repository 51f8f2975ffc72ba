"""The murmur3 32-bit finalizer, in plain torch and in numpy.

The port of hysortk_tpu/ops/hashes.py `fmix32`: the mixing step of the
invertible key mix (ops/mixkey.py). The other hashes of that module serve
minimizer routing and are not ported yet.

torch has no uint32 arithmetic. Words travel as int32 tensors holding uint32
bit patterns (ops/kmer.widen / narrow), and the 32 x 32-bit products are
taken modulo 2^32 from the constant's two 16-bit halves, so no int64
product overflows: x * c = x * lo + ((x * hi) mod 2^16) * 2^16 (mod 2^32),
with both partial products below 2^48.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmer import narrow, widen

_MASK32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def fmix32_wide(h: torch.Tensor) -> torch.Tensor:
    """fmix32 of int64 values in [0, 2^32); returns values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, C1)
    h = h ^ (h >> 13)
    h = mul32(h, C2)
    return h ^ (h >> 16)


def fmix32(words: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer of int32 words (uint32 bit patterns): a
    full-avalanche bijection. Returns int32 words."""
    return narrow(fmix32_wide(widen(words)))


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """fmix32 of a uint32 numpy array (uint32 arithmetic wraps)."""
    x = np.asarray(x).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(C1)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(C2)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x
