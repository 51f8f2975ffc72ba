"""Invertible multiword key mixing: sort key == routing key.

The port of hysortk_tpu/ops/mixkey.py. The sharded pipeline sorts each
rank's keys once in a *mixed* key space, mixed = M(key), with M a bijection
on the W-word key space whose top bits are uniform (full avalanche). Then
the destination of a key is a range of mixed[0], a monotone function of the
sort order, so one local sort orders the keys and groups the destinations
into contiguous segments; equal mixed keys are equal keys, so counting in
mixed space is exact; the compacted results are un-mixed where they lie
(`unmix_keys`, plain PyTorch on any device).

M is a cyclic Feistel-style network of murmur3 fmix32 steps
(w[i] = fmix32(w[i] + w[(i+1) % W] + C)), finished with a constant XOR that
makes the all-ones sentinel (ops/sort.py) a fixed point: M(F) = F, so no
valid key mixes to the sentinel and sentinel-marked rows can be mixed as
they are.

On a CUDA tensor `mix_keys` launches the hand-written kernel of
csrc/mixkey.cu (in the JAX package the mix is XLA code, no Pallas kernel);
on a CPU tensor it runs the plain version, `mix_keys_plain`. The inverse,
`unmix_keys`, is elementwise int64 arithmetic masked to 32 bits (the JAX
package unmixes in numpy). The numpy functions are copied from the JAX
module as they are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from .. import _build
from . import hashes
from .kmer import narrow, widen

_ROUNDS = 2
# Round constants: odd golden-ratio multiples (any fixed odd values work).
_RC = [0x9E3779B1 * (2 * i + 1) & 0xFFFFFFFF for i in range(16)]

_FULL = np.uint32(0xFFFFFFFF)
MAX_WORDS = 6  # k <= 96


# --- numpy reference implementation (host side + inverse) -------------------


_fmix32_np = hashes.fmix32_np

_INV_C1 = np.uint32(pow(0x85EBCA6B, -1, 1 << 32))
_INV_C2 = np.uint32(pow(0xC2B2AE35, -1, 1 << 32))


def _fmix32_inv_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * _INV_C2).astype(np.uint32)
    x ^= (x >> np.uint32(13)) ^ (x >> np.uint32(26))
    x = (x * _INV_C1).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def _mix_core_np(words: list[np.ndarray]) -> list[np.ndarray]:
    w = [x.astype(np.uint32).copy() for x in words]
    W = len(w)
    for r in range(_ROUNDS):
        for i in range(W):
            c = np.uint32(_RC[r * W + i])
            if W == 1:
                w[0] = _fmix32_np(w[0] + c)
            else:
                w[i] = _fmix32_np(w[i] + w[(i + 1) % W] + c)
    return w


@functools.lru_cache(maxsize=None)
def _sentinel_fix(W: int) -> tuple[int, ...]:
    """XOR constants making the all-ones sentinel a fixed point of M."""
    mf = _mix_core_np([np.asarray([_FULL]) for _ in range(W)])
    return tuple(int(m[0] ^ _FULL) for m in mf)


def mix_keys_np(keys: np.ndarray) -> np.ndarray:
    """(M, W) uint32 canonical keys -> mixed keys (numpy)."""
    W = keys.shape[1]
    fix = _sentinel_fix(W)
    w = _mix_core_np([keys[:, i] for i in range(W)])
    return np.stack(
        [x ^ np.uint32(fix[i]) for i, x in enumerate(w)], axis=-1
    )


def unmix_keys_np(mixed: np.ndarray) -> np.ndarray:
    """(M, W) mixed keys -> original canonical keys (exact inverse)."""
    W = mixed.shape[1]
    fix = _sentinel_fix(W)
    w = [
        (mixed[:, i] ^ np.uint32(fix[i])).astype(np.uint32)
        for i in range(W)
    ]
    for r in range(_ROUNDS - 1, -1, -1):
        for i in range(W - 1, -1, -1):
            c = np.uint32(_RC[r * W + i])
            if W == 1:
                w[0] = (_fmix32_inv_np(w[0]) - c).astype(np.uint32)
            else:
                w[i] = (
                    _fmix32_inv_np(w[i]) - w[(i + 1) % W] - c
                ).astype(np.uint32)
    return np.stack(w, axis=-1)


# --- device implementation ---------------------------------------------------


def mix_keys_plain(words: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device: W (N,) int32
    words (uint32 bit patterns) -> W mixed int32 words."""
    W = len(words)
    fix = _sentinel_fix(W)
    w = [widen(x) for x in words]
    for r in range(_ROUNDS):
        for i in range(W):
            c = _RC[r * W + i]
            if W == 1:
                w[0] = hashes.fmix32_wide((w[0] + c) & 0xFFFFFFFF)
            else:
                w[i] = hashes.fmix32_wide(
                    (w[i] + w[(i + 1) % W] + c) & 0xFFFFFFFF
                )
    return [narrow(x ^ fix[i]) for i, x in enumerate(w)]


def _fmix32_inv_wide(h: torch.Tensor) -> torch.Tensor:
    """The inverse of hashes.fmix32_wide, on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = hashes.mul32(h, int(_INV_C2))
    h = h ^ (h >> 13) ^ (h >> 26)
    h = hashes.mul32(h, int(_INV_C1))
    return h ^ (h >> 16)


def unmix_keys(words: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The inverse of mix_keys in plain PyTorch, on any device: W (N,) int32
    mixed words -> W int32 canonical words, new tensors (unmix_keys_np on
    the tensors' device; the sentinel stays the sentinel)."""
    W = len(words)
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"need 1..{MAX_WORDS} words, got {W}")
    fix = _sentinel_fix(W)
    w = [widen(x) ^ fix[i] for i, x in enumerate(words)]
    for r in range(_ROUNDS - 1, -1, -1):
        for i in range(W - 1, -1, -1):
            c = _RC[r * W + i]
            if W == 1:
                w[0] = (_fmix32_inv_wide(w[0]) - c) & 0xFFFFFFFF
            else:
                w[i] = (_fmix32_inv_wide(w[i]) - w[(i + 1) % W] - c) & 0xFFFFFFFF
    return [narrow(x) for x in w]


def mix_keys(words: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """W (N,) int32 key words -> W mixed words, new tensors (the inputs are
    not modified). Sentinel-invariant; rows may be views at any offset."""
    words = list(words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"need 1..{MAX_WORDS} words, got {len(words)}")
    n = words[0].shape[0]
    for w in words:
        if w.dtype != torch.int32 or w.dim() != 1 or w.shape[0] != n:
            raise ValueError("every word must be a 1-D int32 tensor of one length")
        if w.device != words[0].device:
            raise ValueError("every word must lie on one device")
    if words[0].device.type == "cpu":
        return mix_keys_plain(words)
    if words[0].device.type != "cuda":
        raise ValueError(f"unsupported device {words[0].device}")
    return _mix_cuda([w.contiguous() for w in words])


def _mix_cuda(words: list[torch.Tensor]) -> list[torch.Tensor]:
    W = len(words)
    n = words[0].shape[0]
    out = list(torch.empty((W, n), dtype=torch.int32, device=words[0].device).unbind(0))
    if n == 0:
        return out
    lib = _build.lib()
    rc = (ctypes.c_uint32 * (_ROUNDS * W))(*_RC[: _ROUNDS * W])
    fix = (ctypes.c_uint32 * W)(*_sentinel_fix(W))
    with torch.cuda.device(words[0].device):
        status = lib.hk_mix_keys(
            _build.pointer_array(words), _build.pointer_array(out), W, n,
            rc, _ROUNDS, fix, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "mix_keys launch")
    _build.launches["mix_keys"] += 1
    return out


def range_destinations(mixed0: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Destination shard of each mixed key: (mixed[0] * S) >> 32.

    Monotone in mixed[0] (so destinations are contiguous segments of the
    sorted order) and uniform for any S (multiply-shift range partition).
    Taken from the 16-bit halves of mixed[0], as the JAX version computes
    it in uint32; requires num_shards <= 65536. Returns int32 values < S.
    """
    if not 1 <= num_shards <= 1 << 16:
        raise ValueError(f"num_shards must be in [1, 65536], got {num_shards}")
    v = widen(mixed0)
    a = (v >> 16) * num_shards
    b = (v & 0xFFFF) * num_shards
    return ((a + (b >> 16)) >> 16).to(torch.int32)


def range_boundaries(num_shards: int) -> np.ndarray:
    """boundaries[d] = smallest mixed[0] owned by shard d (length S+1).

    ceil(d * 2^32 / S); searchsorted(sorted_mixed0, boundaries) yields the
    per-destination segment offsets of a sorted shard.
    """
    d = np.arange(num_shards + 1, dtype=np.uint64)
    return ((d << np.uint64(32)) + np.uint64(num_shards - 1)) // np.uint64(
        num_shards
    )
