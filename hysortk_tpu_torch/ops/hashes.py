"""Hash mixers: the murmur3 32-bit finalizer and the word combiner, in
plain torch and in numpy, and the host hashes of the reference.

The port of hysortk_tpu/ops/hashes.py. `fmix32` is the mixing step of the
invertible key mix (ops/mixkey.py); `mix_words` folds W key words into one
hash, which steers the bucketed routings (ops/minimizer.py's m-mer hashes,
the kmer_hash destination). Hashes only steer distribution, never the
counted output. The host hashes at the end (murmurhash3_64, wanghash64 and
its inverse, superfasthash) are plain Python copies, for parity with the
reference's hash library (src/hashfuncs.cpp).

torch has no uint32 arithmetic. Words travel as int32 tensors holding uint32
bit patterns (ops/kmer.widen / narrow), and the 32 x 32-bit products are
taken modulo 2^32 from the constant's two 16-bit halves, so no int64
product overflows: x * c = x * lo + ((x * hi) mod 2^16) * 2^16 (mod 2^32),
with both partial products below 2^48.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .kmer import narrow, widen

_MASK32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLDEN = 0x9E3779B1  # the hash_combine round of mix_words
ROUND_ADD = 0xE6546B64
SEED = 313  # kept as a nod to the reference's murmur seed


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


def mix_words(words: Sequence[torch.Tensor], seed: int = SEED) -> torch.Tensor:
    """Combine W int32 words (uint32 bit patterns) into one well-mixed hash:
    h = seed; per word h = (h ^ fmix32(w)) * GOLDEN + ROUND_ADD; then
    fmix32(h), all mod 2^32. Returns int32 words (uint32 bit patterns)."""
    h = torch.full(words[0].shape, seed & _MASK32, dtype=torch.int64,
                   device=words[0].device)
    for w in words:
        h = h ^ fmix32_wide(widen(w))
        h = (mul32(h, GOLDEN) + ROUND_ADD) & _MASK32
    return narrow(fmix32_wide(h))


def mix_words_np(words: Sequence[np.ndarray], seed: int = SEED) -> np.ndarray:
    """mix_words of uint32 numpy arrays (uint32 arithmetic wraps)."""
    h = np.full(np.shape(words[0]), seed & _MASK32, dtype=np.uint32)
    for w in words:
        h = h ^ fmix32_np(w)
        h = (h * np.uint32(GOLDEN) + np.uint32(ROUND_ADD)).astype(np.uint32)
    return fmix32_np(h)


# ---------------------------------------------------------------------------
# Host-side hash parity with the reference's hashfuncs (include/hashfuncs.hpp:
# 9-16, src/hashfuncs.cpp:42-252): the murmur3 x64 64-bit hash, the Wang
# 64-bit invertible hash and its inverse, SuperFastHash. For
# reproducibility tooling and tests; device routing uses the 32-bit mixers
# above.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def murmurhash3_64(data: bytes, seed: int = SEED) -> int:
    """MurmurHash3 x64-128 of `data`, first 64 bits: the reference's
    murmurhash3_64 wrapper (src/hashfuncs.cpp)."""
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    mask = _MASK64

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & mask

    def fmix(kx):
        kx ^= kx >> 33
        kx = (kx * 0xFF51AFD7ED558CCD) & mask
        kx ^= kx >> 33
        kx = (kx * 0xC4CEB9FE1A85EC53) & mask
        kx ^= kx >> 33
        return kx

    length = len(data)
    h1 = h2 = seed & mask
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16: i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8: i * 16 + 16], "little")
        k1 = rotl((k1 * c1) & mask, 31)
        h1 ^= (k1 * c2) & mask
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & mask
        h1 = (h1 * 5 + 0x52DCE729) & mask
        k2 = rotl((k2 * c2) & mask, 33)
        h2 ^= (k2 * c1) & mask
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & mask
        h2 = (h2 * 5 + 0x38495AB5) & mask

    tail = data[nblocks * 16:]
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = rotl((k2 * c2) & mask, 33)
        h2 ^= (k2 * c1) & mask
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = rotl((k1 * c1) & mask, 31)
        h1 ^= (k1 * c2) & mask

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask
    h1 = fmix(h1)
    h2 = fmix(h2)
    return (h1 + h2) & mask


def wanghash64(key: int) -> int:
    """Wang's 64-bit invertible integer hash (reference src/hashfuncs.cpp)."""
    mask = _MASK64
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def wanghash64_inv(key: int) -> int:
    """The exact inverse of wanghash64: each step undone in reverse order
    (a multiply by its inverse mod 2^64, an xor-shift by its ladder)."""
    mask = _MASK64
    key = (key * pow(1 + (1 << 31), -1, 1 << 64)) & mask   # key + (key << 31)
    key = key ^ (key >> 28) ^ (key >> 56)                    # key ^= key >> 28
    key = (key * pow(21, -1, 1 << 64)) & mask                # key * (1 + 4 + 16)
    key = key ^ (key >> 14) ^ (key >> 28) ^ (key >> 42) ^ (key >> 56)
    key = (key * pow(265, -1, 1 << 64)) & mask               # key * (1 + 8 + 256)
    key = key ^ (key >> 24) ^ (key >> 48)                    # key ^= key >> 24
    return ((key + 1) * pow((1 << 21) - 1, -1, 1 << 64)) & mask  # ~key + (key << 21)


def superfasthash(data: bytes) -> int:
    """Paul Hsieh's SuperFastHash, which the reference ships in its hash
    library (src/hashfuncs.cpp:132-175) and never calls: 16-bit
    little-endian block mixing, a 3/2/1-byte tail, the final avalanche. The
    tail byte is a signed char in the original; bytes here are unsigned,
    the same for ASCII input."""
    n = len(data)
    if n == 0:
        return 0
    mask = _MASK32
    h = n & mask

    def get16(i):
        return data[i] | (data[i + 1] << 8)

    i = 0
    for _ in range(n >> 2):
        h = (h + get16(i)) & mask
        tmp = ((get16(i + 2) << 11) ^ h) & mask
        h = ((h << 16) ^ tmp) & mask
        h = (h + (h >> 11)) & mask
        i += 4
    rem = n & 3
    if rem == 3:
        h = (h + get16(i)) & mask
        h ^= (h << 16) & mask
        h ^= (data[i + 2] << 18) & mask
        h = (h + (h >> 11)) & mask
    elif rem == 2:
        h = (h + get16(i)) & mask
        h ^= (h << 11) & mask
        h = (h + (h >> 17)) & mask
    elif rem == 1:
        h = (h + data[i]) & mask
        h ^= (h << 10) & mask
        h = (h + (h >> 1)) & mask
    h ^= (h << 3) & mask
    h = (h + (h >> 5)) & mask
    h ^= (h << 4) & mask
    h = (h + (h >> 17)) & mask
    h ^= (h << 25) & mask
    h = (h + (h >> 6)) & mask
    return h
