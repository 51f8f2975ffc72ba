"""Packed canonical k-mer key construction in plain PyTorch.

The port of hysortk_tpu/ops/kmer.py, bit for bit. Every k-mer key of the
flat base stream is built at once: `sliding_pack16` packs the 16 bases
starting at each position big-endian into one word (4 shift-OR doubling
steps), a key is W = ceil(k/16) such words sampled 16 apart with the last
word cut to its top 2r bits, the reverse complement ("twin", reference
kmer.hpp GetTwin) comes from crumb reversal + complement + a multiword left
shift, and the canonical key is the lexicographic min of the two (reference
GetRep, include/kmer.hpp:316-321).

Key words travel between functions as torch.int32 tensors holding uint32 bit
patterns. torch has no shifts or order comparisons on torch.uint32, and int32
`>>` is arithmetic, so every function here widens its words to int64 in
[0, 2^32) (`widen`) before any shift or compare, and hands int32 back
(`narrow`). Like `jnp.roll` in the JAX version, `torch.roll` wraps at the
stream tail; those positions are never valid k-mer starts.

The hand-written CUDA kernel that computes the same keys in one pass is
ops/keybuild.py; these functions are its plain version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 words holding uint32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _MASK32


def narrow(values: torch.Tensor) -> torch.Tensor:
    """int64 values (any, taken mod 2^32) -> int32 words with the same low
    32 bits. Exact on every backend: the value is first brought into the
    int32 range, so no out-of-range conversion happens."""
    v = values & _MASK32
    return (v - ((v >> 31) << 32)).to(torch.int32)


def sliding_pack16(codes: torch.Tensor) -> torch.Tensor:
    """For each position i, pack bases codes[i..i+15] big-endian into a word.

    codes: (N,) integer tensor with values in [0, 3]. Returns (N,) int32;
    entries within 15 of the end hold wrapped garbage.
    """
    p = codes.to(torch.int64)
    p = ((p << 2) | torch.roll(p, -1)) & _MASK32   # 2 bases
    p = ((p << 4) | torch.roll(p, -2)) & _MASK32   # 4 bases
    p = ((p << 8) | torch.roll(p, -4)) & _MASK32   # 8 bases
    p = ((p << 16) | torch.roll(p, -8)) & _MASK32  # 16 bases
    return narrow(p)


def forward_words(pack16: torch.Tensor, k: int) -> list[torch.Tensor]:
    """W int32 words of the forward k-mer key starting at each position."""
    w_count = (k + 15) // 16
    r = k - 16 * (w_count - 1)  # bases in the last word, 1..16
    words = []
    for w in range(w_count):
        word = pack16 if w == 0 else torch.roll(pack16, -16 * w)
        if w == w_count - 1 and r < 16:
            word = narrow(widen(word) & ((_MASK32 << (32 - 2 * r)) & _MASK32))
        words.append(word)
    return words


def _crumb_reverse_wide(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 16) | (x << 16)) & _MASK32
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    return x


def crumb_reverse32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each int32 word."""
    return narrow(_crumb_reverse_wide(widen(x)))


def twin_words(fwd: Sequence[torch.Tensor], k: int) -> list[torch.Tensor]:
    """Reverse-complement key words from the forward key words.

    Matches reference GetTwin (include/kmer.hpp:269-299): the complement of a
    2-bit code is its bitwise NOT, and the reversed stream is realigned so
    the first twin base sits at the top of word 0.
    """
    w_count = len(fwd)
    rev = [
        _crumb_reverse_wide(widen(fwd[w_count - 1 - w])) ^ _MASK32
        for w in range(w_count)
    ]
    shift = 32 * w_count - 2 * k
    if shift == 0:
        return [narrow(r) for r in rev]
    out = []
    for w in range(w_count):
        hi = (rev[w] << shift) & _MASK32
        lo = rev[w + 1] >> (32 - shift) if w + 1 < w_count else 0
        out.append(narrow(hi | lo))
    return out


def lex_less(
    a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Elementwise lexicographic a < b over int32 word lists, each word read
    as unsigned (word 0 most significant)."""
    less = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for aw, bw in zip(a, b):
        aw, bw = widen(aw), widen(bw)
        less = less | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return less


def canonical_words(codes: torch.Tensor, k: int) -> list[torch.Tensor]:
    """Canonical (min of forward/revcomp) packed key words at every position."""
    p16 = sliding_pack16(codes)
    fwd = forward_words(p16, k)
    twn = twin_words(fwd, k)
    t_less = lex_less(twn, fwd)
    return [torch.where(t_less, tw, fw) for fw, tw in zip(fwd, twn)]


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers: decode packed keys to ASCII, encode strings.
# Used by writers, tests and tooling — not on the device hot path.
# ---------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, W) uint32 packed keys -> (N,) array of length-k ASCII bytes objects.

    Inverse of the packing above; equivalent to reference Kmer::GetString
    (include/kmer.hpp:147-163) modulo the 32- vs 64-bit word layout.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    from ..io import native

    if n >= 4096 and native.available():
        out = native.decode_keys(keys, k)
        if out is not None:
            return out
    chars = np.empty((n, k), dtype=np.uint8)
    for i in range(k):
        w, j = divmod(i, 16)
        code = (keys[:, w] >> np.uint32(2 * (15 - j))) & np.uint32(3)
        chars[:, i] = _BASES[code]
    return chars.view(f"S{k}").reshape(n)


def encode_kmer(s: str) -> np.ndarray:
    """ASCII k-mer -> (W,) uint32 packed key (host-side oracle helper)."""
    k = len(s)
    w_count = (k + 15) // 16
    out = np.zeros(w_count, dtype=np.uint32)
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 0}
    for i, ch in enumerate(s.upper()):
        w, j = divmod(i, 16)
        out[w] |= np.uint32(code[ch] << (2 * (15 - j)))
    return out


def extend_kmer(key: np.ndarray, code: int, k: int) -> np.ndarray:
    """Shift one base into packed (..., W) uint32 forward keys: the rolling
    k-mer step next = ((kmer << 2) | code) cut to k bases
    (reference Kmer::GetExtension, include/kmer.hpp:248-262). Layout as
    encode_kmer: base 0 in the top crumb of word 0, the last word's unused
    low bits zero. numpy only (the JAX version also takes jax arrays)."""
    w_count = (k + 15) // 16
    if key.shape[-1] != w_count:
        raise ValueError(f"need {w_count} words for k={k}, got {key.shape}")
    key = np.asarray(key, dtype=np.uint32)
    shifted = [key[..., i] << np.uint32(2) for i in range(w_count)]
    for i in range(w_count - 1):
        shifted[i] = shifted[i] | (key[..., i + 1] >> np.uint32(30))
    # The new base at position k - 1, then the tail word cut to its bases.
    w, j = divmod(k - 1, 16)
    shifted[w] = shifted[w] | np.uint32((int(code) & 3) << (2 * (15 - j)))
    r_last = k - 16 * (w_count - 1)
    if r_last < 16:
        shifted[-1] = shifted[-1] & np.uint32(
            (_MASK32 << (32 - 2 * r_last)) & _MASK32)
    return np.stack(shifted, axis=-1)
