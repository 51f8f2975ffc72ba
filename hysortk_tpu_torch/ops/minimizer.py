"""Minimizer scan: the destination bucket of every k-mer, vectorized.

The port of hysortk_tpu/ops/minimizer.py, the TPU-native form of the
reference's sequential monotonic-deque window minimum (Minimizer_Deque,
src/kmerops.cpp:1058-1073; FindKmerDestinationsParallel, :1010-1041): the
minimum over the k - m + 1 canonical m-mer hashes inside each k-mer is taken
by log2(window) shifted-min doubling steps. Destinations steer distribution
only, never the counted output.

Hashes are int32 tensors holding uint32 bit patterns (ops/kmer.widen), so
the window minimum compares them with the sign bit flipped and the bucket is
the unsigned modulo of the widened value. Like `jnp.roll` in the JAX
version, `torch.roll` wraps garbage into the last k - m slots of the stream;
no valid k-mer's window reaches them.

The canonical m-mer words come from ops/keybuild.canonical_keys_fused with
every slot valid (the key-build kernel on a CUDA tensor, its plain version
on a CPU tensor); the kernel takes m > 2, and m <= 2 takes the plain
ops/kmer.canonical_words on either device.
"""

from __future__ import annotations

import torch

from . import hashes, keybuild
from . import kmer as kmer_ops

_SIGN = -(2**31)  # XOR with it: the signed order of int32 words is unsigned


def mmer_hashes(codes: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int32 hash (uint32 bits) of the canonical m-mer starting at each
    position of int8 codes. Positions whose m-mer crosses a read boundary
    hold garbage; none lies inside the window of a valid k-mer (a valid
    k-mer at i spans m-mer starts i .. i + k - m, all inside its read)."""
    if m > 2:
        words = keybuild.canonical_keys_fused(
            codes, torch.ones_like(codes, dtype=torch.bool), m)
    else:
        words = kmer_ops.canonical_words(codes, m)
    return hashes.mix_words(words)


def sliding_window_min(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[i] = unsigned min(x[i], ..., x[i + window - 1]) of int32 words
    (uint32 bits) by doubling min-rolls; the tail wraps as in the JAX
    version."""
    out = x ^ _SIGN
    cur = 1
    while cur < window:
        step = min(cur, window - cur)
        out = torch.minimum(out, torch.roll(out, -step))
        cur += step
    return out ^ _SIGN


def kmer_destinations(
    codes: torch.Tensor, k: int, m: int, num_buckets: int
) -> torch.Tensor:
    """(N,) int32 destination bucket of the k-mer starting at each position:
    (min canonical-m-mer hash over the k-mer's window) mod num_buckets, the
    reference's ownership rule (hash % tot_tasks, src/kmerops.cpp:1044-1047)
    with a 32-bit hash."""
    minh = sliding_window_min(mmer_hashes(codes, m), k - m + 1)
    return (kmer_ops.widen(minh) % num_buckets).to(torch.int32)
