"""Minimizer scan: the destination bucket of every k-mer, and with a
validity mask the bucket sizes, a kernel of the slice on a CUDA tensor,
plain torch on a CPU tensor.

The port of hysortk_tpu/ops/minimizer.py, the TPU-native form of the
reference's sequential monotonic-deque window minimum (Minimizer_Deque,
src/kmerops.cpp:1058-1073; FindKmerDestinationsParallel, :1010-1041), and
of hysortk_tpu/parallel/dispatch.py bucket_sizes_device. Destinations steer
distribution only, never the counted output.

  kmer_destinations        on a CUDA tensor the hand-written kernel
                           csrc/minimizer_scan.cu (each thread rolls the
                           forward and reverse-complement m-mer of a strip of
                           positions in registers, the window minimum by van
                           Herk / Gil-Werman over whole segments a thread,
                           the modulo by a reciprocal, one pass); on a CPU
                           tensor kmer_destinations_plain;
  kmer_destinations_sized  the same scan that also counts the valid k-mers of
                           each bucket in its epilogue (the route's plan reads
                           only these sizes): on a CUDA tensor the same kernel
                           (shared-memory bins, warp-aggregated; global
                           atomics above its shared-memory cap), on a CPU
                           tensor kmer_destinations_sized_plain;
  kmer_destinations_plain  the JAX version's composition in torch: the
                           canonical m-mer words (ops/kmer.canonical_words),
                           their hash (hashes.mix_words), the minimum over
                           the k - m + 1 hashes inside each k-mer by
                           log2(window) shifted-min doubling steps
                           (sliding_window_min), the modulo.

Hashes are int32 tensors holding uint32 bit patterns (ops/kmer.widen), so
the window minimum compares them with the sign bit flipped and the bucket is
the unsigned modulo of the widened value. Like `jnp.roll` in the JAX
version, `torch.roll` wraps the codes and the hashes past the end of the
stream into the last k - 1 positions; the kernel reads the codes modulo n,
so it equals the plain version there too, and the sizes equal
`dispatch.bucket_sizes_device` of the plain buckets for any mask.
"""

from __future__ import annotations

import torch

from .. import _build
from . import count as count_ops
from . import hashes
from . import kmer as kmer_ops

_SIGN = -(2**31)  # XOR with it: the signed order of int32 words is unsigned
MAX_K = 96


def mmer_hashes(codes: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int32 hash (uint32 bits) of the canonical m-mer starting at each
    position of int8 codes, in plain torch on any device. Positions whose
    m-mer crosses a read boundary hold garbage; none lies inside the window
    of a valid k-mer (a valid k-mer at i spans m-mer starts i .. i + k - m,
    all inside its read)."""
    return hashes.mix_words(kmer_ops.canonical_words(codes, m))


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


def kmer_destinations_plain(
    codes: torch.Tensor, k: int, m: int, num_buckets: int
) -> torch.Tensor:
    """The plain PyTorch version of the scan kernel, on any device."""
    minh = sliding_window_min(mmer_hashes(codes, m), k - m + 1)
    return (kmer_ops.widen(minh) % num_buckets).to(torch.int32)


def kmer_destinations_sized_plain(
    codes: torch.Tensor, valid: torch.Tensor, k: int, m: int, num_buckets: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the sized scan, on any device: the
    plain scan, then the valid positions of each bucket
    (count.chunked_bincount, what dispatch.bucket_sizes_device runs)."""
    dest = kmer_destinations_plain(codes, k, m, num_buckets)
    return dest, count_ops.chunked_bincount(dest, valid, num_buckets)


def _check_scan_inputs(codes: torch.Tensor, k: int, m: int, num_buckets: int) -> None:
    if codes.dtype != torch.int8 or codes.dim() != 1:
        raise TypeError(f"need 1-D int8 codes, got {codes.dtype}{tuple(codes.shape)}")
    if not 0 < m < k <= MAX_K:
        raise ValueError(f"need 0 < m < k <= {MAX_K}, got k={k} m={m}")
    if not 1 <= num_buckets < 2**31:
        raise ValueError(f"need 1 <= num_buckets < 2^31, got {num_buckets}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")


def kmer_destinations(
    codes: torch.Tensor, k: int, m: int, num_buckets: int
) -> torch.Tensor:
    """(N,) int32 destination bucket of the k-mer starting at each position:
    (min canonical-m-mer hash over the k-mer's window) mod num_buckets, the
    reference's ownership rule (hash % tot_tasks, src/kmerops.cpp:1044-1047)
    with a 32-bit hash. Where no k-mer fits (i > N - k) the codes and hashes
    wrap past the end, as in the JAX version."""
    _check_scan_inputs(codes, k, m, num_buckets)
    if codes.device.type == "cpu":
        return kmer_destinations_plain(codes, k, m, num_buckets)
    return _scan_cuda(codes.contiguous(), None, k, m, num_buckets)[0]


def kmer_destinations_sized(
    codes: torch.Tensor, valid: torch.Tensor, k: int, m: int, num_buckets: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, sizes): kmer_destinations, and (num_buckets,) int32 valid
    k-mers per bucket, exactly dispatch.bucket_sizes_device(dest, valid,
    num_buckets), counted in the same pass. `valid` is (N,) bool."""
    _check_scan_inputs(codes, k, m, num_buckets)
    if valid.dtype != torch.bool or valid.shape != codes.shape:
        raise TypeError(f"need a bool mask of shape {tuple(codes.shape)}, got "
                        f"{valid.dtype}{tuple(valid.shape)}")
    if valid.device != codes.device:
        raise ValueError(f"codes on {codes.device}, valid on {valid.device}")
    if codes.device.type == "cpu":
        return kmer_destinations_sized_plain(codes, valid, k, m, num_buckets)
    return _scan_cuda(codes.contiguous(), valid.contiguous(), k, m, num_buckets)


def _scan_cuda(codes: torch.Tensor, valid: torch.Tensor | None, k: int, m: int,
               num_buckets: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    n = codes.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=codes.device)
    sizes = None
    if valid is not None:
        sizes = torch.empty(num_buckets, dtype=torch.int32, device=codes.device)
        if n == 0:
            sizes.zero_()
    if n == 0:
        return out, sizes
    # Lemire's fastmod reciprocal, floor((2^64 - 1) / d) + 1 mod 2^64.
    recip = ((2**64 - 1) // num_buckets + 1) % 2**64
    lib = _build.lib()
    with torch.cuda.device(codes.device):
        status = lib.hk_minimizer_scan(
            codes.data_ptr(), None if valid is None else valid.data_ptr(), n, k, m,
            num_buckets, recip, out.data_ptr(), None if sizes is None else sizes.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "minimizer scan launch")
    _build.launches["minimizer_scan"] += 1
    return out, sizes
