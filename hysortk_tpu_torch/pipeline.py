"""Single-device end-to-end k-mer counting pipeline in PyTorch.

The port of hysortk_tpu/pipeline.py's single-device path. The device
computation mirrors the reference's three phases (kmer_count,
src/hysortk.cpp:36-95):

  prepare  canonical keys              ops/keybuild.canonical_keys_fused
  sort     multiword key sort          ops/radix_sort.sort_words
  count    run length + [L,U] filter   ops/fused_count.run_length_count_filter

On a CUDA device each step is a hand-written kernel; on the CPU each is its
plain PyTorch version. The device is always explicit: asking for CUDA where
there is none raises, and nothing moves to the CPU by itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import KmerConfig
from .ops import fused_count
from .ops import keybuild
from .ops import kmer as kmer_ops
from .ops import radix_sort
from .ops import wire


@dataclasses.dataclass
class KmerList:
    """Filtered {kmer, count} result on host.

    keys:   (M, W) uint32 packed canonical keys
    counts: (M,) int32 frequencies, all within [lower, upper]
    Laid out as hysortk_tpu.pipeline.KmerList (reference KmerListS,
    include/kmer.hpp:348-360), so the two compare with np.array_equal.
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.decoded().tolist(), self.counts.tolist()))


def resolve_device(device) -> torch.device:
    """torch.device of `device`; raises where CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _count_core(
    codes: torch.Tensor, valid: torch.Tensor, k: int, lower: int, upper: int
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """codes (N,) int8, valid (N,) bool -> sorted key words, counts, keep."""
    marked = keybuild.canonical_keys_fused(codes, valid, k)
    words_s, _ = radix_sort.sort_words(marked)
    cnt, keep = fused_count.run_length_count_filter(words_s, lower, upper)
    return words_s, cnt, keep


def compact_keys(
    words: list[torch.Tensor], cnt: torch.Tensor, keep: torch.Tensor, k: int
) -> KmerList:
    """Gather the kept rows on the device, then copy only those to the host."""
    idx = torch.nonzero(keep).squeeze(1)
    keys = torch.stack([w[idx] for w in words], dim=-1)
    return KmerList(
        keys=keys.cpu().numpy().view(np.uint32),
        counts=cnt[idx].cpu().numpy(),
        k=k,
    )


def host_histogram(counts: np.ndarray, upper: int) -> np.ndarray:
    """hist[c] = number of kept kmers with frequency c (c in [0, upper])."""
    return np.bincount(
        np.asarray(counts, dtype=np.int64), minlength=upper + 1
    ).astype(np.int32)[: upper + 1]


def count_flat(
    codes: np.ndarray, valid: np.ndarray, cfg: KmerConfig, device="cuda"
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers of a flat batch. Returns (list, histogram)."""
    dev = resolve_device(device)
    words, cnt, keep = _count_core(
        torch.as_tensor(np.asarray(codes, dtype=np.int8)).to(dev),
        torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev),
        cfg.k, cfg.lower, cfg.upper,
    )
    kmerlist = compact_keys(words, cnt, keep, cfg.k)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def device_batch(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host reads -> (codes int8 (n,), valid bool (n,)) on the device.

    Pads to cfg.pad_multiple (at least 16 spare slots), packs 2 bits/base on
    the host (io/supermer.pack_codes_2bit), copies ~2 bits/base + 4 B/read
    to the device and decodes there (ops/wire.decode_block)."""
    from .io import supermer as supermer_io

    dev = resolve_device(device)
    total = int(codes.size)
    pad = cfg.pad_multiple
    n = -(-(total + 16) // pad) * pad
    buf = np.zeros(n, dtype=np.int8)
    buf[:total] = codes
    packed = supermer_io.pack_codes_2bit(buf)
    return wire.decode_block(
        torch.from_numpy(packed.view(np.int32)).to(dev),
        torch.from_numpy(np.asarray(lengths).astype(np.int32)).to(dev),
        cfg.k,
        n,
    )


def count_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Full single-device pipeline from host reads, fed over the 2-bit
    packed wire (`device_batch`)."""
    codes_d, valid_d = device_batch(codes, lengths, cfg, device)
    words, cnt, keep = _count_core(
        codes_d, valid_d, cfg.k, cfg.lower, cfg.upper
    )
    kmerlist = compact_keys(words, cnt, keep, cfg.k)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)
