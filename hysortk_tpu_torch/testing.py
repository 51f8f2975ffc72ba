"""Brute-force oracles for tests (pure Python/numpy, no JAX), and the
carriers of streaming state between the JAX package and this one.

A copy of hysortk_tpu/testing.py's counting oracle, so that checks on a
machine without JAX have an independent reference.

Defines the ground-truth semantics the device pipeline must reproduce:
canonical k-mer = lexicographic min(seq, revcomp(seq)) with A<C<G<T and
N (or any non-ACGT char) read as A — exactly the reference's behavior
(include/kmer.hpp GetRep + include/dnaseq.hpp codetab).
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np
import torch

_COMP = str.maketrans("ACGT", "TGCA")


def normalize(read: str) -> str:
    """Uppercase and map non-ACGT to A (reference dnaseq.hpp codetab)."""
    s = read.upper()
    return "".join(ch if ch in "ACGT" else "A" for ch in s)


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canonical(s: str) -> str:
    rc = revcomp(s)
    return s if s <= rc else rc


def oracle_counts(reads: Sequence[str], k: int) -> Counter:
    """Unfiltered canonical k-mer counts."""
    counts: Counter = Counter()
    for read in reads:
        s = normalize(read)
        for i in range(len(s) - k + 1):
            counts[canonical(s[i : i + k])] += 1
    return counts


def oracle_filtered(
    reads: Sequence[str], k: int, lower: int, upper: int
) -> dict[str, int]:
    """[L, U]-filtered counts: the reference's final KmerList content."""
    return {
        kmer: c
        for kmer, c in oracle_counts(reads, k).items()
        if lower <= c <= upper
    }


def oracle_histogram(filtered: dict[str, int]) -> dict[int, int]:
    """count -> number of kmers with that count (print_kmer_histogram)."""
    hist: Counter = Counter(filtered.values())
    return dict(hist)


def random_reads(
    rng, n_reads: int, min_len: int, max_len: int, alphabet: str = "ACGT"
) -> list[str]:
    lens = rng.integers(min_len, max_len + 1, size=n_reads)
    return [
        "".join(rng.choice(list(alphabet), size=l)) for l in lens
    ]


def partials_from_numpy(
    keys: np.ndarray, counts: np.ndarray, run_len: int | None = None,
    device="cpu",
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """A host partial list, as both packages' streaming schedulers hold it
    (keys (M, W) uint32 ascending, counts (M,) any integer type), as the
    device form of this package: W int32 word tensors and an int32 counts
    tensor. With `run_len` the rows are padded to one sorted run of that
    length (all-ones sentinel keys, zero counts)."""
    keys = np.asarray(keys, dtype=np.uint32)
    m, n_words = keys.shape
    size = m if run_len is None else run_len
    if size < m:
        raise ValueError(f"{m} rows do not fit a run of {run_len}")
    words = np.full((n_words, size), 0xFFFFFFFF, dtype=np.uint32)
    words[:, :m] = keys.T
    cnts = np.zeros(size, dtype=np.int32)
    cnts[:m] = np.asarray(counts).astype(np.int32)
    dev = torch.device(device)
    return (
        [torch.from_numpy(w.view(np.int32)).to(dev) for w in words],
        torch.from_numpy(cnts).to(dev),
    )


def partials_to_numpy(
    words: Sequence[torch.Tensor], counts: torch.Tensor, n_kept: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The inverse: the first n_kept rows (all of them by default) as
    (keys (M, W) uint32, counts (M,) int32)."""
    keys = np.stack([w.cpu().numpy() for w in words], axis=-1).view(np.uint32)
    cnts = counts.cpu().numpy().astype(np.int32)
    return keys[:n_kept], cnts[:n_kept]
