"""Brute-force oracles for tests (pure Python/numpy, no JAX).

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
