"""Brute-force oracles for tests (pure Python/numpy, no JAX), the carriers
of streaming state between the JAX package and this one, and the sorts' hard
input cases (numpy from a seed).

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


# --------------------------------------------------------------------------
# The sorts' hard inputs, in one place: the CPU tests run them at a small
# tile through the plain versions, the card runs them at the kernels' tiles.

SORT_TILE = 8192  # slots per tile of csrc/radix_sort.cu's pass kernel
FUSED_SORT_TILES = {1: 8192, 2: 8192, 3: 4096, 4: 4096, 5: 4096, 6: 4096}
SORT_KINDS = ("random", "all_equal", "one_digit", "sentinel_tail")


def sort_case_sizes(tile: int) -> list[int]:
    """One slot, a ragged single tile, exactly one, one slot more, and
    several tiles with a ragged last one."""
    return [1, tile - 1, tile, tile + 1, 3 * tile + 17]


def sort_case_words(kind: str, n: int, n_words: int, seed: int) -> np.ndarray:
    """(n_words, n) uint32 key words.

    random         full-range words, a quarter of the slots exact duplicates
    all_equal      one key in every slot: every pass puts a whole tile in
                   one digit, and only stability keeps payloads in order
    one_digit      keys that differ in one byte only (the second lowest of
                   the last word): every pass but one sees a constant digit
    sentinel_tail  random, then the all-ones sentinel in the last eighth
    """
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    if kind == "random" or kind == "sentinel_tail":
        dup = rng.integers(0, n, n // 4)
        words[:, dup] = words[:, rng.integers(0, min(n, 16), n // 4)]
        if kind == "sentinel_tail":
            words[:, n - n // 8:] = 0xFFFFFFFF
    elif kind == "all_equal":
        words[:] = words[:, :1]
    elif kind == "one_digit":
        words[:] = words[:, :1] & np.uint32(0xFFFF00FF)
        words[-1] |= rng.integers(0, 256, n).astype(np.uint32) << np.uint32(8)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return words


def sort_cases(tile: int = SORT_TILE) -> list[tuple[str, str, int, int, int]]:
    """(name, kind, n, n_words, n_payloads) of every case: each kind at each
    size (two key words, keys only), every key width with two payload rows,
    and six payload rows (eight rows in all) at one and two key words.
    Payload rows are arange rows, so the sorted payloads show the order."""
    cases = [(kind, n, 2, 0) for kind in SORT_KINDS for n in sort_case_sizes(tile)]
    cases += [("sentinel_tail", 3 * tile + 17, w, 2) for w in range(1, 7)]
    cases += [("one_digit", tile + 1, w, 6) for w in (1, 2)]
    cases += [("all_equal", 3 * tile + 17, 1, 2), ("all_equal", 2 * tile, 2, 6)]
    return [(f"{kind}-n{n}-w{w}-p{p}", kind, n, w, p) for kind, n, w, p in cases]


def sort_case_payloads(n: int, n_payloads: int) -> np.ndarray:
    """(n_payloads, n) uint32: row j is arange(n) + j."""
    return (np.arange(n, dtype=np.uint32)[None, :]
            + np.arange(n_payloads, dtype=np.uint32)[:, None])


def stable_order(words: np.ndarray) -> np.ndarray:
    """The permutation of a stable lexicographic sort (word 0 most
    significant, unsigned): numpy's lexsort is stable."""
    return np.lexsort(tuple(np.asarray(words)[::-1]))


FUSED_SORT_KINDS = ("random", "poly_a", "sentinel_tail")


def fused_sort_case_codes(kind: str, n: int, k: int, seed: int):
    """(codes (n,) int8, valid (n,) bool) for the fused sort.

    random         random codes, invalid runs and lone invalid slots
    poly_a         one base everywhere and every slot valid that has k
                   bases after it: all keys equal
    sentinel_tail  random, the last eighth invalid
    The last k - 1 slots are always invalid (no k-mer starts there).
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    valid = np.ones(n, dtype=bool)
    if kind == "random":
        valid = rng.random(n) < 0.9
        for start in rng.integers(0, n, 5):
            valid[start:start + 40] = False
    elif kind == "poly_a":
        codes[:] = 0
    elif kind == "sentinel_tail":
        valid[n - n // 8:] = False
    else:
        raise ValueError(f"unknown kind {kind!r}")
    valid[max(n - (k - 1), 0):] = False
    return codes, valid


def fused_sort_cases(tiles=None) -> list[tuple[str, str, int, int]]:
    """(name, kind, n, k): each kind at each size at K = 31, and K = 15, 55
    and 96 (one, four and six key words) at the ragged multi-tile size.
    `tiles` maps a key width to its tile (FUSED_SORT_TILES by default)."""
    tiles = FUSED_SORT_TILES if tiles is None else tiles
    cases = [(kind, n, 31) for kind in FUSED_SORT_KINDS
             for n in sort_case_sizes(tiles[2])]
    cases += [(kind, 3 * tiles[-(-k // 16)] + 17, k)
              for k in (15, 55, 96) for kind in FUSED_SORT_KINDS]
    return [(f"{kind}-n{n}-k{k}", kind, n, k) for kind, n, k in cases]
