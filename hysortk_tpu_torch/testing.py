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

import functools
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from .ops.merge import FAN_IN as MERGE_FAN_IN
from .ops.merge import TILE as MERGE_TILE

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


# --------------------------------------------------------------------------
# The run-length count's hard inputs, by the kernel's tile: runs against tile
# edges, tiles without a boundary (what the look-back has to step over),
# sentinel tails on and beside a tile edge, ragged sizes.

COUNT_TILE = 4096  # slots per tile of csrc/fused_count.cu
COUNT_LOWER, COUNT_UPPER = 3, 7


def _small_runs(rng, total: int) -> list[int]:
    """Run lengths of 1..9 slots that add up to `total`."""
    runs = rng.integers(1, 10, total).tolist() if total > 0 else []
    out, left = [], total
    for r in runs:
        if left <= 0:
            break
        out.append(min(r, left))
        left -= out[-1]
    return out


def count_cases(tile: int = COUNT_TILE) -> list[tuple[str, list[int], int, int, int, int]]:
    """(name, run lengths, sentinel slots, n_words, lower, upper) of every
    case; count_case_words turns the first three into sorted key words."""
    rng = np.random.default_rng(tile)
    lo, up = COUNT_LOWER, COUNT_UPPER
    long_run = [5, 3 * tile + 7] + _small_runs(rng, tile // 2)
    cases = [
        ("run_spans_tiles", long_run, 37, 2, lo, up),
        # tiles 1 .. 5 hold no boundary at all
        ("tiles_without_boundary",
         _small_runs(rng, tile - 3) + [5 * tile + 3] + _small_runs(rng, 40),
         tile // 4, 2, lo, up),
        # boundaries at 0, T-1, T, 2T-1, 2T, 3T, 4T-1 and the tail's at 4T
        ("boundary_on_tile_edges",
         [tile - 1, 1, tile - 1, 1, tile, tile - 1, 1], 5, 2, lo, up),
        ("all_sentinel", [], tile + 5, 2, lo, up),
        ("one_sentinel_slot", [], 1, 1, lo, up),
        ("no_sentinel", _small_runs(rng, 2 * tile + 100), 0, 2, lo, up),
        ("one_run", [2 * tile + 9], 0, 2, lo, up),
        ("one_run_then_tail", [tile + 1], 2 * tile, 2, lo, up),
        ("at_lower_and_upper",
         [lo, up, lo - 1, up + 1] * (tile // 8) + [1, 2], 64, 2, lo, up),
        # what the streaming scheduler asks for: every head kept
        ("streaming_bounds", long_run, 37, 2, 1, 2**31 - 1),
    ]
    for d in (-1, 0, 1):
        cases.append((f"tail_from_tile_edge{d:+d}",
                      _small_runs(rng, 2 * tile + d), tile + 3, 2, lo, up))
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 17):
        tail = n // 8
        cases.append((f"size{n}", _small_runs(rng, n - tail), tail, 2, lo, up))
    for w in (1, 3, 4, 5, 6):
        cases.append((f"width{w}",
                      _small_runs(rng, tile - 2) + [tile + 5, 1, 2]
                      + _small_runs(rng, tile), tile // 2 + 1, w, lo, up))
    return cases


def count_case_words(runs: Sequence[int], n_sentinel: int, n_words: int,
                     seed: int) -> np.ndarray:
    """(n_words, n) uint32: distinct ascending keys repeated by `runs` (many
    with the top bit set; with several words, half of them differ in the last
    word only), then n_sentinel all-ones slots."""
    rng = np.random.default_rng(seed)
    n_runs = len(runs)
    keys = rng.integers(0, 2**32, (2 * n_runs + 8, n_words),
                        dtype=np.uint64).astype(np.uint32)
    keys[::2, :-1] = keys[0, :-1]
    keys = np.unique(keys[~(keys == 0xFFFFFFFF).all(axis=1)], axis=0)
    keys = keys[np.sort(rng.choice(keys.shape[0], n_runs, replace=False))]
    body = np.repeat(keys, np.asarray(runs, dtype=np.int64), axis=0).T
    tail = np.full((n_words, n_sentinel), 0xFFFFFFFF, dtype=np.uint32)
    return np.ascontiguousarray(np.concatenate([body, tail], axis=1))


# --------------------------------------------------------------------------
# The weighted run-length sum's hard inputs, by the kernel's tile: the
# count's (runs against tile edges, tiles without a boundary, sentinel tails
# on and beside a tile edge, ragged sizes, every width), a walk over more
# than one window of 32 descriptors, int32 totals that wrap while their run
# spans tiles, zero and negative weights, and weights on sentinel slots.

SUM_TILE = 4096  # slots per tile of csrc/run_length_sum.cu
SUM_WEIGHT_KINDS = ("counts", "wrap", "signed")


def sum_cases(tile: int = SUM_TILE) -> list[tuple[str, list[int], int, int, str]]:
    """(name, run lengths, sentinel slots, n_words, weight kind) of every
    case; count_case_words turns the first three into sorted key words,
    sum_case_weights the runs and the kind into weights."""
    rng = np.random.default_rng(tile + 1)
    cases = [
        ("run_spans_tiles", [5, 3 * tile + 7] + _small_runs(rng, tile // 2), 37, 2,
         "counts"),
        # tiles 1 .. 5 hold no boundary at all
        ("tiles_without_boundary",
         _small_runs(rng, tile - 3) + [5 * tile + 3] + _small_runs(rng, 40),
         tile // 4, 2, "counts"),
        # tiles 1 .. 41 hold no boundary: a walk over two windows
        ("long_walk",
         _small_runs(rng, tile // 2) + [42 * tile + 9] + _small_runs(rng, tile),
         17, 2, "counts"),
        # boundaries at 0, T-1, T, 2T-1, 2T, 3T, 4T-1 and the tail's at 4T
        ("boundary_on_tile_edges",
         [tile - 1, 1, tile - 1, 1, tile, tile - 1, 1], 5, 2, "counts"),
        ("all_sentinel", [], tile + 5, 2, "counts"),
        ("one_sentinel_slot", [], 1, 1, "counts"),
        ("no_sentinel", _small_runs(rng, 2 * tile + 100), 0, 2, "counts"),
        ("one_run", [2 * tile + 9], 0, 2, "counts"),
        ("wrap_across_tiles",
         [2 * tile + 9] + _small_runs(rng, tile) + [3 * tile + 5]
         + _small_runs(rng, tile // 2), 29, 2, "wrap"),
        ("signed_weights",
         [tile + 3] + _small_runs(rng, 2 * tile) + [2 * tile + 1]
         + _small_runs(rng, tile // 2), tile // 3, 2, "signed"),
    ]
    for d in (-1, 0, 1):
        cases.append((f"tail_from_tile_edge{d:+d}",
                      _small_runs(rng, 2 * tile + d), tile + 3, 2, "counts"))
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 17):
        tail = n // 8
        cases.append((f"size{n}", _small_runs(rng, n - tail), tail, 2, "counts"))
    for w in (1, 3, 4, 5, 6):
        cases.append((f"width{w}",
                      _small_runs(rng, tile - 2) + [tile + 5, 1, 2]
                      + _small_runs(rng, tile), tile // 2 + 1, w, "counts"))
    return cases


def sum_case_weights(kind: str, runs: Sequence[int], n_sentinel: int,
                     seed: int) -> np.ndarray:
    """(n,) int32 weights on every slot, the sentinel tail included (there
    they must count 0).

    counts  1 .. 65535, as the streaming merge's counts
    wrap    counts, but a run of 64 slots or more weighs 2^29 .. 2^31 - 1 a
            slot, so its int32 total wraps many times: the first run's comes
            to -(2^30 + 12345), a later one's to below 2^16
    signed  -65535 .. 65535, a quarter of them 0; the first run's total is
            negative, every later run's >= 0

    After the first run every run's int32 total is >= 0 and the int32
    running sum does not overflow, so the running sum at run ends does not
    fall: the precondition of the JAX package's XLA run_length_sum (a cumsum
    and a reverse cummin over it), which the tests hold the kernels to as
    well. The kernels and the plain versions need no such precondition."""
    rng = np.random.default_rng(seed)
    n = sum(runs) + n_sentinel
    if kind == "signed":
        w = rng.integers(-65535, 65536, n)
        w[rng.random(n) < 0.25] = 0
    elif kind in ("counts", "wrap"):
        w = rng.integers(1, 65536, n)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    starts = np.cumsum([0] + list(runs))
    for r, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        if kind == "wrap" and b - a >= 64:
            w[a:b] = rng.integers(2**29, 2**31, b - a)
            target = -(2**30 + 12345) if r == 0 else int(rng.integers(0, 2**16))
            last = w[b - 1] + (target - int(w[a:b].sum())) % 2**32
            w[b - 1] = (last + 2**31) % 2**32 - 2**31
        elif kind == "signed":
            total = int(w[a:b].sum())
            if (r == 0 and total > 0) or (r > 0 and total < 0):
                w[a:b] = -w[a:b]
    return w.astype(np.int32)


def run_sums(runs: Sequence[int], weights: np.ndarray) -> np.ndarray:
    """Each run's weights summed and cut to int32 (wrapping): the totals at
    the runs' heads, independent of any kernel."""
    if not runs:
        return np.zeros(0, dtype=np.int32)
    starts = np.cumsum([0] + list(runs[:-1]))
    sums = np.add.reduceat(weights[:sum(runs)].astype(np.int64), starts)
    return ((sums + 2**31) % 2**32 - 2**31).astype(np.int32)


# --------------------------------------------------------------------------
# The block sort's hard inputs, by the slots a group of the kernel's threads
# holds in registers: every block size on both sides of it.

BLOCK_SORT_CHUNK = 2048  # csrc/block_sort.cu: 256 threads x 8 slots
BLOCK_SORT_KINDS = ("random", "all_equal", "sorted", "reversed", "last_word",
                    "sentinel_block")


def block_sort_cases(chunk: int = BLOCK_SORT_CHUNK) -> list[tuple[str, str, int, int, int, int]]:
    """(name, kind, n_words, n_payloads, block, n_blocks) of every case:
    every power-of-two block from 2 to the largest the kernel holds at four
    key widths, two of them without payload rows (below `chunk` enough blocks for two whole chunks and a
    ragged third, else an odd count), the other kinds on both sides of
    `chunk`, and every number of payload rows from none to eight rows in
    all."""
    from .ops.block_sort import MAX_ROWS, max_block

    def n_blocks(block):
        return 2 * chunk // block + 3 if block < chunk else 3

    cases = []
    for w, p in ((1, 0), (2, 0), (2, 2), (4, 1), (6, 2)):
        block = 2
        while block <= max_block(w):
            cases.append(("random", w, p, block, n_blocks(block)))
            block *= 2
    for kind in BLOCK_SORT_KINDS[1:]:
        for block in (max(chunk // 32, 2), chunk, 4 * chunk):
            cases.append((kind, 2, 1, block, n_blocks(block)))
    block = max(chunk // 8, 2)
    cases += [("random", 2, p, block, n_blocks(block)) for p in range(MAX_ROWS - 1)]
    cases += [("random", w, MAX_ROWS - w, chunk, 3) for w in (1, 6)]
    return [(f"{kind}-w{w}-p{p}-b{block}x{count}", kind, w, p, block, count)
            for kind, w, p, block, count in dict.fromkeys(cases)]


def block_sort_case_rows(kind: str, n_words: int, n_payloads: int, block: int,
                         n_blocks: int, seed: int) -> np.ndarray:
    """(n_words + n_payloads, n) uint32 rows; payload row j is arange(n) + j,
    so the sorted payloads show the order among equal keys.

    random          full-range words, a pool of exact duplicates, word-0 ties
                    that differ in the last word only, a sentinel tail
    all_equal       one key in every slot: only stability orders the payloads
    sorted          every block already ascending (word 0 decides)
    reversed        every block descending
    last_word       keys that differ in the last word only, with duplicates
    sentinel_block  random, the second and the last block all ones
    """
    rng = np.random.default_rng(seed)
    n = block * n_blocks
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    if kind == "random" or kind == "sentinel_block":
        dup = rng.integers(0, n, n // 4)
        words[:, dup] = words[:, rng.integers(0, min(n, 16), n // 4)]
        tie = rng.integers(0, n, n // 4)
        words[0, tie] = 0x80000007
        words[-1, tie[: n // 8]] = 0xFFFFFFF0 + (tie[: n // 8] % 3).astype(np.uint32)
        if kind == "random":
            words[:, n - n // 10:] = 0xFFFFFFFF
        else:
            words[:, block:2 * block] = 0xFFFFFFFF
            words[:, n - block:] = 0xFFFFFFFF
    elif kind == "all_equal":
        words[:] = words[:, :1]
    elif kind == "sorted" or kind == "reversed":
        ramp = (np.arange(n, dtype=np.uint64) * (2**32 // n)).astype(np.uint32)
        words[0] = ramp if kind == "sorted" else ramp[::-1]
    elif kind == "last_word":
        words[:-1] = words[:-1, :1]
        words[-1] = rng.integers(0, max(block // 4, 2), n).astype(np.uint32) << np.uint32(20)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    pay = (np.arange(n, dtype=np.uint32)[None, :]
           + np.arange(n_payloads, dtype=np.uint32)[:, None])
    return np.concatenate([words, pay], axis=0)


def stable_block_order(rows: np.ndarray, n_words: int, block: int,
                       descending_odd: bool) -> np.ndarray:
    """The rows with every block in stable ascending order of its key words
    (numpy's lexsort), odd blocks reversed under descending_odd."""
    rows = np.asarray(rows)
    out = rows.copy()
    for b in range(rows.shape[1] // block):
        blk = rows[:, b * block:(b + 1) * block]
        order = stable_order(blk[:n_words])
        if descending_odd and b % 2:
            order = order[::-1]
        out[:, b * block:(b + 1) * block] = blk[:, order]
    return out


# --------------------------------------------------------------------------
# The run merge's hard inputs, by the kernel's output tile and fan-in: run
# counts that take one pass and more (a last pass of smaller fan-in), runs of
# one slot, shorter than a tile and across tile edges, equal keys across
# every tile boundary, runs wholly before or after their neighbours,
# sentinel tails and all-sentinel runs.

MERGE_KINDS = ("random", "all_equal", "ascending", "descending", "top_bit",
               "sentinel")


def merge_cases(tile: int = MERGE_TILE, fan_in: int = MERGE_FAN_IN
                ) -> list[tuple[str, str, int, int, int, int]]:
    """(name, kind, n_words, n_payloads, n_runs, run_len) of every case, by
    the kernel's output tile and fan-in. Run counts and lengths are powers
    of two, as merge_sorted_runs asks."""
    cases = [("random", 2, 1, s, tile // 2) for s in (2, 4, 8, 16, 32)]
    cases += [("random", 2, 1, 4 * fan_in, 16),  # last pass of fan-in 4
              ("random", 1, 1, 2 * fan_in, 1),  # last pass of fan-in 2
              ("random", 2, 1, 16, 1), ("random", 2, 1, 8, tile // 8),
              ("random", 2, 1, 4, 2 * tile), ("random", 2, 6, 4, tile // 4)]
    cases += [("random", w, p, 8, tile // 4) for w in (1, 2, 4, 6) for p in (0, 2)]
    cases += [("all_equal", 2, 1, 8, tile), ("all_equal", 1, 1, 32, tile // 8),
              ("all_equal", 4, 2, 4, tile),
              ("ascending", 2, 1, 8, tile // 2), ("descending", 2, 1, 8, tile // 2),
              ("descending", 1, 0, 2 * fan_in, tile // 16),
              ("top_bit", 2, 1, 8, tile // 2), ("top_bit", 4, 1, 4, tile),
              ("sentinel", 2, 1, 16, tile // 4), ("sentinel", 1, 0, 8, 2 * tile),
              ("sentinel", 6, 2, 4, tile)]
    return [(f"{kind}-w{w}-p{p}-s{s}x{l}", kind, w, p, s, l)
            for kind, w, p, s, l in dict.fromkeys(cases)]


def merge_case_rows(kind: str, n_words: int, n_payloads: int, n_runs: int,
                    run_len: int, seed: int) -> np.ndarray:
    """(n_words + n_payloads, n_runs * run_len) uint32: n_runs ascending runs
    of run_len slots, then payload rows arange(n) + j, so the merged payloads
    show the order among equal keys.

    random      keys from a pool of run_len / 2 (duplicates within and
                across runs, half with the top bit set), sentinel tails of
                different lengths, the last run all sentinel when n_runs > 2
    all_equal   one key in every slot
    ascending   every run wholly after the one before it
    descending  every run wholly before the one before it
    top_bit     every key with the top bit set, word-0 ties that differ in
                the last word only
    sentinel    random, every other run all sentinel, the rest with tails
    """
    rng = np.random.default_rng(seed)
    n = n_runs * run_len
    words = np.full((n_words, n_runs, run_len), 0xFFFFFFFF, dtype=np.uint32)
    pool = rng.integers(0, 2**32, (max(run_len // 2, 1), n_words),
                        dtype=np.uint64).astype(np.uint32)
    if kind == "top_bit":
        pool |= np.uint32(0x80000000)
        pool[:, 0] = pool[0, 0]
    for r in range(n_runs):
        if kind in ("all_equal", "ascending", "descending"):
            filled = run_len
        else:
            filled = run_len - (r * run_len) // (2 * n_runs)
            if (kind == "random" and n_runs > 2 and r == n_runs - 1) or (
                    kind == "sentinel" and r % 2):
                filled = 0
        if kind == "all_equal":
            keys = np.repeat(pool[:1], filled, axis=0)
        elif kind in ("ascending", "descending"):
            band = r if kind == "ascending" else n_runs - 1 - r
            keys = rng.integers(0, 2**32, (filled, n_words),
                                dtype=np.uint64).astype(np.uint32)
            # word 0 in band `band` of n_runs equal slices below the sentinel
            width = (2**32 - 1) // n_runs
            keys[:, 0] = (band * width + keys[:, 0].astype(np.uint64) % width
                          ).astype(np.uint32)
        else:
            keys = pool[rng.integers(0, pool.shape[0], filled)]
        keys = keys[stable_order(keys.T)]
        words[:, r, :filled] = keys.T
    pay = (np.arange(n, dtype=np.uint32)[None, :]
           + np.arange(n_payloads, dtype=np.uint32)[:, None])
    return np.concatenate([words.reshape(n_words, n), pay], axis=0)


# --------------------------------------------------------------------------
# The key build's hard inputs, by the kernel's tile and the four slots a
# thread group takes: every key width and the shift-free widths, sizes that
# are not whole tiles or groups, inputs shorter than the halo, invalid slots
# on both sides of a tile edge, codes and flags at odd offsets.

KEYBUILD_TILE = 2048  # slots per tile of csrc/keybuild.cu: 256 threads x 2 x 4
KEYBUILD_GROUP = 4  # consecutive slots a thread keys and stores at once
KEYBUILD_KS = (3, 15, 16, 17, 31, 32, 33, 55, 64, 96)
KEYBUILD_KINDS = ("random", "tile_edge", "poly_a")


def keybuild_cases(tile: int = KEYBUILD_TILE) -> list[tuple[str, str, int, int, int]]:
    """(name, kind, n, k, offset) of every case: offset is where the codes
    and flags start in their buffers (1 and 3: no alignment at all)."""
    ragged = 3 * tile + 5  # neither whole tiles nor whole groups
    cases = [("random", ragged, k, 0) for k in KEYBUILD_KS]
    cases += [("random", n, k, 0) for n, k in ((1, 31), (30, 17), (40, 33), (90, 96))]
    cases += [("tile_edge", 2 * tile + 7, k, 0) for k in (15, 31, 55, 96)]
    cases += [("poly_a", tile + 3, k, 0) for k in (31, 64)]
    cases += [("random", ragged, k, off) for k in (15, 31, 55) for off in (1, 3)]
    cases += [("tile_edge", 2 * tile + 7, 33, 1)]
    return [(f"{kind}-n{n}-k{k}-o{off}", kind, n, k, off)
            for kind, n, k, off in cases]


def keybuild_case_codes(kind: str, n: int, k: int, seed: int,
                        tile: int = KEYBUILD_TILE):
    """(codes (n,) int8, valid (n,) bool).

    random     random codes, invalid runs and lone invalid slots
    tile_edge  random codes, every slot valid but two either side of each
               tile edge (and the last k - 1)
    poly_a     one base everywhere, every slot with k bases after it valid
    The last k - 1 slots are always invalid (no k-mer starts there).
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    if kind == "random":
        valid = rng.random(n) < 0.9
        for start in rng.integers(0, max(n, 1), 3):
            valid[start:start + 40] = False
    elif kind == "tile_edge":
        valid = np.ones(n, dtype=bool)
        edge = np.arange(n) % tile
        valid[(edge < 2) | (edge >= tile - 2)] = False
        valid[:2] = True  # slot 0 is no edge
    elif kind == "poly_a":
        codes[:] = 0
        valid = np.ones(n, dtype=bool)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    valid[max(n - (k - 1), 0):] = False
    return codes, valid


# --------------------------------------------------------------------------
# The key mix's hard inputs, by the kernel's block (csrc/mixkey.cu: 256
# threads x 4 slots): every key width, sentinel rows (which must stay
# sentinels), words with the top bit set, first words all ones in keys that
# are not the sentinel, sizes that are not whole blocks, rows at odd offsets.

MIX_BLOCK = 1024  # slots per block of csrc/mixkey.cu
MIX_KINDS = ("random", "sentinel", "top_bit", "near_sentinel")


def mix_cases(block: int = MIX_BLOCK) -> list[tuple[str, str, int, int, int]]:
    """(name, kind, n_words, n, offset) of every case: offset is where each
    row starts in its buffer (1 and 3: no 16-byte alignment)."""
    ragged = 3 * block + 5
    cases = [(kind, w, ragged, 0) for kind in MIX_KINDS for w in range(1, 7)]
    cases += [("random", w, n, 0) for w in (1, 2, 6)
              for n in (1, block - 1, block + 1)]
    cases += [("sentinel", w, ragged, off) for w in (1, 2, 5) for off in (1, 3)]
    cases += [("top_bit", 2, 2 * block, 1), ("near_sentinel", 4, ragged, 3)]
    return [(f"{kind}-w{w}-n{n}-o{off}", kind, w, n, off)
            for kind, w, n, off in cases]


def mix_case_words(kind: str, n_words: int, n: int, seed: int) -> np.ndarray:
    """(n_words, n) uint32 key words.

    random         full-range words
    sentinel       random, runs and lone slots of the all-ones sentinel
    top_bit        every word with the top bit set
    near_sentinel  keys one bit or one word away from the sentinel: first
                   word all ones, all but the last word all ones, all ones
                   but one bit; a few sentinels among them
    """
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    full = np.uint32(0xFFFFFFFF)
    if kind == "sentinel":
        words[:, rng.random(n) < 0.05] = full
        start = int(rng.integers(0, max(n, 1)))
        words[:, start:start + 300] = full
        words[:, -min(n, 17):] = full
    elif kind == "top_bit":
        words |= np.uint32(0x80000000)
    elif kind == "near_sentinel":
        pick = rng.integers(0, 4, n)
        words[0, pick == 0] = full
        words[:-1, pick == 1] = full
        bit = np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32)
        row = rng.integers(0, n_words, n)
        near = pick == 2
        words[:, near] = full
        words[row[near], np.flatnonzero(near)] ^= bit[near]
        words[:, pick == 3] = full
    elif kind != "random":
        raise ValueError(f"unknown kind {kind!r}")
    return words


# --------------------------------------------------------------------------
# Supermer routing's hard cases: the encoder (io/supermer) and its device
# twins (ops/supermer: the run table, the segment pack), the run headers'
# fill (ops/wire.fill_run_meta) and the route's heavy pre-count. The CPU
# tests hold them against the JAX package; chip_smoke.py phase 11 runs them
# on the card.

SUPERMER_KINDS = ("random", "zero_length", "shorter_than_k", "all_n", "cap",
                  "empty_dest", "heavy_top_bit")


def top_bit_kmer(rng, k: int) -> str:
    """A k-mer that is its own canonical form and starts with G or T, so
    that its first key word has the top bit set."""
    while True:
        s = "".join(rng.choice(list("GT"))) + "".join(rng.choice(list("ACGT"), k - 1))
        if canonical(s) == s:
            return s


def supermer_reads(kind: str, k: int, seed: int) -> list[str]:
    """Reads of one encoder case.

    random          reads of k + 5 to 3k bases
    zero_length     random, with empty records among them and at both ends
    shorter_than_k  random, with reads of 1 to k - 1 bases among them
    all_n           random, with reads of N only (N codes as A: poly-A
                    k-mers) and one of mixed N and n
    cap             reads of 600 to 1000 bases: one destination over a read
                    runs past the 250-base cap (MAX_SUPERMER_LEN) at K=15
    empty_dest      random (the case's destinations leave one unused)
    heavy_top_bit   random, plus 1500 copies of a top_bit_kmer read: a
                    heavy bucket whose dominant key has the top bit set
    """
    rng = np.random.default_rng(seed)
    base = random_reads(rng, 24, k + 5, 3 * k)
    if kind in ("random", "empty_dest"):
        return base
    if kind == "zero_length":
        return ["", *base[:10], "", "", *base[10:], ""]
    if kind == "shorter_than_k":
        short = [r[: int(n)] for r, n in zip(base, rng.integers(1, k, len(base)))]
        return [r for pair in zip(base, short) for r in pair]
    if kind == "all_n":
        return base[:12] + ["N" * (2 * k), "N" * k] + base[12:] + ["nNnN" * k]
    if kind == "cap":
        return random_reads(rng, 6, 600, 1000) + base[:4]
    if kind == "heavy_top_bit":
        return base + [top_bit_kmer(rng, k)] * 1500
    raise ValueError(f"unknown kind {kind!r}")


def supermer_case_dest(kind: str, n: int, num_dest: int, seed: int) -> np.ndarray:
    """(n,) int32 destinations of one encoder case's flat stream:
    piecewise constant in stretches of 1 to 40 positions (so that runs form
    and break); one destination everywhere for `cap` (only the read ends
    and the cap break runs); destination 1 never for `empty_dest`."""
    rng = np.random.default_rng(seed)
    if kind == "cap":
        return np.zeros(n, dtype=np.int32)
    pool = np.arange(num_dest)
    if kind == "empty_dest":
        pool = pool[pool != 1]
    reps = rng.integers(1, 41, n + 1)
    vals = rng.choice(pool, reps.size)
    return np.repeat(vals, reps)[:n].astype(np.int32)


RUN_TABLE_TILE = 4096  # csrc/supermer_runs.cu's positions a tile


def run_table_cases() -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """(name, valid bool, destination int32, max_kmers) of the run table's
    hard cases, at sizes around the kernel's tile (RUN_TABLE_TILE):

    all_invalid   no valid position (no run; every carry empty)
    one_stretch   every position valid, one destination, over three tiles
                  and a ragged fourth: the cap cuts a stretch whose head is
                  tiles to the left
    cap_one       max_kmers = 1: every valid position a run of one k-mer
    alternating   the destination changes at every position
    tile_edges    stretches and destination changes that end and begin at
                  tile edges, a lone valid position on each side of an edge
    first_last    only the first and the last position valid
    one           n = 1, valid
    random        ~90% valid, destinations in stretches of 1 to 400, over
                  five tiles, max_kmers of K=95
    sparse        ~10% valid in short stretches (gaps everywhere)
    """
    t = RUN_TABLE_TILE
    rng = np.random.default_rng(67)
    cases = []

    def add(name, valid, dest, m):
        cases.append((name, np.asarray(valid, bool), np.asarray(dest, np.int32), m))

    n = 3 * t + 517
    add("all_invalid", np.zeros(n, bool), rng.integers(0, 4, n), 236)
    add("one_stretch", np.ones(n, bool), np.zeros(n), 236)
    add("cap_one", rng.random(n) < 0.7, rng.integers(0, 2, n), 1)
    add("alternating", np.ones(n, bool), np.arange(n) % 2, 236)
    valid = np.zeros(n, bool)
    dest = np.zeros(n, np.int32)
    valid[t - 300: t] = True  # ends at the first edge
    valid[t: t + 200] = True  # begins there, with another destination
    dest[t: t + 200] = 1
    valid[2 * t - 1] = valid[2 * t] = True  # a lone position each side
    dest[2 * t] = 2
    valid[2 * t + 5: 3 * t + 300] = True  # crosses the third edge
    add("tile_edges", valid, dest, 236)
    valid = np.zeros(n, bool)
    valid[[0, n - 1]] = True
    add("first_last", valid, np.zeros(n), 236)
    add("one", np.ones(1, bool), np.zeros(1), 236)
    n = 5 * t + 77
    reps = rng.integers(1, 401, n)
    add("random", rng.random(n) < 0.9,
        np.repeat(rng.integers(0, 4, n), reps)[:n], 156)
    reps = rng.integers(1, 30, n)
    add("sparse", np.repeat(rng.random(n) < 0.1, reps)[:n],
        np.repeat(rng.integers(0, 3, n), reps)[:n], 17)
    return cases


def fill_meta_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int]]:
    """(name, lengths int32, rid0 int32, pos0 uint32, n) of every
    fill_run_meta case:

    random    runs of 15 to 250 positions, random headers, spare tail
    zero_pad  zero-length runs among the runs (their diffs stack on the
              next start) and a tail of zero-length pad runs
    wrap      headers that make every int32 difference wrap: rid0
              alternating near -2^31 and 2^31 - 1, pos0 near 0 and 2^32 - 1
    exact     runs that fill all n positions
    one       a single run
    """
    rng = np.random.default_rng(91)
    cases = []
    for name in ("random", "zero_pad", "wrap", "exact", "one"):
        lengths = rng.integers(15, 251, 64).astype(np.int32)
        if name == "zero_pad":
            lengths[rng.random(64) < 0.3] = 0
            lengths = np.concatenate([lengths, np.zeros(9, np.int32)])
        if name == "one":
            lengths = lengths[:1]
        m = lengths.size
        rid0 = rng.integers(0, 2**20, m).astype(np.int32)
        pos0 = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
        if name == "wrap":
            rid0 = np.where(np.arange(m) % 2, 2**31 - 1 - np.arange(m),
                            -(2**31) + np.arange(m)).astype(np.int32)
            pos0 = np.where(np.arange(m) % 2, 2**32 - 1 - np.arange(m),
                            np.arange(m)).astype(np.uint32)
        total = int(lengths.sum())
        n = total if name == "exact" else total + 37
        cases.append((name, lengths, rid0, pos0, n))
    return cases


# --------------------------------------------------------------------------
# Jobs for ranks spawned by parallel/spawn.spawn_ranks: each job reads its
# inputs from an .npz file and writes this rank's outputs to
# <out_dir>/<name>.<rank>.npz, so that a test compares them in its own
# process (which may hold JAX; the ranks import neither JAX nor the JAX
# package).


# In supermer_route: the step, the device heavy pre-count the step runs,
# and the host one it no longer runs.
SUPERMER_COUNTED = ("_supermer_step", "heavy_precount_device", "heavy_precount")
# The extension streams' device merge and host merge, as the scheduler's
# ExtPartialStore calls them.
SCHEDULER_COUNTED = ("merge_ext_partials_device", "merge_ext_partials")
COUNTED = ("_shard_body_range", "_shard_body_range_combiner", "_shard_body_bucketed",
           "_shard_body_ext_range", "_shard_body_ext_bucketed", "count_reads_sharded",
           "count_reads_sharded_ext", "count_reads_sharded_streaming", *SUPERMER_COUNTED,
           *SCHEDULER_COUNTED)


def call_counters(stack, pipeline_mod) -> dict:
    """Count the calls of the step bodies (the overflow retry and the
    combiner re-run show in them), of the sharded entries (the facade's
    choice shows in them), of the supermer route's step and heavy
    pre-counts (device and host), and of the extension streams' device
    and host merges."""
    from unittest import mock

    from .parallel import supermer_route
    from .runtime import scheduler

    calls = dict.fromkeys(COUNTED, 0)
    for name in calls:
        mod = (supermer_route if name in SUPERMER_COUNTED
               else scheduler if name in SCHEDULER_COUNTED else pipeline_mod)
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        stack.enter_context(mock.patch.object(mod, name, counted))
    return calls


def _run_count_job(kind: str, data, cfg, job: dict):
    """One counting job of run_rank_jobs: (list, histogram)."""
    from .parallel import pipeline as sharded

    device = job["device"]
    if kind.startswith("count_fasta_multihost"):
        from .parallel import multihost, supermer_route

        entry = getattr(multihost, kind, None) or getattr(supermer_route, kind)
        batch = (job["batch_bases"],) if kind.endswith("streaming") else ()
        return entry(job["fasta"], cfg, *batch, device=device)
    if kind == "count_flat_sharded":
        return sharded.count_flat_sharded(data["codes"], data["valid"], cfg,
                                          device=device)
    codes, lengths = data["codes"], data["lengths"]
    if kind == "count_reads_sharded":
        return sharded.count_reads_sharded(codes, lengths, cfg, device=device)
    if kind == "kmer_count":
        from . import kmer_count

        return kmer_count(codes, lengths, cfg, device=device)
    if kind == "count_reads_sharded_streaming":
        return sharded.count_reads_sharded_streaming(
            codes, lengths, cfg, job["batch_bases"], device=device,
            async_depth=job.get("async_depth"))
    if kind == "count_reads_sharded_ext":
        return sharded.count_reads_sharded_ext(
            codes, lengths, cfg, device=device,
            read_id_offset=job.get("read_id_offset", 0))
    if kind == "count_reads_sharded_ext_streaming":
        return sharded.count_reads_sharded_ext_streaming(
            codes, lengths, cfg, job["batch_bases"], device=device,
            read_id_offset=job.get("read_id_offset", 0))
    if kind.startswith("count_reads_supermer"):
        from .parallel import supermer_route

        entry = getattr(supermer_route, kind)
        if kind == "count_reads_supermer_streaming":
            return entry(codes, lengths, cfg, job["batch_bases"], device=device)
        if kind == "count_reads_supermer":
            return entry(codes, lengths, cfg, device=device)
        return entry(codes, lengths, cfg, device=device,
                     read_id_offset=job.get("read_id_offset", 0))
    raise ValueError(f"unknown job kind {kind!r}")


def _refuse(name: str, *args, **kwargs):
    raise AssertionError(f"{name} was called")


def run_rank_jobs(rank: int, jobs: Sequence[dict], out_dir: str) -> None:
    """Run `jobs` in order on this rank. A job is a dict with `name`,
    `kind` and `inputs` (an .npz path), and per kind:

      count_reads_sharded, count_flat_sharded (inputs: codes, valid),
      kmer_count (the facade), count_reads_sharded_streaming,
      count_reads_sharded_ext, count_reads_sharded_ext_streaming,
      count_reads_supermer, count_reads_supermer_ext,
      count_reads_supermer_exchange, count_reads_supermer_streaming
                           cfg (KmerConfig fields), device; batch_bases for
                           the streaming kinds, optional async_depth and
                           read_id_offset; optional capacity (every range
                           route starts from it), headroom (the device
                           memory headroom the facade sees, in bytes) and
                           refuse_host_flatten (the extension-mode host
                           flatteners, fasta.flatten_for_device_ext and
                           build_ext_blocks, raise if called)
      count_fasta_multihost, count_fasta_multihost_streaming,
      count_fasta_multihost_ext, count_fasta_multihost_ext_streaming,
      count_fasta_multihost_supermer, count_fasta_multihost_supermer_streaming
                           (no inputs) fasta (a path), cfg, device;
                           batch_bases for the streaming kinds: the rank's
                           own share
      exchange             (inputs: send_<rank>, counts_<rank>)
      cli                  argv (run under WORLD_SIZE / RANK / LOCAL_RANK of
                           the spawned group, output to <name>.<rank>.txt)

    A counting job writes keys, counts, hist and each counted function's
    calls; an extension-mode list also every k-mer's occurrences end to end
    (occ_rid, occ_pos).
    """
    import contextlib
    import io
    import os
    from unittest import mock

    import torch.distributed as dist

    from .config import KmerConfig
    from .io import fasta as fasta_io
    from .parallel import exchange
    from .parallel import pipeline as sharded
    from .pipeline import KmerListExt
    from .runtime import memcheck

    for job in jobs:
        data = np.load(job["inputs"]) if job.get("inputs") else None
        out = {}
        path = os.path.join(out_dir, f"{job['name']}.{rank}")
        kind = job["kind"]
        if kind == "exchange":
            send = torch.from_numpy(data[f"send_{rank}"])
            recv, recv_counts, recv_valid = exchange.all_to_all_exchange(
                send, data[f"counts_{rank}"].tolist())
            out = dict(recv=recv.numpy(), recv_counts=recv_counts.numpy(),
                       recv_valid=recv_valid.numpy())
        elif kind == "cli":
            from . import cli

            os.environ.update(WORLD_SIZE=str(dist.get_world_size()),
                              RANK=str(rank), LOCAL_RANK=str(rank))
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                out["rc"] = np.int32(cli.main(list(job["argv"])))
            with open(path + ".txt", "w") as f:
                f.write(text.getvalue())
        else:
            cfg = KmerConfig(**job["cfg"])
            with contextlib.ExitStack() as stack:
                calls = call_counters(stack, sharded)
                if job.get("capacity"):  # every range route starts from it
                    stack.enter_context(mock.patch.object(
                        sharded, "range_capacity",
                        lambda n_local, num_shards, cfg, c=job["capacity"]: c))
                if job.get("headroom"):
                    stack.enter_context(mock.patch.object(
                        memcheck, "hbm_headroom_bytes",
                        lambda device, safety=0.9, h=job["headroom"]: h))
                if job.get("refuse_host_flatten"):
                    for mod, name in ((fasta_io, "flatten_for_device_ext"),
                                      (sharded, "build_ext_blocks")):
                        stack.enter_context(mock.patch.object(
                            mod, name, functools.partial(_refuse, name)))
                kl, hist = _run_count_job(kind, data, cfg, job)
            out = dict(keys=kl.keys, counts=kl.counts, hist=hist,
                       passes=np.int64(calls["_shard_body_range"]),
                       combiner_passes=np.int64(calls["_shard_body_range_combiner"]),
                       calls=np.array([calls[n] for n in COUNTED], dtype=np.int64))
            if isinstance(kl, KmerListExt):
                out.update(occ_rid=kl.occ_rid, occ_pos=kl.occ_pos)
        np.savez(path + ".npz", **out)
