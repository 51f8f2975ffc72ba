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


def _ranks_to_buckets(rng, ranks: np.ndarray, num_dest: int, per_dest: int = 3):
    """Buckets and a round-robin bucket -> rank table (per_dest buckets a
    destination) under which each position's rank is `ranks`."""
    assign = (np.arange(per_dest * num_dest) % num_dest).astype(np.int32)
    pick = rng.integers(0, per_dest, ranks.size)
    return (ranks + num_dest * pick).astype(np.int32), assign


def run_layout_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int, int]]:
    """(name, valid bool, bucket int32, assign int32, max_kmers, num_dest) of
    the run layout's hard cases: the layout of the runs of ranks
    assign[bucket] (csrc/supermer_runs.cu, tiles of RUN_TABLE_TILE):

    <case>-S<d>  every run_table_cases() case at d = 1, 2, 4 and 257
                 destinations, its destinations taken mod d (at 4 none is
                 2: an empty destination; at 257 most are empty), three
                 buckets a destination
    cap_edge     at 2 destinations, stretches whose max_kmers cap falls one
                 before, on and one after a tile edge
    cap_two_edges  a cap longer than two tiles: one run over two tile edges,
                 a tile whose only entry is the run it continues
    buckets      more buckets than csrc/supermer_runs.cu stages in shared
                 memory (9,000: the table read from device memory), 64
                 destinations
    dest257      257 destinations in stretches of 1 to 40 positions, ~80%
                 valid, over three tiles
    zero_length  the k-mer starts of reads with zero-length reads among
                 them (scan_mask "reads") at K = 31, 4 destinations
    """
    t = RUN_TABLE_TILE
    rng = np.random.default_rng(71)
    cases = []
    for name, valid, dest, m in run_table_cases():
        for d in (1, 2, 4, 257):
            ranks = dest.astype(np.int64) % d
            if d == 4:
                ranks[ranks == 2] = 3
            bucket, assign = _ranks_to_buckets(rng, ranks, d)
            cases.append((f"{name}-S{d}", valid, bucket, assign, m, d))
    n = 3 * t + 200
    valid = np.ones(n, bool)
    m = 100
    # A stretch starts after each gap, its caps every m positions on: one
    # falls one before the first edge, one on the second, one after the
    # third.
    valid[[t - 2 * m - 2, 2 * t - 2 * m - 1, 3 * t - 2 * m]] = False
    ranks = (np.arange(n) >= t + 900).astype(np.int64)
    bucket, assign = _ranks_to_buckets(rng, ranks, 2)
    cases.append(("cap_edge", valid, bucket, assign, m, 2))
    # One run over two tile edges: a cap longer than two tiles.
    n = 3 * t + 517
    bucket, assign = _ranks_to_buckets(rng, np.zeros(n, np.int64), 2)
    cases.append(("cap_two_edges", np.ones(n, bool), bucket, assign, 2 * t + 808, 2))
    n = 2 * t + 999
    assign = rng.integers(0, 64, 9000).astype(np.int32)
    reps = rng.integers(1, 60, n)
    cases.append(("buckets", rng.random(n) < 0.85,
                  np.repeat(rng.integers(0, 9000, n), reps)[:n].astype(np.int32), assign,
                  236, 64))
    n = 3 * t + 11
    reps = rng.integers(1, 41, n)
    ranks = np.repeat(rng.integers(0, 257, n), reps)[:n]
    bucket, assign = _ranks_to_buckets(rng, ranks, 257)
    cases.append(("dest257", rng.random(n) < 0.8, bucket, assign, 17, 257))
    n = 2 * t + 77
    reps = rng.integers(1, 30, n)
    bucket, assign = _ranks_to_buckets(rng, np.repeat(rng.integers(0, 4, n), reps)[:n], 4)
    cases.append(("zero_length", scan_mask("reads", n, 31, 7), bucket, assign, 220, 4))
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
# The wire decode's and the minimizer scan's hard cases (ops/wire.decode_block
# and decode_block_ext, csrc/wire_decode.cu; ops/minimizer.kmer_destinations,
# csrc/minimizer_scan.cu), by the kernels' tiles. The CPU tests hold the
# plain versions against the JAX package on them; chip_smoke.py phase 1 and
# the `cuda` tests hold the kernels against the plain versions.

WIRE_SCAN_TILE = 2048  # read lengths a tile of csrc/wire_decode.cu's scan
WIRE_DECODE_TILE = 16384  # positions a tile of its decode: 256 threads x 4 words
WIRE_DECODE_STEP = 4096  # positions the tile's 256 threads decode at once
WIRE_DECODE_STAGED = 2048  # read ends a decode tile stages in shared memory


def _wire_words(rng, segments: int, n: int, spare: int = 0) -> np.ndarray:
    """(S, ceil(n/16) + spare) uint32 words, the top bit set in about half."""
    return rng.integers(0, 2**32, (segments, -(-n // 16) + spare),
                        dtype=np.uint64).astype(np.uint32)


def wire_decode_cases() -> list[tuple[str, np.ndarray, np.ndarray, int, int, int | None]]:
    """(name, packed (S, words) uint32, lengths (S, R) int32, k, n, rid_base)
    of every decode case: S segments of n positions each; rid_base None for
    codes and validity only (decode_block), else extension mode
    (decode_block_ext, one segment, read ids from rid_base).

    edges        reads of length 0, 1, k - 1, k, k + 1 and 150 among random
                 ones, a read that crosses a word edge, at K = 15, 31, 96
    ragged_n     n not a multiple of 16 (the last word half used)
    cut          n below the lengths' total: the total is cut at n
    segments3    S = 3 segments over two decode tiles and a ragged third,
                 each with its own reads and zero-padding
    one_segment  the same as a (1, R) segment (the 2-D form, S = 1)
    many_reads   more reads than three scan tiles (the look-back walks),
                 zero-length runs across a scan tile's edge
    long_read    one read over three decode tiles among short ones
    tile_edges   reads that end exactly at decode tile and word edges
    stacked      runs of zero-length reads (hundreds on one start), a tail
                 of zero-padding longer than a scan tile
    no_reads     R = 0: nothing valid
    over_stage   a decode tile holding more reads than it stages in shared
                 memory (WIRE_DECODE_STAGED), short and zero-length ones,
                 between tiles that stage theirs
    thread_edges reads ending on decode tile edges, on the edges of the
                 tile's steps (WIRE_DECODE_STEP), of a warp's 512 positions
                 and of words, each exactly and one position either side
    odd_strides  S = 3 segments of an odd number of words and of lengths a
                 row (every row but the first starts off a 16-byte edge)
    ext_*        extension mode on the edges reads with rid_base 0 and
                 1_000_000, on `cut`, `stacked`, `over_stage` and
                 `thread_edges`, and with rid_base 2^31 - 5 (read ids wrap
                 past int32)
    """
    rng = np.random.default_rng(19)
    cases = []

    def add(name, lengths, k, n, rid_base=None, spare=0):
        lengths = np.atleast_2d(np.asarray(lengths, dtype=np.int32))
        cases.append((name, _wire_words(rng, lengths.shape[0], n, spare), lengths,
                      k, n, rid_base))

    def edge_reads(k):
        return np.concatenate([
            [0, 1, k - 1, k, k + 1, 150, 0, 0], rng.integers(0, 3 * k, 30),
            [150, 17, 0, 23, k]]).astype(np.int32)

    for k in (15, 31, 96):
        lengths = edge_reads(k)
        total = int(lengths.sum())
        add(f"edges-k{k}", lengths, k, -(-(total + 16) // 16) * 16, spare=2)
    lengths = edge_reads(31)
    total = int(lengths.sum())
    add("ragged_n", lengths, 31, total + 21)
    add("cut", lengths, 31, total - 103)
    seg = [np.concatenate([rng.integers(0, 200, 60 + 20 * s), np.zeros(10 + s)])
           for s in range(3)]
    width = max(x.size for x in seg)
    add("segments3", np.stack([np.pad(x, (0, width - x.size)) for x in seg]), 31,
        2 * WIRE_DECODE_TILE + 1000)
    add("one_segment", seg[0][None, :], 31, int(seg[0].sum()) + 16)
    reads = rng.integers(0, 40, 3 * WIRE_SCAN_TILE + 77)
    reads[WIRE_SCAN_TILE - 50: WIRE_SCAN_TILE + 50] = 0
    add("many_reads", reads, 15, int(reads.sum()) + 40)
    reads = np.concatenate([rng.integers(1, 120, 40), [3 * WIRE_DECODE_TILE + 5],
                            rng.integers(1, 120, 40)])
    add("long_read", reads, 31, int(reads.sum()) + 16)
    reads = np.array([WIRE_DECODE_TILE - 16, 16, 15, 1, WIRE_DECODE_TILE - 32, 150,
                      WIRE_DECODE_TILE - 150, 31, 33], dtype=np.int32)
    add("tile_edges", reads, 31, int(reads.sum()) + 64)
    reads = np.concatenate([np.zeros(300), rng.integers(1, 90, 50), np.zeros(500),
                            rng.integers(1, 90, 50), np.zeros(WIRE_SCAN_TILE + 300)])
    add("stacked", reads, 31, int(reads.sum()) + 48)
    add("no_reads", np.zeros((1, 0)), 31, 100)
    stacked = reads
    t = WIRE_DECODE_TILE
    # Tile 1 holds ~3000 reads of 0 to 4 bases (more than it stages); tiles
    # 0 and 2 hold reads of 100 to 150.
    many = rng.integers(0, 5, WIRE_DECODE_STAGED + 1000)
    head = rng.integers(100, 151, t // 150)
    over = np.concatenate([head, [t + 7 - int(head.sum())], many,
                           rng.integers(100, 151, 200)])
    add("over_stage", over, 31, int(over.sum()) + 20)
    ends = sorted({e + d for e in (t, 2 * t, t + WIRE_DECODE_STEP, t + 2 * WIRE_DECODE_STEP,
                                   t + 512, t + 1024, 2 * t - 512, 16 * 37, t + 16 * 301)
                   for d in (-1, 0, 1)})
    edges = np.diff(np.concatenate([[0], ends, [2 * t + 300]]))
    add("thread_edges", edges, 31, 2 * t + 400)
    seg = [np.concatenate([rng.integers(0, 200, 61 + 20 * s), np.zeros(10 + s)])
           for s in range(3)]
    width = max(x.size for x in seg) | 1
    n_odd = t + 1001
    add("odd_strides", np.stack([np.pad(x, (0, width - x.size)) for x in seg]), 31,
        n_odd, spare=1 - (-(-n_odd // 16)) % 2)
    lengths = edge_reads(31)
    total = int(lengths.sum())
    for rid_base in (0, 1_000_000):
        add(f"ext_edges-rid{rid_base}", lengths, 31, total + 16, rid_base)
    add("ext_cut", lengths, 31, total - 103, 7)
    add("ext_stacked", stacked, 31, int(stacked.sum()) + 48, 1_000_000)
    add("ext_over_stage", over, 31, int(over.sum()) + 20, 3)
    add("ext_thread_edges", edges, 31, 2 * t + 400, 11)
    add("ext_rid_wrap", lengths, 31, total + 16, 2**31 - 5)
    return cases


def _reads_to_ends(rng, ends, lo: int, hi: int) -> np.ndarray:
    """Read lengths in [lo, hi] whose running sums pass through every one
    of the ascending `ends`: each gap split into the fewest reads of at
    most hi bases, as even as can be, in a random order."""
    out = []
    prev = 0
    for end in ends:
        gap = end - prev
        parts = -(-gap // hi)
        if gap // parts < lo:
            raise ValueError(f"a gap of {gap} bases takes no reads of {lo} to {hi}")
        base = np.full(parts, gap // parts)
        base[: gap - int(base.sum())] += 1
        rng.shuffle(base)
        out.extend(int(x) for x in base)
        prev = end
    return np.asarray(out, dtype=np.int32)


def decode_runs_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray, int, int]]:
    """(name, packed (S, words) uint32, lengths (S, R) int32, rid0 (S, R)
    int32, pos0 (S, R) uint32, k, n) of every case of the decode's
    run-header mode (ops/wire.decode_block_runs): every fill_meta_cases case
    as one segment (stacked zero-length runs, pad runs at and past the
    total, int32 differences that wrap) with random words at K = 31, and
    every wire_decode_cases case (a total past the segment, no runs at all,
    three segments, stacked runs, a tile of more runs than it stages, odd
    strides; extension mode's cases by their lengths alone) with random
    headers: read ids of either sign, pos0 with the top bit set in about
    half."""
    rng = np.random.default_rng(23)
    cases = []
    for name, lengths, rid0, pos0, n in fill_meta_cases():
        cases.append((f"fill_{name}", _wire_words(rng, 1, n, 1), lengths[None],
                      rid0[None], pos0[None], 31, n))
    for name, packed, lengths, k, n, _ in wire_decode_cases():
        rid0 = rng.integers(-(2**31), 2**31, lengths.shape, dtype=np.int64).astype(np.int32)
        pos0 = rng.integers(0, 2**32, lengths.shape, dtype=np.uint64).astype(np.uint32)
        cases.append((f"wire_{name}", packed, lengths, rid0, pos0, k, n))
    return cases


# --------------------------------------------------------------------------
# The pack by destination's hard cases (parallel/exchange.pack_by_destination,
# csrc/dest_pack.cu), by the kernel's tile. The CPU tests hold the plain
# version against the JAX package and a stable counting scatter on them;
# chip_smoke.py phase 1 and the `cuda` tests hold the kernel against the
# plain version.

# chip_smoke.py phase 1 holds both against the kernel's hk_dest_pack_geometry.
DEST_PACK_TILE = 4096  # slots a tile of csrc/dest_pack.cu: 256 threads x 16
DEST_PACK_STAGED = 4096  # bucket -> rank entries it stages in shared memory


def dest_pack_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int, int,
                                     int, np.ndarray | None]]:
    """(name, valid (n,) bool, dest (n,) int32 or int64, rows (R, n) uint32,
    n_words, num_shards, capacity, assign) of every pack case: rows[:n_words]
    are the key rows, the rest payload rows; with `assign` (an int32 bucket
    -> rank table) dest holds int32 buckets. Invalid slots hold garbage
    destinations (num_shards and past it, negative, 2^31 - 1; buckets past
    the table).

    empty        n = 0
    ragged       n not a multiple of the tile, four destinations
    all_invalid  no slot is sent
    one_dest     every valid slot to one of four destinations
    s1 .. s300   1, 3, 4, 255 and 300 destinations (300: past the kernel's
                 255, the radix-sort composition on the card)
    cap1         capacity 1, one slot short of a tile
    overflow     capacity below the counts: the first slots in input order
    top_bit      all-ones and top-bit words
    rows1, rows8 one row; six key words and two payloads
    table*       a bucket row and a table of S * 3 entries at 4 and 255
                 destinations, and one of 4800 entries (more than the
                 kernel stages)
    dest64       int64 destinations (kmer_hash's), garbage past 2^32
    """
    rng = np.random.default_rng(29)
    t = DEST_PACK_TILE
    cases = []

    def add(name, n, num_shards, n_words, n_payloads, capacity=None, valid_p=0.8,
            table=None, wide=False, rows=None, dest=None):
        valid = rng.random(n) < valid_p
        if dest is None:
            dest = rng.integers(0, num_shards, n)
        assign = None
        if table is not None:
            assign = rng.integers(0, num_shards, table).astype(np.int32)
            dest = rng.integers(0, table, n)
            junk = np.array([table, table + 99, -1, -(2**31), 2**31 - 1])
        elif wide:
            junk = np.array([num_shards, -1, 2**40, -(2**40), 2**33 + 1])
        else:
            junk = np.array([num_shards, num_shards + 7, -1, -(2**31), 2**31 - 1])
        dest = np.where(valid, dest, rng.choice(junk, n))
        dest = dest.astype(np.int64 if wide else np.int32)
        if rows is None:
            rows = rng.integers(0, 2**32, (n_words + n_payloads, n),
                                dtype=np.uint64).astype(np.uint32)
        if capacity is None:
            capacity = max(n, 1)
        cases.append((name, valid, dest, rows, n_words, num_shards, capacity, assign))

    add("empty", 0, 3, 1, 0, capacity=8)
    add("ragged", 3 * t + 77, 4, 2, 1)
    add("all_invalid", t + 5, 3, 2, 0, capacity=100, valid_p=0.0)
    add("one_dest", 2 * t + 9, 4, 2, 0, valid_p=0.9,
        dest=np.full(2 * t + 9, 2))
    add("s1", 2 * t + 1, 1, 2, 0)
    add("s3", 2 * t + 333, 3, 3, 1)
    add("s4", t, 4, 2, 2)
    add("s255", 3 * t + 11, 255, 2, 0, capacity=2 * (3 * t + 11) // 255)
    add("s300", 2 * t + 5, 300, 1, 1, capacity=2 * (2 * t + 5) // 300)
    add("cap1", t - 1, 4, 2, 0, capacity=1)
    add("overflow", 2 * t + 100, 3, 2, 1, capacity=(2 * t + 100) // 6)
    n = t + 300
    top = np.where(rng.random((3, n)) < 0.5, np.uint32(0xFFFFFFFF),
                   np.uint32(0x80000000) | rng.integers(0, 2**31, (3, n)).astype(np.uint32))
    add("top_bit", n, 4, 2, 1, rows=top.astype(np.uint32))
    add("rows1", t + 1, 4, 1, 0)
    add("rows8", 2 * t + 3, 4, 6, 2, capacity=(2 * t + 3) // 5)
    add("table", 2 * t + 17, 4, 2, 0, table=4 * 3)
    add("table255", 2 * t + 17, 255, 2, 1, table=255 * 3,
        capacity=3 * (2 * t + 17) // 255)
    add("table_big", 2 * t + 17, 16, 2, 0, table=4800)
    add("dest64", 2 * t + 41, 3, 2, 2, wide=True)
    return cases


KEPT_ROWS_TILE = 2048  # slots a write tile of csrc/kept_rows.cu: 256 threads x 8
KEPT_ROWS_BINS = 1024  # the counts below it binned in shared memory there
KEPT_ROWS_GROUP = 32768  # slots a count block covers: the unit of its look-back
KEPT_ROWS_WINDOW = 32  # count blocks its look-back reads at a time (lookback.cuh kWindow)
GATHER_TILE = 4096  # occurrences an output tile of its gather: 256 threads x 16
GATHER_STAGED = 2048  # runs a gather tile stages in shared memory


def kept_read_bytes(keep: torch.Tensor, rows: Sequence[torch.Tensor]) -> int:
    """The bytes csrc/kept_rows.cu must read on this data, for its bound:
    keep once (1 B a slot), and of each row in `rows` (the key words, the
    counts) only the 32-byte sectors that hold a kept slot, as the kernel
    reads no dropped slot's word. The sectors are counted at the rows'
    addresses."""
    idx = torch.nonzero(keep).squeeze(1)
    sectors = 0
    for r in rows:
        at = (r.data_ptr() + r.element_size() * r.stride(0) * idx) // 32
        sectors += int(torch.unique_consecutive(at).numel())
    return keep.numel() + 32 * sectors


def _kept_counts(rng, n: int, upper: int) -> np.ndarray:
    """Filtered counts in [1, upper], as skewed as a real block's (most
    small), with some at upper and, where upper allows, some past the
    shared bins."""
    c = np.minimum(rng.geometric(0.2, n), upper)
    pick = rng.random(n)
    c = np.where(pick < 0.05, upper, c)
    if upper > KEPT_ROWS_BINS:
        c = np.where((pick >= 0.05) & (pick < 0.1),
                     rng.integers(KEPT_ROWS_BINS, upper + 1, n), c)
    return c.astype(np.int64)


def kept_rows_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int, int,
                                     bool]]:
    """(name, words (W, n) uint32, cnt (n,) int32, keep (n,) bool, upper,
    hist_upper, mixed) of every compaction case: the kept rows' counts lie
    in [1, upper] (the filter's), the dropped rows' hold anything (0, past
    upper, 2^31 - 1); `mixed`: the words are mixed keys (mixkey.mix_keys_np
    of random keys, the sentinel kept as it is) to be unmixed.

    empty, one_kept, one_dropped   n = 0 and n = 1
    w1 .. w6         one to six key words, ragged n, U = 50
    u255 .. u65536   U = 255, 256, 65535, 65536: counts narrowed to uint8,
                     uint16, uint16, int32, histograms over [0, U]
    unfiltered       U = 2^31 - 1 (int32 counts, kept ones up to 10^6 so
                     that their sum stays below 2^31), histogram over [0,
                     50]: counts above 50 dropped from it
    none_kept, all_kept
    top_bit          top-bit and all-ones words; sentinel rows kept
    small            n = 100, below one tile
    tile-1, tile, tile+1   n = KEPT_ROWS_TILE - 1, KEPT_ROWS_TILE, + 1
    group-1 .. group+1   n = KEPT_ROWS_GROUP - 1, + 0, + 1: one count
                     block, or a second one with a slot
    gap              kept rows in tiles 0, 2 and 4, none in tiles 1 and 3
    far_gap          kept rows in the first count block and the last two,
                     none in the KEPT_ROWS_WINDOW + 2 between: the
                     look-back walks past a whole window of blocks without
                     a row
    last_kept        only the block's last slot kept, n past a tile edge
    mixed_w1 .. mixed_w6   mixed keys with sentinel rows among the kept
    """
    from .ops import mixkey

    rng = np.random.default_rng(31)
    t = KEPT_ROWS_TILE
    cases = []

    def add(name, n, n_words, upper=50, hist_upper=None, keep_p=0.3, keep=None,
            words=None, mixed=False, top=None):
        if words is None:
            words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
        if keep is None:
            keep = rng.random(n) < keep_p
        junk = rng.choice(np.array([0, upper + 1, 2**31 - 1, 7], dtype=np.int64), n)
        cnt = np.where(keep, _kept_counts(rng, n, top or upper), junk)
        cnt = np.minimum(cnt, 2**31 - 1).astype(np.int32)
        if mixed:
            sentinel = rng.random(n) < 0.05
            words[:, sentinel] = 0xFFFFFFFF
            words = mixkey.mix_keys_np(words.T).T.copy()
        cases.append((name, words, cnt, keep, upper,
                      upper if hist_upper is None else hist_upper, mixed))

    add("empty", 0, 2)
    add("one_kept", 1, 2, keep=np.ones(1, bool))
    add("one_dropped", 1, 3, keep=np.zeros(1, bool))
    for w in range(1, 7):
        add(f"w{w}", 3 * t + 100 * w + 3, w)
    for upper in (255, 256, 65535, 65536):
        add(f"u{upper}", 2 * t + 57, 2, upper=upper)
    add("unfiltered", 2 * t + 9, 2, upper=2**31 - 1, hist_upper=50, top=10**6)
    add("none_kept", 2 * t + 5, 2, keep_p=0.0)
    add("all_kept", 2 * t + 5, 2, keep_p=1.0)
    n = t + 301
    top = np.where(rng.random((4, n)) < 0.3, np.uint32(0xFFFFFFFF),
                   np.uint32(0x80000000) | rng.integers(0, 2**31, (4, n)).astype(np.uint32))
    add("top_bit", n, 4, words=top.astype(np.uint32), keep_p=0.7)
    add("small", 100, 3, keep_p=0.5)
    for name, n in (("tile-1", t - 1), ("tile", t), ("tile+1", t + 1)):
        add(name, n, 2, keep_p=0.5)
    g = KEPT_ROWS_GROUP
    for name, n in (("group-1", g - 1), ("group", g), ("group+1", g + 1)):
        add(name, n, 2, keep_p=0.1)
    n = 5 * t - 13
    keep = rng.random(n) < 0.4
    keep[t:2 * t] = False
    keep[3 * t:4 * t] = False
    add("gap", n, 2, keep=keep)
    n = (KEPT_ROWS_WINDOW + 5) * g - 7
    keep = rng.random(n) < 0.02
    keep[g:(KEPT_ROWS_WINDOW + 3) * g] = False
    add("far_gap", n, 2, keep=keep)
    n = 3 * t + 5
    keep = np.zeros(n, bool)
    keep[-1] = True
    add("last_kept", n, 2, keep=keep)
    for w in range(1, 7):
        add(f"mixed_w{w}", 2 * t + 31 * w, w, keep_p=0.5, mixed=True)
    return cases


def gather_runs_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray]]:
    """(name, starts (m,) int64, lengths (m,) int64, arrays (A, N) int32) of
    every gather case: the runs arrays[:, starts[j]:starts[j] + lengths[j]]
    laid end to end, A = 1 or 2.

    one_run          a single run
    long_run         a run of 100,000 (many output tiles) among short ones
    tile-1 .. tile+1 GATHER_TILE - 1, GATHER_TILE, + 1 occurrences in all
    many_runs        runs of 1 and 2: more runs in an output tile than it
                     stages
    zero_length      empty runs among the others, some at tile starts
    aligned          every start and length a multiple of 4 (the 16-byte
                     loads)
    one_array        one array
    kept_heads       the kept runs of a sorted block: starts at the heads,
                     lengths the runs' counts, ascending
    """
    rng = np.random.default_rng(37)
    t = GATHER_TILE
    cases = []

    def add(name, lengths, n_arrays=2, starts=None, size=None):
        lengths = np.asarray(lengths, dtype=np.int64)
        size = size or int(lengths.sum()) + 1000
        if starts is None:
            starts = rng.integers(0, size - lengths + 1)
        arrays = rng.integers(-2**31, 2**31, (n_arrays, size)).astype(np.int32)
        cases.append((name, np.asarray(starts, dtype=np.int64), lengths, arrays))

    add("one_run", [777])
    add("long_run", np.concatenate([rng.integers(1, 20, 300), [100_000],
                                    rng.integers(1, 20, 300)]))

    def summing_to(total):
        lengths = rng.integers(1, 40, total)
        lengths = lengths[np.cumsum(lengths) <= total]
        return np.append(lengths, total - lengths.sum())

    for name, total in (("tile-1", t - 1), ("tile", t), ("tile+1", t + 1)):
        add(name, summing_to(total))
    add("many_runs", rng.integers(1, 3, 3 * t))
    lengths = rng.integers(0, 30, 2000)
    lengths[rng.random(2000) < 0.3] = 0
    add("zero_length", np.concatenate([[0], summing_to(t), [0, 0], summing_to(t), [0],
                                       lengths]))
    m = 1500
    lengths = 4 * rng.integers(1, 12, m)
    add("aligned", lengths, starts=4 * rng.integers(0, 5000, m), size=4 * 5000 + 64)
    add("one_array", rng.integers(1, 25, 900), n_arrays=1)
    runs = rng.geometric(0.15, 3000)
    heads = np.concatenate([[0], np.cumsum(runs)[:-1]])
    kept = rng.random(3000) < 0.5
    add("kept_heads", runs[kept], starts=heads[kept], size=int(runs.sum()))
    return cases


PACK_TILE = 32768  # bases a word block of csrc/supermer_pack.cu: 256 threads x 8 words
PACK_STAGED = 1024  # runs a word block stages in shared memory


def pack_cases() -> list[tuple[str, np.ndarray, np.ndarray, int, int, np.ndarray, bool]]:
    """(name, codes int8, read lengths int32, k, num_dest, destination int32
    per base of the reads, extension mode) of the segment pack's hard cases
    (ops/supermer.pack_segments, csrc/supermer_pack.cu): the rank's reads,
    which the wire carries and the decode flattens, with every k-mer start
    sent to the destination of its first base. Runs are whole reads where
    one destination holds a read of at most MAX_SUPERMER_LEN bases.

    tile_edges   one destination, reads of k to 250 bases whose runs end on
                 the pack's tile edges (PACK_TILE), one base before, at and
                 one after an edge, and on and beside word edges
    max_len      one destination: runs of MAX_SUPERMER_LEN bases, reads
                 longer than it (cut into runs that share k - 1 bases with
                 the run before: words across the cut read two stretches)
    offsets      four destinations by read, runs starting at every byte
                 offset mod 16 of the codes and of their segments
    skewed       four destinations: one holds most reads, destination 3
                 none (a row of padding and zero lengths), and the others'
                 later tiles are all padding
    dests64      64 destinations by read, four without a run (7, 23, 40
                 and the last)
    short_runs   k = 15, destinations that change at every position of a
                 stretch: 15-base runs, more of them in a tile than it
                 stages (PACK_STAGED)
    *_ext        extension mode (read ids from 2^31 - 5, wrapping)
    """
    from .io.supermer import MAX_SUPERMER_LEN

    rng = np.random.default_rng(212)
    t = PACK_TILE
    cases = []

    def add(name, lengths, k, num_dest, dest_of_read=None, dest=None, ext=False):
        lengths = np.asarray(lengths, dtype=np.int32)
        total = int(lengths.sum())
        codes = rng.integers(0, 4, total).astype(np.int8)
        if dest is None:
            dest = np.repeat(np.asarray(dest_of_read, dtype=np.int32), lengths)
        cases.append((name, codes, lengths, k, num_dest, dest.astype(np.int32), ext))

    ends = sorted([t - 1, 2 * t, 3 * t + 1, 16 * 101, 16 * 700 + 1, 2 * t + 16 * 5 - 1])
    tile_edges = _reads_to_ends(rng, ends + [3 * t + 500], 31, MAX_SUPERMER_LEN)
    zeros = np.zeros(tile_edges.size, np.int32)
    add("tile_edges", tile_edges, 31, 1, zeros)
    longest = np.concatenate([np.full(40, MAX_SUPERMER_LEN),
                              rng.integers(MAX_SUPERMER_LEN + 1, 700, 20),
                              rng.integers(31, MAX_SUPERMER_LEN, 40)])
    rng.shuffle(longest)
    add("max_len", longest, 31, 1, np.zeros(longest.size))
    offsets = np.tile(31 + np.arange(16), 12)
    add("offsets", offsets, 31, 4, rng.integers(0, 4, offsets.size))
    skewed = rng.integers(31, 200, 500)
    owner = np.where(rng.random(skewed.size) < 0.9, 0, rng.integers(1, 3, skewed.size))
    add("skewed", skewed, 31, 4, owner)
    many = rng.integers(31, 200, 400)
    add("dests64", many, 31, 64,
        rng.choice(np.setdiff1d(np.arange(64), [7, 23, 40, 63]), many.size))
    short = rng.integers(100, 250, 300)
    dest = rng.integers(0, 4, int(short.sum()))
    stretch = min(2 * t, dest.size)
    dest[:stretch] = np.arange(stretch) % 4
    add("short_runs", short, 15, 4, dest=dest)
    add("tile_edges_ext", tile_edges, 31, 1, zeros, ext=True)
    add("skewed_ext", skewed, 31, 4, owner, ext=True)
    add("short_runs_ext", short, 15, 4, dest=dest, ext=True)
    return cases


SCAN_TILE = 2048  # the first scan kernel's tile; scan_cases keep its sizes
SCAN_KS = (15, 31, 55, 95, 96)
SCAN_MS = (1, 2, 7, 17)
SCAN_BUCKETS = (1, 3, 9, 24, 65_537)
SCAN_KINDS = ("random", "poly_a", "top_bit")


@functools.lru_cache(maxsize=None)
def top_bit_motif(m: int) -> tuple[int, ...]:
    """A 4-base motif whose repeats give canonical m-mers that all hash
    (ops/hashes.mix_words) above 2^31: every window's minimum hash of a
    stretch of them has the top bit set."""
    from .ops import minimizer

    rng = np.random.default_rng(m)
    while True:
        motif = rng.integers(0, 4, 4).astype(np.int8)
        seq = torch.from_numpy(np.tile(motif, -(-(m + 8) // 4)))
        h = minimizer.mmer_hashes(seq, m).numpy().view(np.uint32)[:4]
        if (h >= 2**31).all():
            return tuple(int(c) for c in motif)


def scan_case_codes(kind: str, n: int, m: int, seed: int) -> np.ndarray:
    """(n,) int8 codes of one scan case.

    random   random codes with a poly-A stretch of 300 and a stretch of
             the top_bit_motif across a tile edge
    poly_a   one base everywhere (every m-mer the same, every window tied)
    top_bit  the top_bit_motif repeated: every minimum has the top bit set
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    motif = np.array(top_bit_motif(m), dtype=np.int8)
    if kind == "random":
        codes[100:400] = 0
        at = min(SCAN_TILE - 150, max(n - 300, 0))
        codes[at: at + 300] = np.tile(motif, 75)[: codes[at: at + 300].size]
    elif kind == "poly_a":
        codes[:] = 0
    elif kind == "top_bit":
        codes[:] = np.tile(motif, -(-n // 4))[:n]
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return codes


def scan_cases() -> list[tuple[str, str, int, int, int, int, int]]:
    """(name, kind, n, k, m, num_buckets, seed) of every scan case, the
    codes scan_case_codes(kind, n, m, seed): K = 15, 31,
    55, 95 and 96 with m = 1, 2, 7, 17 and k - 1 (where m < k), over two
    tiles and a ragged third, the bucket counts taken in turn (1, 3, 9, 24,
    65,537); then the poly-A and top-bit kinds, a window of 96 hashes (K =
    96, m = 1), and inputs shorter than one window."""
    ragged = 2 * SCAN_TILE + 333
    pairs = [(k, m) for k in SCAN_KS for m in (*SCAN_MS, k - 1) if m < k]
    cases = [("random", ragged, k, m, SCAN_BUCKETS[i % len(SCAN_BUCKETS)])
             for i, (k, m) in enumerate(pairs)]
    cases += [(kind, ragged, k, m, b) for kind in ("poly_a", "top_bit")
              for k, m, b in ((31, 17, 24), (96, 1, 65_537), (15, 7, 3))]
    cases += [("random", n, k, m, 9) for n, k, m in ((1, 31, 17), (40, 55, 17),
                                                     (95, 96, 1))]
    return [(f"{kind}-n{n}-k{k}-m{m}-b{b}", kind, n, k, m, b, 300 + i)
            for i, (kind, n, k, m, b) in enumerate(cases)]


SCAN_SHARED_BINS = 2048  # buckets csrc/minimizer_scan.cu counts in shared memory
SCAN_MASKS = ("seeded", "none", "all")


def scan_geometry(k: int, m: int) -> tuple[int, int, int]:
    """(strip, threads, out) of csrc/minimizer_scan.cu at (k, m): the
    positions a thread rolls, the threads of a block and the positions a
    block outputs (the kernel's `geometry`)."""
    w = k - m + 1
    strip = w * max(1, 16 // w)
    threads = min(256, (4096 // strip) // 32 * 32)
    return strip, threads, (threads * strip - w) & ~15


def scan_mask(mask: str, n: int, k: int, seed: int) -> np.ndarray:
    """(n,) bool validity of a sized scan case.

    seeded  ~70% of the positions, at random
    none    no position
    all     every position, the last k - 1 too (their buckets wrap)
    reads   the k-mer starts of reads of 0 to 3k bases, a fifth of them
            empty (zero-length reads), cut at n
    """
    rng = np.random.default_rng(seed)
    if mask == "seeded":
        return rng.random(n) < 0.7
    if mask in ("none", "all"):
        return np.full(n, mask == "all")
    if mask != "reads":
        raise ValueError(f"unknown mask {mask!r}")
    lengths = rng.integers(0, 3 * k, n // k + 2)
    lengths[rng.random(lengths.size) < 0.2] = 0
    ends = np.cumsum(lengths)
    pos = np.arange(n)
    read = np.searchsorted(ends, pos, side="right")
    return pos + k <= ends[np.minimum(read, ends.size - 1)]


def sized_scan_cases() -> list[tuple[str, str, int, int, int, int, int, str]]:
    """(name, kind, n, k, m, num_buckets, seed, mask) of the sized scan's
    hard cases (the codes scan_case_codes(kind, n, m, seed), the mask
    scan_mask(mask, n, k, seed)), by the redesigned kernel's geometry
    (scan_geometry):

    edges    n at one block's output T, 2T - 1 and 2T + 1 (the blocks'
             seams, where each block's last segment only feeds the one
             before it) at (K, m) = (31, 17) (strip 15, T = 3824), (96, 1)
             (a window of 96, 32 threads), (20, 19) (w = 2, a strip of 8
             segments) and (23, 15) (w = 9, a strip of 9)
    bins     255 buckets (a copy of the bins a warp), 257 (one copy a
             block), SCAN_SHARED_BINS (the cap), one past it and 65,537
             (counted by global atomics)
    masks    every mask of scan_mask at (31, 17), among them the reads
             with zero-length reads
    top_bit  every minimum's hash with its top bit set, every mask
    """
    cases = []
    for k, m in ((31, 17), (96, 1), (20, 19), (23, 15)):
        out = scan_geometry(k, m)[2]
        for n in (out, 2 * out - 1, 2 * out + 1):
            cases.append(("edges", "random", n, k, m, 3, "seeded"))
    ragged = 2 * scan_geometry(31, 17)[2] + 333
    for b in (255, 257, SCAN_SHARED_BINS, SCAN_SHARED_BINS + 1, 65_537):
        cases.append(("bins", "random", ragged, 31, 17, b, "seeded"))
    for mask in (*SCAN_MASKS, "reads"):
        cases.append(("masks", "random", ragged, 31, 17, 3, mask))
        cases.append(("top_bit", "top_bit", ragged, 31, 17, 24, mask))
    return [(f"{group}-n{n}-k{k}-m{m}-b{b}-{mask}", kind, n, k, m, b, 500 + i, mask)
            for i, (group, kind, n, k, m, b, mask) in enumerate(cases)]


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
# ExtPartialStore calls them, and the key streams', as its KeyPartialStore
# calls them.
SCHEDULER_COUNTED = ("merge_ext_partials_device", "merge_ext_partials",
                     "merge_key_partials_device", "merge_key_partials")
COUNTED = ("_shard_body_range", "_shard_body_range_combiner", "_shard_body_bucketed",
           "_shard_body_ext_range", "_shard_body_ext_bucketed", "count_reads_sharded",
           "count_reads_sharded_ext", "count_reads_sharded_streaming", *SUPERMER_COUNTED,
           *SCHEDULER_COUNTED)


def call_counters(stack, pipeline_mod) -> dict:
    """Count the calls of the step bodies (the overflow retry and the
    combiner re-run show in them), of the sharded entries (the facade's
    choice shows in them), of the supermer route's step and heavy
    pre-counts (device and host), and of the streams' device and host
    merges (extension and key partials)."""
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


# The host crossings copy_counters counts, by the name every module that
# makes them imports.
CROSSINGS = ("to_host", "to_device", "host_histogram")


def copy_counters(stack) -> dict:
    """Record the crossings of a counted call: each `to_host` call's
    element count (every array of the call), each `to_device` call's, and
    each `host_histogram` call's, under their names, wherever the port's
    counting modules (parallel/pipeline, supermer_route and multihost, the
    scheduler and the single-device pipeline) call them."""
    from unittest import mock

    from . import pipeline as root
    from .parallel import multihost, supermer_route
    from .parallel import pipeline as sharded
    from .runtime import scheduler

    seen = {name: [] for name in CROSSINGS}
    for name in CROSSINGS:
        real = getattr(root, name)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            arrays = out if isinstance(out, list) else [out]
            seen[_name].append(sum(int(x.numel()) if isinstance(x, torch.Tensor)
                                   else int(np.size(x)) for x in arrays))
            return out

        for mod in (root, sharded, supermer_route, multihost, scheduler):
            if getattr(mod, name, None) is real:
                stack.enter_context(mock.patch.object(mod, name, spy))
    return seen


def _fault_patches(stack, job: dict, rank: int) -> None:
    """The memory faults a job asks for, on the ranks of its `fault_ranks`
    (every rank where it names none): `headroom_seq`, the device headroom
    the streams' stores see at their successive budget checks (bytes, None
    for no budget; the last repeats), and `merge_oom`, the key streams'
    device merge raising torch.cuda.OutOfMemoryError."""
    from unittest import mock

    from .runtime import memcheck, scheduler

    if rank not in job.get("fault_ranks", [rank]):
        return
    if "headroom_seq" in job:
        seq, checks = list(job["headroom_seq"]), []

        def headroom(device, safety=0.9):
            checks.append(device)
            return seq[min(len(checks), len(seq)) - 1]

        stack.enter_context(mock.patch.object(memcheck, "hbm_headroom_bytes", headroom))
    if job.get("merge_oom"):
        def merge(*a, **k):
            raise torch.cuda.OutOfMemoryError("out of memory (injected)")

        stack.enter_context(mock.patch.object(scheduler, "merge_key_partials_device",
                                              merge))


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

    Any counting job also takes fault_ranks, headroom_seq and merge_oom
    (_fault_patches). A counting job writes keys, counts, hist, each
    counted function's calls, each host crossing's element counts
    (copy_counters: crossings_<name>) and the streamed stores' partials
    (scheduler.partials: held, held_bytes, drained); an extension-mode list
    also every k-mer's occurrences end to end (occ_rid, occ_pos).
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
    from .runtime import memcheck, scheduler

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
                crossings = copy_counters(stack)
                _fault_patches(stack, job, rank)
                scheduler.reset_partials()
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
                       calls=np.array([calls[n] for n in COUNTED], dtype=np.int64),
                       partials=np.array([scheduler.partials[n] for n in
                                          ("held", "held_bytes", "drained")]),
                       **{f"crossings_{n}": np.array(v, dtype=np.int64)
                          for n, v in crossings.items()})
            if isinstance(kl, KmerListExt):
                out.update(occ_rid=kl.occ_rid, occ_pos=kl.occ_pos)
        np.savez(path + ".npz", **out)
