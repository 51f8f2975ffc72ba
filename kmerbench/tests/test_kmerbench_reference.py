"""The reference counter and the comparison against a brute-force counter
written in plain Python, on tiny read sets."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from kmerbench.reference import compare, counter


def brute(reads: list[list[int]], k: int, lower: int, upper: int):
    """{canonical key: [count, sorted flat starts]} of kept keys, and the
    histogram over [0, upper]."""
    found = collections.defaultdict(list)
    start = 0
    for read in reads:
        for i in range(len(read) - k + 1):
            fwd = rev = 0
            for j in range(k):
                fwd = fwd * 4 + read[i + j]
                rev = rev * 4 + (3 - read[i + k - 1 - j])
            found[min(fwd, rev)].append(start + i)
        start += len(read)
    kept = {key: occ for key, occ in found.items() if lower <= len(occ) <= upper}
    hist = np.zeros(upper + 1, dtype=np.int64)
    for occ in kept.values():
        hist[len(occ)] += 1
    return kept, hist


def tiny_reads(seed: int, n_reads: int, alphabet: int = 4):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, n_reads)
    genome = rng.integers(0, alphabet, 60)
    reads = []
    for n in lens:
        s = rng.integers(0, 60 - n + 1)
        reads.append([int(x) for x in genome[s:s + n]])
    return reads


def as_tensors(reads):
    codes = torch.tensor([b for r in reads for b in r], dtype=torch.uint8)
    lengths = np.array([len(r) for r in reads], dtype=np.int64)
    return codes, lengths


def rows_of(keys: list[int], k: int) -> np.ndarray:
    """Key values -> (M, W) uint32 rows as the counter lays them out."""
    words = (k + 15) // 16
    last = k - 16 * (words - 1)
    rows = np.zeros((len(keys), words), dtype=np.uint32)
    for i, key in enumerate(keys):
        rows[i, -1] = (key & ((1 << (2 * last)) - 1)) << (32 - 2 * last)
        key >>= 2 * last
        for w in range(words - 2, -1, -1):
            rows[i, w] = key & 0xFFFFFFFF
            key >>= 32
    return rows


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [3, 5, 17, 31])
def test_kmerbench_reference_counts_as_brute_force(seed, k):
    reads = tiny_reads(seed, 30, alphabet=2 if seed % 2 else 4)
    codes, lengths = as_tensors(reads)
    want, hist = brute(reads, k, 2, 9)
    got = list(counter.count(codes, lengths, k, 2, 9, extension=True))
    assert len(got) == 1
    ref = got[0][2]
    assert ref.keys.tolist() == sorted(want)
    assert ref.counts.tolist() == [len(want[key]) for key in sorted(want)]
    assert counter.histogram(ref.counts, 9).tolist() == hist.tolist()
    rows = ref.occ_row.tolist()
    starts = ref.occ_start.tolist()
    for j, key in enumerate(sorted(want)):
        assert [s for r, s in zip(rows, starts) if r == j] == sorted(want[key])


def test_kmerbench_reference_partitions_cover_the_keys(monkeypatch):
    reads = tiny_reads(7, 60)
    codes, lengths = as_tensors(reads)
    monkeypatch.setattr(counter, "PART_KEYS", 64)
    parts = list(counter.count(codes, lengths, 7, 1, 99))
    assert len(parts) > 1
    keys = sorted(x for _, _, c in parts for x in c.keys.tolist())
    want, _ = brute(reads, 7, 1, 99)
    assert keys == sorted(want)


def test_kmerbench_key_rows_round_trip():
    rng = np.random.default_rng(3)
    for k in (5, 16, 17, 31):
        keys = [int(x) for x in rng.integers(0, 1 << (2 * k), 20, dtype=np.int64)]
        assert compare.key_values(rows_of(keys, k), k).tolist() == keys


def result_of(want, hist, k, lengths, mutate=None):
    keys = sorted(want)
    counts = [len(want[x]) for x in keys]
    occ = [list(want[x]) for x in keys]
    if mutate:
        keys, counts, occ, hist = mutate(keys, counts, occ, hist.copy())
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(o) for o in occ], out=offsets[1:])
    read_starts = counter.read_offsets(lengths)
    flat = np.array([s for o in occ for s in o], dtype=np.int64)
    rid = np.searchsorted(read_starts, flat, side="right") - 1
    pos = flat - read_starts[rid]
    return compare.Result.from_arrays(rows_of(keys, k), np.array(counts), hist, k, "cpu",
                                      lengths, rid, pos, offsets)


def _count_up(keys, counts, occ, hist):
    counts = list(counts)
    counts[0] += 1
    return keys, counts, occ, hist


def _drop_row(keys, counts, occ, hist):
    return keys[1:], counts[1:], occ[1:], hist


def _move_occurrence(keys, counts, occ, hist):
    occ = [list(o) for o in occ]
    occ[0][0] += 1
    return keys, counts, occ, hist


def _duplicate_row(keys, counts, occ, hist):
    return keys[:1] + keys, counts[:1] + counts, occ[:1] + occ, hist


def _histogram_bin(keys, counts, occ, hist):
    hist[2] += 1
    return keys, counts, occ, hist


@pytest.mark.parametrize("mutate,wrong", [
    (None, set()), (_count_up, {"rows_wrong"}), (_drop_row, {"rows_wrong", "occ_wrong"}),
    (_move_occurrence, {"occ_wrong"}), (_duplicate_row, {"rows_wrong", "occ_wrong"}),
    (_histogram_bin, {"hist_wrong"}),
])
def test_kmerbench_compare_finds_each_fault(mutate, wrong):
    reads = tiny_reads(11, 40)
    codes, lengths = as_tensors(reads)
    k = 5
    want, hist = brute(reads, k, 2, 30)
    got = compare.compare(result_of(want, hist, k, lengths, mutate), codes, lengths, k, 2,
                          30, extension=True)
    assert {name for name, value in got.items() if value} == wrong, got


def test_kmerbench_control_fails_with_narrow_fingerprints():
    reads = tiny_reads(5, 200)
    codes, lengths = as_tensors(reads)
    k = 9
    keys, counts, rows, starts = counter.fingerprint_counts(codes, lengths, k, 1, 99,
                                                            extension=True, bits=6)
    res = compare.Result(keys, counts, counter.histogram(counts, 99), "cpu", rows, starts)
    got = compare.compare(res, codes, lengths, k, 1, 99, extension=True)
    assert got["rows_wrong"] > 0 and got["occ_wrong"] > 0
    keys, counts, rows, starts = counter.fingerprint_counts(codes, lengths, k, 1, 99,
                                                            extension=True, bits=62)
    res = compare.Result(keys, counts, counter.histogram(counts, 99), "cpu", rows, starts)
    assert compare.compare(res, codes, lengths, k, 1, 99, extension=True) == {
        "rows_wrong": 0, "hist_wrong": 0, "occ_wrong": 0}
