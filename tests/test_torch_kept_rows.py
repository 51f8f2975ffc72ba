"""The result stage (ops/compact.py: compact_kept, counts_histogram,
gather_runs) on every case of hysortk_tpu_torch.testing.kept_rows_cases and
gather_runs_cases: the plain versions against the JAX package (compact_keys
and host_histogram, unmix_keys_np for mixed keys, split_occurrences and
assemble_ext_result for the occurrences), the modes the streams use (the
sentinel tail to a pad, the output that does not sync) against the same
rows, and the kernels (csrc/kept_rows.cu) against the plain versions on a
card (`cuda` marker). Seeded numpy inputs; the tolerance is exact
equality."""

import types

import numpy as np
import pytest
import torch

from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu.ops import mixkey as jmixkey
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.ops import compact

CASES = testing.kept_rows_cases()
IDS = [c[0] for c in CASES]
GATHER = testing.gather_runs_cases()
GATHER_IDS = [c[0] for c in GATHER]


def _tensors(case, device="cpu"):
    """(words, cnt, keep) as compact_kept takes them."""
    _, words, cnt, keep, *_ = case
    return ([torch.from_numpy(w.view(np.int32)).to(device) for w in words],
            torch.from_numpy(cnt).to(device), torch.from_numpy(keep).to(device))


def _jax_rows(case):
    """The JAX package's kept keys (unmixed where the case is mixed), counts
    and histogram."""
    _, words, cnt, keep, _, hist_upper, mixed = case
    keys = jpipeline.compact_keys(list(words), keep).reshape(-1, words.shape[0])
    if mixed:
        keys = jmixkey.unmix_keys_np(keys)
    counts = cnt[keep].astype(np.int64)
    # np.bincount sizes its output by the largest count: the counts past
    # the histogram's bound, which it drops, are left out first.
    hist = jpipeline.host_histogram(counts[counts <= hist_upper], hist_upper)
    return keys.astype(np.uint32), counts, hist


def _kept(case, device="cpu", fn=compact.compact_kept, **kw):
    _, _, _, _, upper, hist_upper, mixed = case
    return fn(*_tensors(case, device), upper=upper, mixed=mixed, hist_upper=hist_upper,
              **kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_compaction_matches_jax(case):
    _, _, _, keep, upper, _, _ = case
    got = _kept(case, fn=compact.compact_kept_plain, slots=True, offsets=True)
    keys, counts, hist = _jax_rows(case)
    assert got.m == keep.sum() and got.keys.shape == keys.shape
    assert np.array_equal(got.keys.numpy().view(np.uint32), keys)
    assert got.counts.dtype == compact.narrow_dtype(upper)
    assert np.array_equal(got.counts.to(torch.int64).numpy(), counts)
    assert got.hist.dtype == torch.int64 and np.array_equal(got.hist.numpy(), hist)
    assert np.array_equal(got.slots.numpy(), np.flatnonzero(keep))
    assert np.array_equal(got.offsets.numpy(), np.cumsum(counts) - counts)
    assert got.occ == counts.sum()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tail_and_unsynced_modes_hold_the_same_rows(case):
    """rows=True with a pad: the kept rows then the sentinel tail to a
    multiple of the pad; sync=False: n rows, the count a 0-d tensor."""
    _, words, _, keep, upper, _, _ = case
    n, m = keep.size, int(keep.sum())
    keys, counts, _ = _jax_rows(case)
    pad = 7 if -(-m // 7) * 7 <= n else 1  # the tail lies within the block
    outs = [(compact.compact_kept(*_tensors(case), upper=upper, mixed=case[6], rows=True,
                                  pad=pad), -(-m // pad) * pad)]
    outs.append((compact.compact_kept(*_tensors(case), upper=upper, mixed=case[6],
                                      rows=True, sync=False), n))
    for got, length in outs:
        assert len(got.keys) == words.shape[0]
        for w, row in enumerate(got.keys):
            assert row.shape == (length,) and row.is_contiguous()
            assert np.array_equal(row[:m].numpy().view(np.uint32), keys[:, w])
            assert (row[m:] == -1).all()
        assert np.array_equal(got.counts[:m].to(torch.int64).numpy(), counts)
        assert (got.counts[m:] == 0).all()
        assert int(got.m) == m
    assert isinstance(outs[1][0].m, torch.Tensor) and outs[1][0].m.dim() == 0


def _at(t: torch.Tensor, off: int) -> torch.Tensor:
    """t as a view `off` elements into a larger tensor."""
    return torch.cat([t.new_zeros(off), t])[off:]


def test_kept_rows_cases_reach_their_edges():
    by_name = {c[0]: c for c in CASES}
    t, g = testing.KEPT_ROWS_TILE, testing.KEPT_ROWS_GROUP
    assert {c[3].size for c in CASES} >= {0, 1, 100, t - 1, t, t + 1, g - 1, g, g + 1}
    assert {c[1].shape[0] for c in CASES} == set(range(1, 7))
    assert {compact.narrow_dtype(c[4]) for c in CASES} == {torch.uint8, torch.uint16,
                                                          torch.int32}
    assert {c[4] for c in CASES} >= {255, 256, 65535, 65536}
    assert not by_name["none_kept"][3].any() and by_name["all_kept"][3].all()
    gap = by_name["gap"][3]
    assert gap[:t].any() and not gap[t:2 * t].any() and gap[2 * t:3 * t].any()
    # far_gap: more than a look-back window of count blocks without a kept
    # row between blocks that have some.
    far = by_name["far_gap"][3]
    blocks = np.add.reduceat(far, np.arange(0, far.size, g))
    empty = np.flatnonzero(blocks == 0)
    assert blocks[0] and blocks[-1] and empty.size > testing.KEPT_ROWS_WINDOW
    assert np.array_equal(empty, np.arange(empty[0], empty[0] + empty.size))
    last = by_name["last_kept"][3]
    assert last[-1] and last.sum() == 1 and last.size % t != 0
    unf = by_name["unfiltered"]
    assert (unf[2][unf[3]] > unf[5]).any()  # kept counts past the histogram
    big = by_name["u65535"]
    assert (big[2][big[3]] >= testing.KEPT_ROWS_BINS).any()
    for name in ("top_bit", "mixed_w2"):
        _, words, _, keep, *_ = by_name[name]
        keys = _jax_rows(by_name[name])[0]
        assert (keys == 0xFFFFFFFF).all(axis=1).any()  # sentinels kept
    assert (by_name["top_bit"][1] >= 0x80000000).all()


@pytest.mark.parametrize("upper", [0, 5, 50, 1023, 1024, 65535])
def test_counts_histogram_matches_jax(upper):
    rng = np.random.default_rng(upper)
    counts = np.concatenate([rng.integers(0, upper + 1, 5000),
                             rng.integers(upper + 1, 2**31 - 1, 50)]).astype(np.int32)
    got = compact.counts_histogram(torch.from_numpy(counts), upper)
    want = jpipeline.host_histogram(counts[counts <= upper], upper)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def _gather_tensors(case, device="cpu"):
    _, starts, lengths, arrays = case
    return (torch.from_numpy(starts).to(device), torch.from_numpy(lengths).to(device),
            *[torch.from_numpy(a).to(device) for a in arrays])


@pytest.mark.parametrize("case", GATHER, ids=GATHER_IDS)
def test_plain_gather_matches_jax(case):
    _, starts, lengths, arrays = case
    got = compact.gather_runs_plain(*_gather_tensors(case))
    want = jpipeline.split_occurrences(starts, lengths, *arrays)
    assert len(got) == arrays.shape[0]
    for g, runs in zip(got, want):
        assert np.array_equal(g.numpy(), np.concatenate([np.zeros(0, np.int32), *runs]))
    # The wrapper takes the plain version on the CPU, offsets given or not.
    offsets = torch.from_numpy((np.cumsum(lengths) - lengths).astype(np.int32))
    again = compact.gather_runs(*_gather_tensors(case), offsets=offsets,
                                total=int(lengths.sum()))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_gather_runs_cases_reach_their_edges():
    by_name = {c[0]: c for c in GATHER}
    t = testing.GATHER_TILE
    assert {int(c[2].sum()) for c in GATHER} >= {t - 1, t, t + 1}
    assert by_name["long_run"][2].max() > 10 * t
    many = by_name["many_runs"][2]
    assert np.searchsorted(np.cumsum(many), t) > testing.GATHER_STAGED
    zero = by_name["zero_length"][2]
    ends = np.cumsum(zero)
    assert (zero == 0).any() and ((ends % t == 0) & (zero == 0)).any()
    assert (by_name["aligned"][1] % 4 == 0).all() and (by_name["aligned"][2] % 4 == 0).all()
    assert by_name["one_array"][3].shape[0] == 1 and by_name["one_run"][1].size == 1


@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_kept_occurrences_match_assemble_ext_result(n_words):
    """A sorted block's kept runs and their occurrences (the extension
    step's compaction, compact_kept + gather_runs) against the JAX
    package's host assembly."""
    from hysortk_tpu_torch import pipeline

    rng = np.random.default_rng(70 + n_words)
    keys = np.unique(rng.integers(0, 2**32, (2500, n_words), dtype=np.uint64)
                     .astype(np.uint32), axis=0)  # ascending rows
    runs = rng.geometric(0.2, keys.shape[0])
    n = int(runs.sum())
    words = np.repeat(keys, runs, axis=0).T.copy()
    heads = np.concatenate([[0], np.cumsum(runs)[:-1]])
    assert runs.size > 2000
    cnt = np.zeros(n, np.int32)
    cnt[heads] = runs
    keep = np.zeros(n, bool)
    keep[heads] = (runs >= 2) & (runs <= 9)
    rid = rng.integers(0, 2**31, n).astype(np.int32)
    pos = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    want = jpipeline.assemble_ext_result(list(words), cnt, keep, rid, pos,
                                         types.SimpleNamespace(k=31))
    kept, got_rid, got_pos = pipeline.kept_occurrences(
        [torch.from_numpy(w.view(np.int32)) for w in words], torch.from_numpy(cnt),
        torch.from_numpy(keep), torch.from_numpy(rid), torch.from_numpy(pos.view(np.int32)))
    assert np.array_equal(kept.keys.numpy().view(np.uint32), want.keys)
    assert np.array_equal(kept.counts.numpy(), want.counts)
    assert np.array_equal(got_rid.numpy(), np.concatenate(want.rid))
    assert np.array_equal(got_pos.numpy().view(np.uint32), np.concatenate(want.pos))


def test_compaction_rejects_what_it_does_not_take():
    words = [torch.zeros(8, dtype=torch.int32)]
    cnt = torch.ones(8, dtype=torch.int32)
    keep = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):  # seven key words
        compact.compact_kept(words * 7, cnt, keep)
    with pytest.raises(ValueError):
        compact.compact_kept([words[0].to(torch.int64)], cnt, keep)
    with pytest.raises(ValueError):
        compact.compact_kept(words, cnt, keep.to(torch.uint8))
    with pytest.raises(ValueError):
        compact.compact_kept(words, cnt[:7], keep)
    with pytest.raises(ValueError):  # no slots without the sync
        compact.compact_kept(words, cnt, keep, slots=True, sync=False)
    with pytest.raises(ValueError):  # the pad reaches past the block
        compact.compact_kept(words, cnt, keep, pad=16)
    with pytest.raises(ValueError):
        compact.counts_histogram(cnt, 2**31 - 1)
    with pytest.raises(ValueError):
        compact.gather_runs(cnt, cnt, cnt, cnt, cnt)
    with pytest.raises(ValueError):
        compact.gather_runs(cnt, cnt[:4], cnt)


# ---------------------------------------------------------------------------
# On the card: the kernels against the plain versions.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want) -> None:
    for name in ("keys", "counts", "hist", "slots", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        elif isinstance(w, list):
            assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w)), name
        else:
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), name
    assert int(got.m) == int(want.m) and got.occ == want.occ


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kept_rows_kernel_matches_plain(case, cuda):
    m = int(case[3].sum())
    modes = [dict(slots=True, offsets=True), dict(rows=True, sync=False), dict()]
    if -(-m // 3) * 3 <= case[3].size:
        modes.append(dict(rows=True, pad=3))
    for mode in modes:
        before = _build.launches["kept_rows"]
        got = _kept(case, cuda, **mode)
        torch.cuda.synchronize()
        assert _build.launches["kept_rows"] == before + 1
        _same(got, _kept(case, fn=compact.compact_kept_plain, **mode))
    # Rows at odd offsets: keep not 8- or 16-byte aligned.
    _, _, _, _, upper, hist_upper, mixed = case
    words, cnt, keep = _tensors(case, cuda)
    got = compact.compact_kept([_at(w, 1) for w in words], _at(cnt, 1), _at(keep, 3),
                               upper=upper, mixed=mixed, hist_upper=hist_upper,
                               slots=True, offsets=True)
    _same(got, _kept(case, fn=compact.compact_kept_plain, slots=True, offsets=True))


@pytest.mark.cuda
@pytest.mark.parametrize("upper", [50, 1024, 65535])
def test_histogram_kernel_matches_plain(upper, cuda):
    rng = np.random.default_rng(upper)
    counts = torch.from_numpy(rng.integers(0, 2 * upper, 100_003).astype(np.int32))
    got = compact.counts_histogram(counts.to(cuda), upper)
    assert torch.equal(got.cpu(), compact.counts_histogram_plain(counts, upper))
    # Off the 16-byte boundary: the scalar loads.
    got = compact.counts_histogram(_at(counts.to(cuda), 1), upper)
    assert torch.equal(got.cpu(), compact.counts_histogram_plain(counts, upper))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATHER, ids=GATHER_IDS)
def test_gather_runs_kernel_matches_plain(case, cuda):
    before = _build.launches["gather_runs"]
    got = compact.gather_runs(*_gather_tensors(case, cuda))
    torch.cuda.synchronize()
    assert _build.launches["gather_runs"] == before + 1
    want = compact.gather_runs_plain(*_gather_tensors(case))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
