"""The device merge of streamed extension-mode partials (pipeline.ExtPartial,
merge_ext_partials_device, runtime/scheduler.ExtPartialStore) and the key
unmix on the device (ops/mixkey.unmix_keys) against the JAX package on the
CPU, where the run merge and the weighted run-length sum run their plain
versions.

The tolerance is exact equality: keys, counts and histogram array-equal to
hysortk_tpu.pipeline.merge_ext_partials on the same seeded partials and
occurrences equal by as_dict() (the JAX sort is unstable); against the
port's host merge, which the device merge replaces, every array is equal,
occurrence order included."""

import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

import hysortk_tpu
from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu import testing as oracle
from hysortk_tpu.ops import mixkey as jmixkey
from hysortk_tpu.runtime import scheduler as jsched
from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch.ops import mixkey
from hysortk_tpu_torch.runtime import memcheck, scheduler

KS = [15, 31, 41, 55]  # one, two, three and four key words
WIDE_KS = [95, 96]  # six key words: the run merge's widest rows (eight with two payloads)
KINDS = ["no_partials", "empty_partials", "single", "every_batch", "cross_bounds",
         "top_bit", "shuffled", "reads"]


def _cfgs(k, **kw):
    fields = dict(k=k, m=min(17, k - 1), lower=2, upper=6, pad_multiple=256,
                  extension=True)
    fields.update(kw)
    j = hysortk_tpu.KmerConfig(**fields)
    return config.from_jax_fields(dataclasses.asdict(j)), j


def _ascending(keys: np.ndarray) -> np.ndarray:
    return np.lexsort(tuple(keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)))


def _host_partial(rng, keys, counts, k, order=None) -> pipeline.KmerListExt:
    """Distinct keys with their counts and seeded occurrences, rows in
    `order` (ascending where None)."""
    keys = np.asarray(keys, np.uint32)
    counts = np.asarray(counts, np.int32)
    order = _ascending(keys) if order is None else order
    keys, counts = keys[order], counts[order]
    n = int(counts.sum())
    return pipeline.KmerListExt.from_flat(
        keys, counts, k, rng.integers(0, 10**6, n).astype(np.int32),
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))


def _on_device(part: pipeline.KmerListExt, ascending=True) -> pipeline.ExtPartial:
    return pipeline.ExtPartial(
        torch.from_numpy(part.keys.view(np.int32).copy()),
        torch.from_numpy(part.counts.copy()),
        torch.from_numpy(part.occ_rid.copy()),
        torch.from_numpy(part.occ_pos.view(np.int32).copy()), ascending)


def _reads_partial(reads, cfg, rid0):
    codes, lengths = fasta_io.reads_to_codes(reads)
    return pipeline.count_reads_ext(codes, lengths, cfg, rid0, device="cpu")[0]


def _partials(kind, k, cfg, rng):
    """(host partials, whether they are ascending) of each kind."""
    words = cfg.words
    pool = rng.integers(0, 2**32, (64, words), dtype=np.uint64).astype(np.uint32)
    if kind == "top_bit":
        pool[:32, 0] |= np.uint32(0x80000000)
        pool[32:40] = 0xFFFFFFFF
        pool[32:40, -1] = np.arange(0xFFFFFFF0, 0xFFFFFFF8, dtype=np.uint32)  # near the sentinel
        pool[40, 0], pool[41, 0] = 0x7FFFFFFF, 0x80000000
    empty = pipeline.KmerListExt(np.zeros((0, words), np.uint32), np.zeros(0, np.int32), k)
    if kind == "no_partials":
        return [], True
    if kind == "empty_partials":
        return [empty, empty, empty], True
    if kind == "reads":
        base = oracle.random_reads(rng, 14, k, 140, "ACGTNacgt")
        return [_reads_partial(base + base[:5], cfg, 0), empty,
                _reads_partial(base[3:] + base[:2], cfg, 200),
                _reads_partial(base, cfg, 400)], True
    if kind == "cross_bounds":
        # L=2, U=6: key 0 at 1 in two batches (kept only once merged), key 1
        # within [L, U] in every batch and above U merged, key 2 above U in
        # one batch, keys 3 and 4 in one batch each.
        rows = [[(0, 1), (1, 3), (3, 2)], [(0, 1), (1, 3), (2, 9)], [(1, 2), (4, 1)]]
        return [_host_partial(rng, pool[[i for i, _ in r]], [c for _, c in r], k)
                for r in rows], True
    if kind == "single":
        return [_host_partial(rng, pool[:20], rng.integers(1, 5, 20), k)], True
    parts = []
    for b in range(5):
        sel = rng.choice(np.arange(1, 64), int(rng.integers(5, 30)), replace=False)
        if kind == "every_batch":
            sel = np.append(sel, 0)
        order = rng.permutation(sel.size) if kind == "shuffled" else None
        parts.append(_host_partial(rng, pool[sel], rng.integers(1, 4, sel.size), k, order))
    return parts, kind != "shuffled"


@pytest.mark.parametrize("k", KS + WIDE_KS)
@pytest.mark.parametrize("kind", KINDS)
def test_device_merge_matches_jax(kind, k):
    rng = np.random.default_rng(k * 100 + KINDS.index(kind))
    cfg, _ = _cfgs(k)
    host_parts, ascending = _partials(kind, k, cfg, rng)
    parts = [pipeline.ascending_partial(_on_device(p, ascending)) for p in host_parts]
    for p in parts:  # the run merge on the card takes ascending runs only
        keys = p.keys.numpy().view(np.uint32)
        assert p.ascending and np.array_equal(_ascending(keys), np.arange(len(keys)))
    if not ascending and parts:
        with pytest.raises(ValueError, match="ascending"):
            pipeline.merge_ext_partials_device([_on_device(host_parts[0], False)], cfg)
    got, hist = pipeline.merge_ext_partials_device(parts, cfg)

    jparts = [jpipeline.KmerListExt(keys=p.keys, counts=p.counts, k=k, pos=list(p.pos),
                                    rid=list(p.rid)) for p in host_parts]
    want = jpipeline.merge_ext_partials(jparts, cfg.lower, cfg.upper, k, cfg.words)
    assert got.keys.dtype == np.uint32 and got.counts.dtype == np.int32
    assert got.keys.shape == (len(want.keys), cfg.words)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(hist, np.bincount(want.counts, minlength=cfg.upper + 1)
                          [: cfg.upper + 1].astype(np.int32))
    assert hist.dtype == np.int32 and hist.shape == (cfg.upper + 1,)
    assert got.as_dict() == pipeline.KmerListExt(
        want.keys, want.counts, k, pos=list(want.pos), rid=list(want.rid)).as_dict()

    host = pipeline.merge_ext_partials(host_parts, cfg.lower, cfg.upper, k, cfg.words)
    for name in ("keys", "counts", "occ_rid", "occ_pos", "offsets"):
        assert np.array_equal(getattr(got, name), getattr(host, name)), name
    assert (len(got) == 0) == (kind in ("no_partials", "empty_partials"))
    if kind == "top_bit":
        assert (got.keys[:, 0] >= 2**31).any() and (got.keys[:, 0] < 2**31).any()


def test_cross_bounds_keeps_only_merged_totals():
    """The filter sees only merged totals (L=2, U=6): a key at 1 in each of
    two batches is kept at 2, a key within [L, U] in every batch is dropped
    at 8, a key at 9 in one batch and one at 1 in one batch are dropped."""
    rng = np.random.default_rng(5)
    cfg, _ = _cfgs(31)
    host_parts, _ = _partials("cross_bounds", 31, cfg, rng)
    totals = {}
    for p in host_parts:
        for key, c in zip(map(tuple, p.keys.tolist()), p.counts.tolist()):
            totals[key] = totals.get(key, 0) + c
    assert sorted(totals.values()) == [1, 2, 2, 8, 9]
    got, hist = pipeline.merge_ext_partials_device(
        [_on_device(p) for p in host_parts], cfg)
    assert dict(zip(map(tuple, got.keys.tolist()), got.counts.tolist())) == {
        key: t for key, t in totals.items() if cfg.lower <= t <= cfg.upper}
    assert hist[2] == 2 and hist.sum() == 2


@pytest.mark.parametrize("w", range(1, 7))
def test_unmix_keys_matches_numpy(w):
    """unmix_keys inverts the mix on the tensors' device, equal to
    unmix_keys_np (the port's and the JAX package's), the sentinel its fixed
    point."""
    rng = np.random.default_rng(w)
    keys = rng.integers(0, 2**32, (3000, w), dtype=np.uint64).astype(np.uint32)
    keys[:8] = 0xFFFFFFFF
    keys[8:16, 0] |= np.uint32(0x80000000)
    mixed = jmixkey.mix_keys_np(keys)
    assert np.array_equal(mixed[:8], keys[:8])
    words = [torch.from_numpy(np.ascontiguousarray(mixed[:, i]).view(np.int32))
             for i in range(w)]
    got = torch.stack(mixkey.unmix_keys(words), dim=1).numpy().view(np.uint32)
    assert np.array_equal(got, keys)
    assert np.array_equal(got, jmixkey.unmix_keys_np(mixed))
    assert np.array_equal(got, mixkey.unmix_keys_np(mixed))
    again = mixkey.unmix_keys(mixkey.mix_keys_plain(
        [torch.from_numpy(np.ascontiguousarray(keys[:, i]).view(np.int32))
         for i in range(w)]))
    assert np.array_equal(torch.stack(again, 1).numpy().view(np.uint32), keys)
    with pytest.raises(ValueError):
        mixkey.unmix_keys([])


@pytest.mark.parametrize("k", KS)
def test_ext_partial_is_the_kept_prefix(k):
    """Under UNFILTERED bounds the kept runs' occurrences end to end are the
    first n_valid sorted slots: ext_partial equals kept_occurrences' gather
    (reads with Ns, reads shorter than k, empty records, repeats)."""
    rng = np.random.default_rng(k)
    reads = oracle.random_reads(rng, 30, 0, 150, "ACGTNacgt")
    reads[3] = ""
    reads += reads[:12]
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, _ = _cfgs(k)
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, "cpu")
    outs = pipeline._count_device_ext_packed(packed, lens, 7, k, n, *pipeline.UNFILTERED)
    part = pipeline.ext_partial(*outs)
    kept, rid, pos = pipeline.kept_occurrences(*outs)
    starts, counts = kept.slots.to(torch.int64), kept.counts
    assert len(part) == starts.shape[0] > 0 and part.ascending
    assert torch.equal(part.keys, torch.stack([w[starts] for w in outs[0]], dim=-1))
    assert torch.equal(part.counts, counts) and torch.equal(part.keys, kept.keys)
    assert torch.equal(part.occ_rid, rid) and torch.equal(part.occ_pos, pos)
    assert part.n_occ == int(counts.sum()) == kept.occ < n
    want = pipeline.count_reads_ext(codes, lengths, dataclasses.replace(cfg, unfiltered=True),
                                    7, device="cpu")[0]
    got = part.to_host(k)
    for name in ("keys", "counts", "occ_rid", "occ_pos", "offsets"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def _stream_reads(k):
    """Seeded reads in at least three batches of 900 bases."""
    rng = np.random.default_rng(40 + k)
    reads = oracle.random_reads(rng, 40, k - 5, 160, "ACGTNacgt")
    reads += reads[:16]
    codes, lengths = fasta_io.reads_to_codes(reads)
    assert len(scheduler.read_batch_spans(lengths, 900)) >= 3
    return codes, lengths


def _stream_case(k=31):
    codes, lengths = _stream_reads(k)
    cfg, jcfg = _cfgs(k, upper=20)
    want = jsched.count_reads_streaming_ext(codes, lengths, jcfg, 900, read_id_offset=3)
    return codes, lengths, cfg, want


def _assert_same(got, want):
    (gl, gh), (wl, wh) = got, want
    assert np.array_equal(gl.keys, wl.keys) and np.array_equal(gl.counts, wl.counts)
    assert np.array_equal(gh, wh) and len(gl) > 0
    assert gl.as_dict() == pipeline.KmerListExt(
        wl.keys, wl.counts, wl.k, pos=list(wl.pos), rid=list(wl.rid)).as_dict()


class _Spy:
    def __init__(self, monkeypatch, name, replace=None):
        self.calls = 0
        self.fn = replace or getattr(scheduler, name)
        monkeypatch.setattr(scheduler, name, self)

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("k", KS)
def test_stream_merges_on_the_device_only(k, monkeypatch):
    """count_reads_streaming_ext holds its partials and merges them by the
    device merge, once; the host merge is never called. Equal to the JAX
    stream at every key width."""
    codes, lengths, cfg, want = _stream_case(k)
    device = _Spy(monkeypatch, "merge_ext_partials_device")
    host = _Spy(monkeypatch, "merge_ext_partials")
    got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900,
                                              read_id_offset=3, device="cpu")
    _assert_same(got, want)
    assert (device.calls, host.calls) == (1, 0)


def test_out_of_memory_drains_and_other_errors_rise(monkeypatch, caplog):
    """Only torch.cuda.OutOfMemoryError in the device merge is recovered
    from: the held partials go to the host, the host merge finishes and a
    warning is logged; a RuntimeError, as a failed kernel launch raises,
    ends the run."""
    codes, lengths, cfg, want = _stream_case()

    def fail_with(exc):
        def merge(*a, **k):
            raise exc
        return merge

    _Spy(monkeypatch, "merge_ext_partials_device",
         fail_with(torch.cuda.OutOfMemoryError("out of memory")))
    host = _Spy(monkeypatch, "merge_ext_partials")
    with caplog.at_level(logging.WARNING, logger="hysortk_tpu_torch.stream"):
        got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900,
                                                  read_id_offset=3, device="cpu")
    _assert_same(got, want)
    assert host.calls == 1
    assert any("ran out of device memory" in r.getMessage() for r in caplog.records)
    assert any("drained to the host" in r.getMessage() for r in caplog.records)
    _Spy(monkeypatch, "merge_ext_partials_device",
         fail_with(RuntimeError("merge pass launch: CUDA error")))
    with pytest.raises(RuntimeError, match="merge pass launch"):
        scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900, device="cpu")


def test_out_of_memory_in_the_held_sort_drains(monkeypatch, caplog):
    """An out-of-memory error in the sort of a partial as the store holds
    it (ascending_partial, on the second partial) drains as one in the
    merge does: the held partial and this one go to the host, every later
    one too, and the host merge finishes, equal to the JAX stream, with the
    warnings logged; a RuntimeError there ends the run."""
    codes, lengths, cfg, want = _stream_case()
    real_sort = scheduler.ascending_partial
    sorts = []

    def sort_failing_with(exc):
        def sort(part):
            sorts.append(part)
            if len(sorts) == 2:
                raise exc
            return real_sort(part)
        return sort

    _Spy(monkeypatch, "ascending_partial",
         sort_failing_with(torch.cuda.OutOfMemoryError("out of memory")))
    device = _Spy(monkeypatch, "merge_ext_partials_device")
    host = _Spy(monkeypatch, "merge_ext_partials")
    with caplog.at_level(logging.WARNING, logger="hysortk_tpu_torch.stream"):
        got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900,
                                                  read_id_offset=3, device="cpu")
    _assert_same(got, want)
    assert len(sorts) == 2 and (device.calls, host.calls) == (0, 1)
    assert any("sorting an extension partial ran out of device memory" in r.getMessage()
               for r in caplog.records)
    assert any("drained to the host" in r.getMessage() for r in caplog.records)
    sorts.clear()
    _Spy(monkeypatch, "ascending_partial",
         sort_failing_with(RuntimeError("radix pass launch: CUDA error")))
    with pytest.raises(RuntimeError, match="radix pass launch"):
        scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900, device="cpu")


def test_budget_drains_to_the_host(monkeypatch, caplog):
    """A partial that would pass the budget drains the held ones to the host;
    every later partial goes there too and the host merge finishes, equal
    to the JAX stream, with a logged warning."""
    codes, lengths, cfg, want = _stream_case()
    sizes = []
    real_add = scheduler.ExtPartialStore.add

    def add(self, part):
        sizes.append(part.nbytes)
        real_add(self, part)
    monkeypatch.setattr(scheduler.ExtPartialStore, "add", add)
    # Room for the first partial's merge only.
    monkeypatch.setattr(memcheck, "hbm_headroom_bytes",
                        lambda device, safety=0.9: int(
                            scheduler.EXT_MERGE_FACTOR * sizes[0]) if sizes else 0)
    device = _Spy(monkeypatch, "merge_ext_partials_device")
    host = _Spy(monkeypatch, "merge_ext_partials")
    with caplog.at_level(logging.WARNING, logger="hysortk_tpu_torch.stream"):
        got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900,
                                                  read_id_offset=3, device="cpu")
    _assert_same(got, want)
    assert len(sizes) >= 3 and (device.calls, host.calls) == (0, 1)
    assert any("pass the device budget" in r.getMessage() for r in caplog.records)


def test_budget_rule(monkeypatch):
    """A partial is held while EXT_MERGE_FACTOR x the held bytes with it fit
    the headroom and the held occurrences stay below 2^31; no budget on the
    CPU (headroom None)."""
    store = scheduler.ExtPartialStore(_cfgs(31)[0], "cpu")
    part = types.SimpleNamespace(nbytes=1000, n_occ=100)
    store.held = [types.SimpleNamespace(nbytes=3000, n_occ=2**31 - 101)]
    factor = scheduler.EXT_MERGE_FACTOR
    for headroom, fits in ((None, True), (int(factor * 4000), True),
                           (int(factor * 4000) - 1, False)):
        monkeypatch.setattr(memcheck, "hbm_headroom_bytes", lambda d, h=headroom: h)
        assert store._fits(part) == fits
    part.n_occ = 101  # 2^31 occurrences held with it
    monkeypatch.setattr(memcheck, "hbm_headroom_bytes", lambda d: None)
    assert not store._fits(part)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_device_merge_on_cuda_matches_cpu(k):
    """On the card (the run merge and run-length sum kernels, the sort of a
    partial that is not ascending): every kind equal to the CPU merge, every
    array; and the stream equal to the CPU stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hysortk_tpu_torch import _build

    cfg, _ = _cfgs(k)
    for kind in KINDS:
        rng = np.random.default_rng(k * 100 + KINDS.index(kind))
        host_parts, ascending = _partials(kind, k, cfg, rng)
        cpu = [pipeline.ascending_partial(_on_device(p, ascending)) for p in host_parts]
        card = [pipeline.ascending_partial(dataclasses.replace(
            _on_device(p, ascending), **{f: getattr(_on_device(p), f).cuda() for f in
                                         ("keys", "counts", "occ_rid", "occ_pos")}))
                for p in host_parts]
        want, want_hist = pipeline.merge_ext_partials_device(cpu, cfg)
        before = dict(_build.launches)
        got, hist = pipeline.merge_ext_partials_device(card, cfg)
        if sum(len(p) > 0 for p in host_parts) > 1:
            assert _build.launches["merge_runs"] > before["merge_runs"], kind
            assert _build.launches["run_length_sum"] > before["run_length_sum"], kind
        assert np.array_equal(hist, want_hist), kind
        for name in ("keys", "counts", "occ_rid", "occ_pos", "offsets"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), (kind, name)
    codes, lengths = _stream_reads(k)
    cfg, _ = _cfgs(k, upper=20)
    got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900, 3, device="cuda")
    want = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900, 3, device="cpu")
    assert np.array_equal(got[1], want[1])
    for name in ("keys", "counts", "occ_rid", "occ_pos", "offsets"):
        assert np.array_equal(getattr(got[0], name), getattr(want[0], name)), name
