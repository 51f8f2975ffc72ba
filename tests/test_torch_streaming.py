"""The port's bounded-memory streaming
(hysortk_tpu_torch.runtime.scheduler.count_reads_streaming) against the JAX
package's scheduler and against one-shot counting: keys, counts and
histogram exactly equal. Per-batch partials of the JAX package are carried
into the port's merges through testing.partials_from_numpy. Integer work:
no tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hysortk_tpu
from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.runtime import scheduler as jsched
from hysortk_tpu_torch import config, pipeline, testing
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch.runtime import scheduler

KS = [15, 31, 55]


def _reads(seed, n=30, lo=35, hi=120, repeat=15):
    rng = np.random.default_rng(seed)
    reads = oracle.random_reads(rng, n, lo, hi, "ACGTNacgt")
    return reads + reads[:repeat]


def _cfgs(k, **kw):
    fields = dict(k=k, m=min(17, k - 1), lower=2, upper=50, pad_multiple=256)
    fields.update(kw)
    j = hysortk_tpu.KmerConfig(**fields)
    return config.from_jax_fields(dataclasses.asdict(j)), j


def _assert_same(got, want):
    (gl, gh), (wl, wh) = got, want
    assert gl.keys.dtype == np.uint32 and gl.counts.dtype == np.int32
    assert np.array_equal(gl.keys, wl.keys)
    assert np.array_equal(gl.counts, wl.counts)
    assert np.array_equal(gh, wh)


@pytest.fixture
def group(monkeypatch):
    """Force the device-resident group size of both packages (the CPU
    reports no memory headroom, so both would refuse)."""
    def force(g):
        monkeypatch.setattr(scheduler, "_consolidation_group_size",
                            lambda *a, **k: g)
        monkeypatch.setattr(jsched, "_consolidation_group_size",
                            lambda *a, **k: g)
    return force


@pytest.mark.parametrize("k", KS)
def test_streaming_matches_jax_and_one_shot(k):
    codes, lengths = fasta_io.reads_to_codes(_reads(k))
    cfg, jcfg = _cfgs(k)
    got = scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")
    assert len(scheduler.read_batch_spans(lengths, 496)) > 4 and len(got[0]) > 0
    _assert_same(got, jsched.count_reads_streaming(codes, lengths, jcfg, 700))
    _assert_same(got, pipeline.count_reads(codes, lengths, cfg, device="cpu"))


@pytest.mark.parametrize("g", [8, 2])
@pytest.mark.parametrize("k", KS)
def test_device_resident_matches_jax_and_one_shot(k, g, group, monkeypatch):
    """device_compact with the group forced to 8 (one final device merge)
    and to 2 (a consolidation cycle every second batch)."""
    group(g)
    cycles = []
    consolidate = scheduler._consolidate_device_runs
    monkeypatch.setattr(
        scheduler, "_consolidate_device_runs",
        lambda *a: cycles.append(1) or consolidate(*a),
    )
    rng = np.random.default_rng(k + g)
    reads = oracle.random_reads(rng, 12, 35, 120) * 5  # duplicates ACROSS batches
    rng.shuffle(reads)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(k, device_compact=True)
    got = scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")
    assert (len(cycles) >= 2) if g == 2 else (len(cycles) <= 1)
    _assert_same(got, jsched.count_reads_streaming(codes, lengths, jcfg, 700))
    one_shot = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    _assert_same(got, one_shot)
    assert int(one_shot[0].counts.max()) >= 5


def test_consolidation_no_shrink_drains(group, monkeypatch):
    """All-distinct input: consolidation cannot shrink below `group`, so
    the scheduler drains the summed runs to the host and still matches."""
    group(2)
    merged_on_host = []
    merge = scheduler.merge_partial_lists
    monkeypatch.setattr(
        scheduler, "merge_partial_lists",
        lambda *a, **k: merged_on_host.append(1) or merge(*a, **k),
    )
    rng = np.random.default_rng(83)
    reads = oracle.random_reads(rng, 30, 40, 90)  # k-mers ~all distinct
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(31, lower=1, device_compact=True)
    got = scheduler.count_reads_streaming(codes, lengths, cfg, 600, device="cpu")
    assert merged_on_host
    _assert_same(got, jsched.count_reads_streaming(codes, lengths, jcfg, 600))
    _assert_same(got, pipeline.count_reads(codes, lengths, cfg, device="cpu"))


def test_consolidated_runs_are_sorted_padded_and_unfiltered():
    """_consolidate_device_runs: ceil(union/run_len) sorted sentinel-padded
    runs, duplicate keys summed, no [L, U] filter."""
    rng = np.random.default_rng(5)
    cfg, _ = _cfgs(31, lower=3, upper=4)
    run_len = 64
    pool = np.unique(rng.integers(0, 2**32, (90, 2), dtype=np.uint64)
                     .astype(np.uint32), axis=0)
    parts, acc = [], {}
    for m in (64, 40, 0):
        keys = pool[np.sort(rng.choice(pool.shape[0], m, replace=False))]
        cnts = rng.integers(1, 100, m)
        for row, c in zip(keys, cnts):
            key = tuple(row.tolist())
            acc[key] = acc.get(key, 0) + int(c)
        parts.append(testing.partials_from_numpy(keys, cnts, run_len))
    new_w, new_c, new_n = scheduler._consolidate_device_runs(
        [p[0] for p in parts], [p[1] for p in parts], cfg, run_len
    )
    assert len(new_w) == -(-len(acc) // run_len) == 2 and sum(new_n) == len(acc)
    got = {}
    for ws, c, nk in zip(new_w, new_c, new_n):
        assert all(w.shape == (run_len,) for w in ws) and c.shape == (run_len,)
        keys, cnts = testing.partials_to_numpy(ws, c)
        assert np.all(keys[nk:] == 0xFFFFFFFF) and np.all(cnts[nk:] == 0)
        got.update({tuple(r): x for r, x in zip(keys[:nk].tolist(), cnts[:nk].tolist())})
    assert got == acc
    flat = np.concatenate([testing.partials_to_numpy(ws, c)[0]
                           for ws, c in zip(new_w, new_c)])[: len(acc)]
    assert [tuple(r) for r in flat.tolist()] == sorted(acc)


def _jax_partials(codes, lengths, jcfg, batch_bases):
    """The JAX package's per-batch unfiltered partial lists, made as its
    scheduler makes them (host keys (M, W) uint32, counts uint32)."""
    batch_bases = jsched.snap_batch_to_pow2_flat(batch_bases, jcfg.pad_multiple)
    pad = jcfg.pad_multiple
    keys_out, cnts_out = [], []
    for b_codes, b_lengths in jsched.iter_read_batches(codes, lengths, batch_bases):
        n = -(-(max(b_codes.size, batch_bases) + 16) // pad) * pad
        buf = np.zeros(n, dtype=np.int8)
        buf[: b_codes.size] = b_codes
        keys, cnt, keep = jpipeline._count_device_packed(
            jnp.asarray(jsupermer.pack_codes_2bit(buf)),
            jnp.asarray(b_lengths.astype(np.int32)),
            jcfg.k, n, 1, 2**31 - 1, jcfg.sort_backend,
        )
        keep_np = np.asarray(keep)
        keys_out.append(jpipeline.compact_keys(keys, keep_np))
        cnts_out.append(np.asarray(cnt)[keep_np].astype(np.uint32))
    return keys_out, cnts_out


@pytest.mark.parametrize("k", KS)
def test_jax_partials_through_port_merges(k):
    """State carried across: the JAX package's per-batch partials go through
    the port's merge_partial_lists (single shot and chunked under a tiny
    budget) and _merge_runs_sum, and give the JAX package's merged result."""
    codes, lengths = fasta_io.reads_to_codes(_reads(k + 1, n=40))
    cfg, jcfg = _cfgs(k, lower=1, upper=65535)
    parts_k, parts_c = _jax_partials(codes, lengths, jcfg, 700)
    assert len(parts_k) > 4
    want_k, want_c = jsched.merge_partial_lists(parts_k, parts_c, jcfg, 1 << 30)
    for budget in (1 << 30, 256):
        got_k, got_c = scheduler.merge_partial_lists(
            parts_k, parts_c, cfg, budget, device="cpu"
        )
        assert got_k.dtype == np.uint32 and got_c.dtype == np.int32
        assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
    small_k, small_c = jsched.merge_partial_lists(parts_k, parts_c, jcfg, 256)
    assert np.array_equal(small_k, want_k) and np.array_equal(small_c, want_c)

    run_len = 512
    dev = [testing.partials_from_numpy(pk, pc, run_len)
           for pk, pc in zip(parts_k[:3], parts_c[:3])]
    words_s, total, keep = scheduler._merge_runs_sum(
        [d[0] for d in dev], [d[1] for d in dev], 1, 2**31 - 1,
        words=cfg.words, run_len=run_len, pad_runs=1,
    )
    assert words_s[0].shape == (4 * run_len,)
    jw, jt, jk = jsched._merge_runs_sum(
        tuple(tuple(jnp.asarray(w.numpy().view(np.uint32)) for w in d[0]) for d in dev),
        tuple(jnp.asarray(d[1].numpy()) for d in dev),
        jnp.int32(1), jnp.int32(2**31 - 1),
        words=jcfg.words, run_len=run_len, pad_runs=1,
    )
    for w, j in zip(words_s, jw):
        assert np.array_equal(w.numpy().view(np.uint32), np.asarray(j))
    assert np.array_equal(total.numpy(), np.asarray(jt))
    assert np.array_equal(keep.numpy(), np.asarray(jk))


def test_read_longer_than_batch_and_spans_match_jax(group):
    rng = np.random.default_rng(9)
    reads = oracle.random_reads(rng, 20, 40, 100)
    reads.insert(7, "".join(rng.choice(list("ACGT"), size=1500)))
    reads += reads[:8]
    codes, lengths = fasta_io.reads_to_codes(reads)
    for bases in (496, 700, 5000, 10**6):
        assert scheduler.read_batch_spans(lengths, bases) == \
            jsched.read_batch_spans(lengths, bases)
        assert scheduler.snap_batch_to_pow2_flat(bases, 256) == \
            jsched.snap_batch_to_pow2_flat(bases, 256)
    batches = list(scheduler.iter_read_batches(codes, lengths, 496))
    jbatches = list(jsched.iter_read_batches(codes, lengths, 496))
    assert len(batches) == len(jbatches)
    for (c, l), (jc, jl) in zip(batches, jbatches):
        assert np.array_equal(c, jc) and np.array_equal(l, jl)
    cfg, jcfg = _cfgs(31)
    want = jsched.count_reads_streaming(codes, lengths, jcfg, 700)
    _assert_same(
        scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu"),
        want,
    )
    # The oversized batch breaks the uniform run length: the device-resident
    # path drains to the host and finishes there.
    group(8)
    cfg_dc, _ = _cfgs(31, device_compact=True)
    _assert_same(
        scheduler.count_reads_streaming(codes, lengths, cfg_dc, 700, device="cpu"),
        want,
    )


def test_empty_input():
    codes, lengths = fasta_io.reads_to_codes([])
    cfg, _ = _cfgs(31)
    kl, hist = scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")
    assert len(kl) == 0 and kl.keys.shape == (0, 2) and hist.shape == (51,)
    assert hist.sum() == 0


def test_out_of_memory_drains_and_other_errors_rise(group, monkeypatch):
    """Only torch.cuda.OutOfMemoryError is recovered from (the held runs go
    to the host and the merge finishes there); a RuntimeError, as a failed
    kernel build or launch raises, ends the run."""
    group(8)
    codes, lengths = fasta_io.reads_to_codes(_reads(4))
    cfg, _ = _cfgs(31, device_compact=True)
    want = pipeline.count_reads(codes, lengths, cfg, device="cpu")

    def fail_with(exc):
        def merge(*a, **k):
            raise exc
        return merge

    monkeypatch.setattr(scheduler, "_merge_device_resident",
                        fail_with(torch.cuda.OutOfMemoryError("out of memory")))
    _assert_same(
        scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu"),
        want,
    )
    group(2)
    monkeypatch.setattr(scheduler, "_consolidate_device_runs",
                        fail_with(torch.cuda.OutOfMemoryError("out of memory")))
    _assert_same(
        scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu"),
        want,
    )
    monkeypatch.setattr(scheduler, "_consolidate_device_runs",
                        fail_with(RuntimeError("merge pass launch: CUDA error")))
    with pytest.raises(RuntimeError, match="merge pass launch"):
        scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")


def test_streaming_ext_not_ported():
    """It is ported: the streamed extension result has the streamed plain
    result's keys and counts, with every occurrence beside them."""
    codes, lengths = fasta_io.reads_to_codes(_reads(5))
    cfg, _ = _cfgs(31)
    ext_cfg = dataclasses.replace(cfg, extension=True)
    ext, hist = scheduler.count_reads_streaming_ext(
        codes, lengths, ext_cfg, 700, read_id_offset=4, device="cpu")
    plain, phist = scheduler.count_reads_streaming(
        codes, lengths, cfg, 700, device="cpu")
    assert np.array_equal(ext.keys, plain.keys) and len(ext) > 0
    assert np.array_equal(ext.counts, plain.counts) and np.array_equal(hist, phist)
    assert [r.size for r in ext.rid] == ext.counts.tolist()
    assert min(int(r.min()) for r in ext.rid) >= 4


def test_group_size_rule(monkeypatch):
    """group = headroom // (4.5 x run bytes), a power of two capped at 8, 0
    below 2 and on the CPU; the environment variable overrides."""
    from hysortk_tpu_torch.runtime import memcheck

    per_run = (1 << 20) * 3 * 4
    for headroom, want in ((None, 0), (int(4.5 * per_run), 0),
                           (int(4.5 * per_run) * 2, 2),
                           (int(4.5 * per_run) * 7, 4),
                           (int(4.5 * per_run) * 100, 8)):
        monkeypatch.setattr(memcheck, "hbm_headroom_bytes",
                            lambda device, h=headroom: h)
        assert scheduler._consolidation_group_size(1 << 20, 2, "cpu") == want
    monkeypatch.setenv("HYSORTK_DEVICE_RESIDENT_GROUP", "4")
    assert scheduler._consolidation_group_size(1 << 20, 2, "cpu") == 4


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
def test_streaming_on_cuda_matches_cpu(compact, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hysortk_tpu_torch import _build

    monkeypatch.setenv("HYSORTK_DEVICE_RESIDENT_GROUP", "2")
    codes, lengths = fasta_io.reads_to_codes(_reads(2, n=60))
    cfg, _ = _cfgs(31, device_compact=compact, upper=300)
    before = dict(_build.launches)
    got = scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cuda")
    assert _build.launches["merge_runs"] > before["merge_runs"]
    assert _build.launches["run_length_sum"] > before["run_length_sum"]
    _assert_same(got, pipeline.count_reads(codes, lengths, cfg, device="cpu"))
