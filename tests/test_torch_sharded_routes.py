"""The rest of the port's sharded pipeline against the JAX package on the
CPU: sharded streaming, extension mode one-shot and streamed, the minimizer
routing (balanced and round-robin dispatchers, with and without the
combiner) and the kmer_hash routing, on 2 and 4 gloo ranks (spawned
processes that import neither JAX nor hysortk_tpu) against
hysortk_tpu.parallel.pipeline on a mesh of as many virtual CPU devices.

The tolerance is exact equality: the same key rows in the same order (rank
order, then the rank's key order), the same counts, the same histogram, on
every rank; extension mode the same occurrences (as_dict(), since the JAX
sort is unstable). All jobs of one world size run in one spawn; each
scenario is a test case of its own."""

import os

import jax
import numpy as np
import pytest

import hysortk_tpu_torch
from hysortk_tpu import KmerConfig as JKmerConfig
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.parallel import pipeline as jsharded
from hysortk_tpu.parallel.mesh import make_mesh
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.config import KmerConfig
from hysortk_tpu_torch.parallel import pipeline as sharded
from hysortk_tpu_torch.parallel.spawn import spawn_ranks

SPAWN_TIMEOUT = 400  # seconds for all jobs of one world size on the CPU


def _reads(kind: str):
    rng = np.random.default_rng(23)
    if kind == "random":
        reads = oracle.random_reads(rng, 40, 35, 90)
        return reads + reads[:20] + reads[:6]
    if kind == "long":  # K=55 needs longer reads
        return oracle.random_reads(rng, 30, 60, 140) * 2
    if kind == "very_long":  # K=95: six key words
        return oracle.random_reads(rng, 16, 100, 200) * 2
    if kind == "one_read":  # fewer reads than ranks
        return ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTTTGACCA"]
    if kind == "skewed":  # poly-A dominates batch 0
        return ["A" * 4000] * 4 + oracle.random_reads(rng, 10, 40, 80)
    if kind == "late_skew":  # poly-A only in a later batch
        return oracle.random_reads(rng, 60, 40, 80) + ["A" * 4000] * 2
    raise ValueError(kind)


BASE = dict(k=31, m=17, lower=2, upper=50, pad_multiple=256)
K15 = dict(BASE, k=15, m=7, lower=1, upper=100)
K55 = dict(BASE, k=55, m=13, lower=1, upper=100)
K95 = dict(BASE, k=95, m=17, lower=1, upper=100)
WIDE = dict(BASE, lower=1, upper=2**15)
EXT = dict(BASE, extension=True)
MINI = dict(BASE, routing="minimizer")
RR = dict(MINI, dispatcher="round_robin")
HASH = dict(BASE, routing="kmer_hash")
STREAM = "count_reads_sharded_streaming"
ONE_SHOT = "count_reads_sharded"
SEXT = "count_reads_sharded_ext"
SEXT_STREAM = "count_reads_sharded_ext_streaming"

# (name, world size, reads, config fields, job kind, job options)
SCENARIOS = [
    # Sharded streaming: several batches, the routes, K, the classifier.
    ("stream", 2, "random", BASE, STREAM, dict(batch_bases=600)),
    ("stream_depth1", 2, "random", BASE, STREAM, dict(batch_bases=600, async_depth=1)),
    ("stream_k15", 2, "random", K15, STREAM, dict(batch_bases=600)),
    ("stream_k55", 2, "long", K55, STREAM, dict(batch_bases=1500)),
    ("stream_minimizer", 2, "random", MINI, STREAM, dict(batch_bases=600)),
    ("stream_kmer_hash", 2, "random", HASH, STREAM, dict(batch_bases=600)),
    ("stream_overflow", 2, "random", dict(BASE, classifier="plain"), STREAM,
     dict(batch_bases=600, capacity=64)),
    ("stream", 4, "random", BASE, STREAM, dict(batch_bases=600)),
    ("stream_skewed", 4, "skewed", WIDE, STREAM, dict(batch_bases=5000)),
    ("stream_late_skew", 4, "late_skew", WIDE, STREAM, dict(batch_bases=1500)),
    ("stream_one_read", 4, "one_read", dict(BASE, lower=1, upper=10), STREAM,
     dict(batch_bases=20)),
    ("stream_minimizer_combiner", 4, "random", dict(MINI, combiner=True), STREAM,
     dict(batch_bases=600)),
    # Extension mode, one-shot and streamed, range and kmer_hash.
    ("ext", 2, "random", EXT, SEXT, dict(read_id_offset=5)),
    ("ext_k15", 2, "random", dict(K15, extension=True), SEXT, {}),
    ("ext_k55", 2, "long", dict(K55, extension=True), SEXT, {}),
    ("ext_kmer_hash", 2, "random", dict(EXT, routing="kmer_hash"), SEXT, {}),
    ("ext_kmer_hash_k95", 2, "very_long", dict(K95, extension=True,
                                                routing="kmer_hash"), SEXT, {}),
    ("ext_minimizer", 2, "random", dict(EXT, routing="minimizer"), SEXT, {}),
    ("ext_stream", 2, "random", EXT, SEXT_STREAM,
     dict(batch_bases=600, read_id_offset=7)),
    ("ext_stream_kmer_hash", 2, "random", dict(EXT, routing="kmer_hash"), SEXT_STREAM,
     dict(batch_bases=600)),
    ("ext_stream_k55", 2, "long", dict(K55, extension=True), SEXT_STREAM,
     dict(batch_bases=1500, read_id_offset=3)),
    ("ext_stream_k15", 2, "random", dict(K15, extension=True), SEXT_STREAM,
     dict(batch_bases=600)),
    ("ext_stream_supermer", 2, "random", dict(EXT, routing="supermer"), SEXT_STREAM,
     dict(batch_bases=600, read_id_offset=2)),
    # A device budget of one byte: every partial drains to the host merge.
    ("ext_stream_drain", 2, "random", EXT, SEXT_STREAM,
     dict(batch_bases=600, headroom=1)),
    ("ext", 4, "random", EXT, SEXT, {}),
    ("ext_one_read", 4, "one_read", dict(EXT, lower=1, upper=10), SEXT, {}),
    ("ext_kmer_hash", 4, "random", dict(EXT, routing="kmer_hash"), SEXT, {}),
    ("ext_stream", 4, "random", EXT, SEXT_STREAM, dict(batch_bases=900)),
    # The bucketed extension routes over the wire: the host flatteners raise.
    ("ext_minimizer_wire", 2, "random", dict(EXT, routing="minimizer"), SEXT,
     dict(read_id_offset=2, refuse_host_flatten=True)),
    ("ext_kmer_hash_wire", 2, "random", dict(EXT, routing="kmer_hash"), SEXT,
     dict(refuse_host_flatten=True)),
    ("ext_stream_minimizer_wire", 2, "random", dict(EXT, routing="minimizer"),
     SEXT_STREAM, dict(batch_bases=600, read_id_offset=1, refuse_host_flatten=True)),
    ("ext_kmer_hash_wire", 4, "random", dict(EXT, routing="kmer_hash"), SEXT,
     dict(read_id_offset=6, refuse_host_flatten=True)),
    ("ext_minimizer_wire", 4, "one_read", dict(EXT, routing="minimizer", lower=1,
                                              upper=10), SEXT,
     dict(refuse_host_flatten=True)),
    # The bucketed routes, one-shot.
    ("minimizer", 2, "random", MINI, ONE_SHOT, {}),
    ("minimizer_combiner", 2, "random", dict(MINI, combiner=True), ONE_SHOT, {}),
    ("round_robin", 2, "random", RR, ONE_SHOT, {}),
    ("round_robin_combiner", 2, "random", dict(RR, combiner=True), ONE_SHOT, {}),
    ("minimizer_k15", 2, "random", dict(K15, routing="minimizer"), ONE_SHOT, {}),
    ("minimizer_k55", 2, "long", dict(K55, routing="minimizer"), ONE_SHOT, {}),
    ("minimizer_combiner_k95", 2, "very_long", dict(K95, routing="minimizer",
                                                   combiner=True), ONE_SHOT, {}),
    ("kmer_hash", 2, "random", HASH, ONE_SHOT, {}),
    ("kmer_hash_combiner", 2, "random", dict(HASH, combiner=True), ONE_SHOT, {}),
    ("kmer_hash_k15", 2, "random", dict(K15, routing="kmer_hash"), ONE_SHOT, {}),
    ("kmer_hash_k55", 2, "long", dict(K55, routing="kmer_hash"), ONE_SHOT, {}),
    ("kmer_hash_overflow", 2, "random", dict(HASH, capacity_factor=0.05), ONE_SHOT, {}),
    ("flat_minimizer", 2, "random", MINI, "count_flat_sharded", {}),
    ("flat_kmer_hash", 2, "random", HASH, "count_flat_sharded", {}),
    ("minimizer", 4, "random", MINI, ONE_SHOT, {}),
    ("minimizer_skewed", 4, "skewed", dict(MINI, lower=1, upper=2**15), ONE_SHOT, {}),
    ("minimizer_combiner", 4, "random", dict(MINI, combiner=True), ONE_SHOT, {}),
    ("round_robin", 4, "random", RR, ONE_SHOT, {}),
    ("round_robin_combiner", 4, "random", dict(RR, combiner=True), ONE_SHOT, {}),
    ("round_robin_overflow", 4, "random", dict(RR, capacity_factor=0.05), ONE_SHOT, {}),
    ("kmer_hash", 4, "random", HASH, ONE_SHOT, {}),
    ("kmer_hash_one_read", 4, "one_read", dict(HASH, lower=1, upper=10), ONE_SHOT, {}),
    # The facade inside a group: extension mode, and a share over the
    # device's headroom (patched to one byte).
    ("facade_ext", 2, "random", EXT, "kmer_count", {}),
    ("facade_stream", 2, "random", BASE, "kmer_count", dict(headroom=1)),
]
IDS = [f"{name}-{ws}ranks" for name, ws, *_ in SCENARIOS]
# routing="supermer" through the three sharded entries (the route itself is
# tested in test_torch_supermer.py); run in the same spawns.
SUPERMER_SCENARIOS = [
    ("supermer", 2, "random", dict(BASE, routing="supermer"), ONE_SHOT, {}),
    ("supermer_ext", 2, "random", dict(EXT, routing="supermer"), SEXT,
     dict(read_id_offset=4)),
    ("supermer_stream", 2, "random", dict(BASE, routing="supermer"), STREAM,
     dict(batch_bases=600)),
]


def _jax_result(ws, reads_kind, fields, kind, opts):
    codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
    cfg = JKmerConfig(**fields)
    mesh = make_mesh(jax.devices()[:ws])
    offset = opts.get("read_id_offset", 0)
    if kind == "count_flat_sharded":
        flat, valid = jsharded.distribute_reads(codes, lengths, cfg, ws)
        return jsharded.count_flat_sharded(flat, valid, cfg, mesh)
    if kind == STREAM or (kind == "kmer_count" and opts.get("headroom")):
        batch = opts.get("batch_bases", 1 << 26)
        return jsharded.count_reads_sharded_streaming(codes, lengths, cfg, batch, mesh)
    if kind == SEXT or (kind == "kmer_count" and cfg.extension):
        return jsharded.count_reads_sharded_ext(codes, lengths, cfg, mesh,
                                                read_id_offset=offset)
    if kind == SEXT_STREAM:
        return jsharded.count_reads_sharded_ext_streaming(
            codes, lengths, cfg, opts["batch_bases"], mesh, read_id_offset=offset)
    return jsharded.count_reads_sharded(codes, lengths, cfg, mesh)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every scenario through the port: one spawn per world size."""
    root = tmp_path_factory.mktemp("sharded_routes")
    out = {}
    for ws in sorted({s[1] for s in SCENARIOS}):
        d = root / f"ranks{ws}"
        d.mkdir()
        jobs = []
        for name, w, reads_kind, fields, kind, opts in SCENARIOS + SUPERMER_SCENARIOS:
            if w != ws:
                continue
            codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
            inputs = str(d / f"{name}.in.npz")
            if kind == "count_flat_sharded":
                flat, valid = sharded.distribute_reads(
                    codes, lengths, KmerConfig(**fields), ws)
                np.savez(inputs, codes=flat, valid=valid)
            else:
                np.savez(inputs, codes=codes, lengths=lengths)
            jobs.append(dict(name=name, kind=kind, inputs=inputs, cfg=fields,
                             device="cpu", **opts))
        spawn_ranks(testing.run_rank_jobs, ws, (jobs, str(d)), workdir=str(d),
                    device="cpu", timeout=SPAWN_TIMEOUT)
        for job in jobs:
            out[(job["name"], ws)] = [
                dict(np.load(os.path.join(d, f"{job['name']}.{r}.npz")))
                for r in range(ws)]
    return out


def _as_ext(got, k):
    """A rank's saved extension-mode arrays as a KmerListExt."""
    ends = np.cumsum(got["counts"].astype(np.int64))
    starts = ends - got["counts"]
    return hysortk_tpu_torch.KmerListExt(
        keys=got["keys"], counts=got["counts"], k=k,
        pos=[got["occ_pos"][s:e] for s, e in zip(starts, ends)],
        rid=[got["occ_rid"][s:e] for s, e in zip(starts, ends)],
    )


def _calls(got) -> dict:
    return dict(zip(testing.COUNTED, got["calls"].tolist()))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_sharded_route_matches_jax(port_results, scenario):
    name, ws, reads_kind, fields, kind, opts = scenario
    want, want_hist = _jax_result(ws, reads_kind, fields, kind, opts)
    ranks = port_results[(name, ws)]
    extension = fields.get("extension", False)
    for got in ranks:  # every rank holds the whole list
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert np.array_equal(got["keys"], want.keys)
        assert np.array_equal(got["counts"], want.counts)
        assert np.array_equal(got["hist"], want_hist)
        if extension:
            assert _as_ext(got, fields["k"]).as_dict() == want.as_dict()
    assert len(want.keys) > 0
    filt = oracle.oracle_filtered(_reads(reads_kind), fields["k"], fields["lower"],
                                  fields["upper"])
    got = hysortk_tpu_torch.KmerList(want.keys, want.counts, fields["k"]).as_dict()
    assert got == {km.encode(): c for km, c in filt.items()}

    calls = _calls(ranks[0])
    bodies = {b: calls[b] for b in ("_shard_body_range", "_shard_body_range_combiner",
                                    "_shard_body_bucketed", "_shard_body_ext_range",
                                    "_shard_body_ext_bucketed")}
    ran = {b for b, n in bodies.items() if n}
    if fields.get("routing") == "supermer":
        assert ran == set() and calls["_supermer_step"] >= 1
    elif extension:
        assert ran == {"_shard_body_ext_range" if fields.get("routing", "range") == "range"
                       else "_shard_body_ext_bucketed"}
    elif fields.get("routing", "range") != "range":
        assert ran == {"_shard_body_bucketed"}
    if kind == "kmer_count":  # the facade's choice
        assert calls[SEXT if extension else STREAM] == 1
        assert calls[ONE_SHOT] == 0
    if kind == SEXT_STREAM:  # one merge, on the device unless it drained
        drained = bool(opts.get("headroom"))
        assert calls["merge_ext_partials_device"] == (not drained)
        assert calls["merge_ext_partials"] == drained
    if name.endswith("overflow"):  # the capacity doubled and the pass re-ran
        assert sum(bodies.values()) > 1 + (kind == STREAM)
    if name in ("minimizer", "minimizer_combiner", "minimizer_skewed", "ext",
                "kmer_hash", "round_robin"):
        assert sum(bodies.values()) == 1  # measured or ample: one pass
    if name == "stream_skewed":
        # Batch 0's totals trip the classifier: every later batch runs the
        # combiner, batch 0 once each way.
        assert bodies["_shard_body_range"] == 1
        assert bodies["_shard_body_range_combiner"] >= 2
    if name == "stream_late_skew":
        # Batch 0 is balanced, so no combiner; the poly-A batch overflows
        # and doubles the capacity instead.
        assert bodies["_shard_body_range_combiner"] == 0
        n_batches = len(jsharded.batch_spans(jfasta.reads_to_codes(
            _reads(reads_kind))[1], opts["batch_bases"]))
        assert bodies["_shard_body_range"] > n_batches


def test_jax_reference_takes_the_same_stream_routes():
    """The skewed stream's batch 0 trips the JAX classifier on 4 devices;
    the late skew's batch 0 does not: the routes the pass counts above
    mirror."""
    from hysortk_tpu.parallel import dispatch as jdispatch

    cfg = JKmerConfig(**WIDE)
    mesh = make_mesh(jax.devices()[:4])
    for kind, batch, heavy in (("skewed", 5000, True), ("late_skew", 1500, False)):
        codes, lengths = jfasta.reads_to_codes(_reads(kind))
        s, e = jsharded.batch_spans(lengths, batch)[0]
        b_codes = codes[: int(lengths[:e].sum())]
        flat, valid = jsharded.distribute_reads(b_codes, lengths[s:e], cfg, 4)
        out = jsharded._count_sharded_jit(
            jax.numpy.asarray(flat, jax.numpy.int8), jax.numpy.asarray(valid),
            jax.numpy.zeros(1, jax.numpy.int32), cfg=cfg, num_shards=4,
            capacity=flat.size, mesh=mesh)
        types = jdispatch.classify(np.asarray(out[6]), cfg.heavy_ratio)
        assert bool((types == jdispatch.HEAVY).any()) == heavy


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 9])
def test_ext_blocks_and_stream_dims_match_jax(num_shards, offset):
    """build_ext_blocks (the flat extension blocks of the bucketed routes)
    and ext_stream_dims (the stream's pinned wire dims) against the JAX
    package's."""
    reads = _reads("random") + ["ACGT" * 3] + [""] + _reads("one_read")
    codes, lengths = jfasta.reads_to_codes(reads)
    cfg, jcfg = KmerConfig(**EXT), JKmerConfig(**EXT)
    got = sharded.build_ext_blocks(codes, lengths, cfg, num_shards, offset, 4096)
    want = jsharded.build_ext_blocks(codes, lengths, jcfg, num_shards, offset, 4096)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    for batch in (50, 600, 1 << 20):
        assert sharded.ext_stream_dims(lengths, batch, cfg, num_shards) == \
            jsharded.ext_stream_dims(lengths, batch, jcfg, num_shards)
        assert sharded.batch_spans(lengths, batch) == jsharded.batch_spans(lengths, batch)


def test_run_with_capacity_retry():
    """A measured capacity gets one attempt; otherwise it doubles, for up to
    four attempts, as in the JAX package."""
    seen = []

    def run(cap):
        seen.append(cap)
        return ("out", cap < 400)

    assert sharded.run_with_capacity_retry(run, 100, False) == (("out",), 400)
    assert seen == [100, 200, 400]
    for measured, attempts in ((True, 1), (False, 4)):
        seen.clear()
        with pytest.raises(RuntimeError, match=f"after {attempts} attempts"):
            sharded.run_with_capacity_retry(run, 1, measured)
        assert len(seen) == attempts


def test_supermer_routing_still_raises(port_results):
    """routing="supermer" runs through count_reads_sharded,
    count_reads_sharded_ext and count_reads_sharded_streaming (the supermer
    step, no other step body) and equals the JAX package; extension mode
    through count_reads_sharded_streaming still raises, with or without
    it, as in the JAX package."""
    for name, ws, reads_kind, fields, kind, opts in SUPERMER_SCENARIOS:
        want, want_hist = _jax_result(ws, reads_kind, fields, kind, opts)
        for got in port_results[(name, ws)]:
            assert np.array_equal(got["keys"], want.keys), name
            assert np.array_equal(got["counts"], want.counts), name
            assert np.array_equal(got["hist"], want_hist), name
            if fields.get("extension"):
                assert _as_ext(got, fields["k"]).as_dict() == want.as_dict(), name
            calls = _calls(got)
            assert calls["_supermer_step"] >= 1, name
            assert not any(n for b, n in calls.items() if b.startswith("_shard_body"))
        assert len(want.keys) > 0
    codes, lengths = jfasta.reads_to_codes(_reads("random"))
    for fields in (EXT, dict(EXT, routing="supermer")):
        with pytest.raises(ValueError, match="count_reads_sharded_ext_streaming"):
            sharded.count_reads_sharded_streaming(
                codes, lengths, KmerConfig(**fields), device="cpu")


CUDA_SCENARIOS = [s for s in SCENARIOS if s[1] == 2 and s[0] in (
    "stream", "ext", "ext_stream", "minimizer", "round_robin_combiner", "kmer_hash",
    "ext_kmer_hash")]


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_routes_on_cuda_match_jax(tmp_path, num_shards):
    """On the cards: the new paths with device="cuda", one rank a card under
    NCCL where there are enough cards, else ranks sharing a card over gloo;
    each result equal to the JAX mesh's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = []
    for name, _, reads_kind, fields, kind, opts in CUDA_SCENARIOS:
        codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
        inputs = str(tmp_path / f"{name}.in.npz")
        np.savez(inputs, codes=codes, lengths=lengths)
        jobs.append(dict(name=name, kind=kind, inputs=inputs, cfg=fields,
                         device="cuda", **opts))
    spawn_ranks(testing.run_rank_jobs, num_shards, (jobs, str(tmp_path)),
                workdir=str(tmp_path), device="cuda", timeout=SPAWN_TIMEOUT)
    for name, _, reads_kind, fields, kind, opts in CUDA_SCENARIOS:
        want, want_hist = _jax_result(num_shards, reads_kind, fields, kind, opts)
        for r in range(num_shards):
            got = dict(np.load(tmp_path / f"{name}.{r}.npz"))
            assert np.array_equal(got["keys"], want.keys), name
            assert np.array_equal(got["counts"], want.counts), name
            assert np.array_equal(got["hist"], want_hist), name
            if fields.get("extension"):
                assert _as_ext(got, fields["k"]).as_dict() == want.as_dict(), name
