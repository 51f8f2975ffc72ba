"""The port's supermer routing against the JAX package on the CPU.

Pure functions (io/supermer, io/native, ops/wire.fill_run_meta,
parallel/supermer_route) against their JAX twins on the numpy route and,
where the JAX package's native library loads, the native route (the port's
own host library against it); then the route end
to end on 2 and 4 gloo ranks (spawned processes that import neither JAX nor
hysortk_tpu) against hysortk_tpu.parallel on a mesh of as many virtual CPU
devices: count_reads_sharded, count_reads_sharded_streaming,
count_reads_sharded_ext[_streaming], count_flat_sharded, the facade inside a
group and the supermer entries, at K = 15, 31, 55 and 95, with the
heavy-bucket pre-count on and off.

The tolerance is exact equality: the same key rows in the same order (rank
order, then the rank's key order, the heavy entries last), the same counts,
the same histogram, on every rank; extension mode the same occurrences
(as_dict(), since the JAX sort is unstable). All jobs of one world size run
in one spawn; each scenario is a test case of its own."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hysortk_tpu_torch
from hysortk_tpu import KmerConfig as JKmerConfig
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.io import native as jnative
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.ops import wire as jwire
from hysortk_tpu.parallel import dispatch as jdispatch
from hysortk_tpu.parallel import pipeline as jsharded
from hysortk_tpu.parallel import supermer_route as jroute
from hysortk_tpu.parallel.mesh import make_mesh
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.config import KmerConfig
from hysortk_tpu_torch.io import fasta, native, supermer
from hysortk_tpu_torch.ops import wire
from hysortk_tpu_torch.parallel import pipeline as sharded
from hysortk_tpu_torch.parallel import supermer_route as route
from hysortk_tpu_torch.parallel.spawn import spawn_ranks

SPAWN_TIMEOUT = 400  # seconds for all jobs of one world size on the CPU
ROUTES = ["native", "numpy"]


@pytest.fixture(params=ROUTES)
def host_route(request, monkeypatch):
    """Both packages' encoders on one route: native (the port's host library
    and the JAX package's; skipped where the JAX package's does not load) or
    numpy (the port's plain versions and the JAX package's fallback)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    elif not jnative.available():
        pytest.skip("the JAX package's native host library does not load here")
    return request.param


def _case(kind: str, k: int, num_dest: int = 4, seed: int = 5):
    """One encoder case: (reads, codes, lengths, flat codes, flat valid,
    destinations)."""
    reads = testing.supermer_reads(kind, k, seed)
    codes, lengths = fasta.reads_to_codes(reads)
    flat, valid = fasta.flatten_for_device(codes, lengths, k, 256)
    dest = testing.supermer_case_dest(kind, flat.size, num_dest, seed)
    return reads, codes, lengths, flat, valid, dest


ENCODER_CASES = [(kind, k) for kind in testing.SUPERMER_KINDS for k in (15, 31)]
ENCODER_IDS = [f"{kind}-k{k}" for kind, k in ENCODER_CASES]


@pytest.mark.parametrize("kind,k", ENCODER_CASES, ids=ENCODER_IDS)
def test_encoder_matches_jax(host_route, kind, k):
    """run_boundaries, encode_supermer_streams and the extension-mode
    streams, bit-equal to the JAX functions on the same route; every run
    of the cap case within MAX_SUPERMER_LEN; the destination with no runs
    an empty stream."""
    _, _, lengths, flat, valid, dest = _case(kind, k)
    got = supermer.run_boundaries(valid, dest, k)
    want = jsupermer.run_boundaries(valid, dest, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (got[1] <= supermer.MAX_SUPERMER_LEN).all()
    if kind == "cap" and k == 15:
        assert (got[1] == supermer.MAX_SUPERMER_LEN).sum() > 10
    streams = supermer.encode_supermer_streams(flat, valid, dest, k, 4)
    for g, w in zip(streams, jsupermer.encode_supermer_streams(flat, valid, dest, k, 4)):
        assert g[0].dtype == w[0].dtype and g[1].dtype == w[1].dtype
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    if kind == "empty_dest":
        assert streams[1][0].size == 0 and streams[1][1].size == 0
    ext = supermer.encode_supermer_streams_ext(flat, valid, dest, k, 4, lengths, 7)
    for g, w in zip(ext, jsupermer.encode_supermer_streams_ext(
            flat, valid, dest, k, 4, lengths, 7)):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert route.wire_nbytes(ext) == jroute.wire_nbytes(ext)
    assert route.wire_nbytes(streams) == jroute.wire_nbytes(streams)


def test_native_and_numpy_routes_agree(monkeypatch):
    """The port's host library's run decomposition and run gather equal the
    numpy plain versions'."""
    for kind in testing.SUPERMER_KINDS:
        _, _, _, flat, valid, dest = _case(kind, 15)
        nat = supermer.encode_supermer_streams(flat, valid, dest, 15, 4)
        with monkeypatch.context() as m:
            m.setattr(native, "available", lambda: False)
            ref = supermer.encode_supermer_streams(flat, valid, dest, 15, 4)
        for g, w in zip(nat, ref):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.mark.parametrize("kind", testing.SUPERMER_KINDS)
def test_encode_decode_round_trip(host_route, kind):
    """encode_supermers -> decode_supermers keeps every k-mer (the oracle's
    multiset), the payload bytes equal the JAX package's, and
    supermer_stats agrees."""
    k = 31
    reads, _, _, flat, valid, dest = _case(kind, k)
    got = supermer.encode_supermers(flat, valid, dest, k, 4)
    want = jsupermer.encode_supermers(flat, valid, dest, k, 4)
    counts = {}
    for g, w in zip(got, want):
        assert np.array_equal(g.lengths, w.lengths) and np.array_equal(g.payload, w.payload)
        codes, ok = supermer.decode_supermers(g, k)
        jcodes, jok = jsupermer.decode_supermers(w, k)
        assert np.array_equal(codes, jcodes) and np.array_equal(ok, jok)
        text = "".join("ACGT"[c] for c in codes)
        for i in np.flatnonzero(ok):
            km = testing.canonical(text[i: i + k])
            counts[km] = counts.get(km, 0) + 1
    assert counts == dict(oracle.oracle_counts(reads, k))
    assert supermer.supermer_stats(got, k, 2) == jsupermer.supermer_stats(want, k, 2)


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
def test_split_stream_matches_jax(parts):
    _, _, lengths, flat, valid, dest = _case("random", 31)
    for c, ln, r0, p0 in supermer.encode_supermer_streams_ext(
            flat, valid, dest, 31, 4, lengths, 3):
        got = route.split_stream(c, ln, parts, r0, p0)
        want = jroute.split_stream(c, ln, parts, r0, p0)
        assert len(got) == len(want) == parts
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b)
        assert np.array_equal(np.concatenate([g[0] for g in got]), c)


@pytest.mark.parametrize("case", testing.fill_meta_cases(), ids=lambda c: c[0])
def test_fill_run_meta_matches_jax(case):
    """Per-position (rid, pos) from per-run headers: zero-length pad runs,
    wrapping int32 differences, pos0 with the top bit set."""
    _, lengths, rid0, pos0, n = case
    rid, pos = wire.fill_run_meta(torch.from_numpy(lengths), torch.from_numpy(rid0),
                                  torch.from_numpy(pos0.view(np.int32)), n)
    jrid, jpos = jwire.fill_run_meta(jnp.asarray(lengths), jnp.asarray(rid0),
                                     jnp.asarray(pos0), n)
    assert rid.dtype == torch.int32 and pos.dtype == torch.int32
    assert np.array_equal(rid.numpy(), np.asarray(jrid))
    assert np.array_equal(pos.numpy().view(np.uint32), np.asarray(jpos))


@pytest.mark.parametrize("k,m", [(15, 7), (31, 17), (95, 17)])
def test_host_destinations_matches_jax(k, m):
    reads = testing.supermer_reads("shorter_than_k", k, 2)
    codes, lengths = fasta.reads_to_codes(reads)
    flat, valid = fasta.flatten_for_device(codes, lengths, k, 256)
    got = route.host_destinations(flat, k, m, 12, device="cpu")
    want = jroute.host_destinations(flat, k, m, 12)
    assert got.dtype == np.int32
    assert np.array_equal(got[valid], want[valid])


def test_heavy_precount_matches_jax():
    """host_canonical_words; the heavy buckets' entries per owner rank
    (keys in unsigned order, the dominant key with its top bit set), the
    valid mask without them, and their sum over ranks; `_sum_entry_lists`
    on repeated keys."""
    k, num_shards = 31, 2
    _, _, _, flat, valid, _ = _case("heavy_top_bit", k)
    dest = route.host_destinations(flat, k, 17, 6, device="cpu")
    sizes = np.bincount(dest[valid], minlength=6).astype(np.int64)
    types = jdispatch.classify(sizes, 2.3)
    assert (types == jdispatch.HEAVY).any()
    assign = jdispatch.balanced_assignment(np.where(types == 1, 0, sizes), num_shards)
    words = route.host_canonical_words(flat, k, device="cpu")
    for g, w in zip(words, jroute.host_canonical_words(flat, k)):
        assert g.dtype == np.uint32 and np.array_equal(g[valid], np.asarray(w)[valid])
    got_valid, got = route.heavy_precount(flat, valid, dest, types, assign, k,
                                          num_shards, device="cpu")
    want_valid, want = jroute.heavy_precount(flat, valid, dest, types, assign, k,
                                             num_shards)
    assert np.array_equal(got_valid, want_valid)
    for (gk, gc), (wk, wc) in zip(got, want):
        assert gk.dtype == np.uint32 and np.array_equal(gk, wk)
        assert np.array_equal(gc, wc)
    summed = route._sum_entry_lists(got)
    assert (summed[0][:, 0] >= 2**31).any() and summed[1].max() >= 1500
    for g, w in zip(summed, jroute._sum_entry_lists(want)):
        assert np.array_equal(g, w)
    twice = got + got  # every key repeated: the counts double
    for g, w in zip(route._sum_entry_lists(twice), jroute._sum_entry_lists(twice)):
        assert np.array_equal(g, w)
    empty = [(np.zeros((0, 2), np.uint32), np.zeros(0, np.int64))] * 2
    for g, w in zip(route._sum_entry_lists(empty), jroute._sum_entry_lists(empty)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_entries_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    codes, lengths = fasta.reads_to_codes(_reads("random"))
    cfg = KmerConfig(**SUPERMER)
    for entry in (route.count_reads_supermer, route.count_reads_supermer_exchange):
        with pytest.raises(RuntimeError, match="cuda"):
            entry(codes, lengths, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        route.count_reads_supermer_ext(codes, lengths, KmerConfig(**EXT))
    with pytest.raises(RuntimeError, match="cuda"):
        route.count_reads_supermer_streaming(codes, lengths, cfg, 600)
    with pytest.raises(RuntimeError, match="cuda"):
        route.host_destinations(np.zeros(64, np.int8), 31, 17, 6)
    with pytest.raises(ValueError, match="routing='supermer'"):
        route.count_reads_supermer(codes, lengths, KmerConfig(**BASE), device="cpu")


def test_facade_exports_the_supermer_entries():
    for name in ("count_reads_supermer", "count_reads_supermer_ext",
                 "count_reads_supermer_exchange"):
        assert name in hysortk_tpu_torch.__all__
        assert getattr(hysortk_tpu_torch, name) is getattr(route, name)


# --------------------------------------------------------------------------
# The route end to end on spawned gloo ranks.


def _reads(kind: str):
    rng = np.random.default_rng(29)
    if kind == "random":
        reads = oracle.random_reads(rng, 40, 35, 90)
        return reads + reads[:20] + reads[:6]
    if kind == "long":  # K=55 needs longer reads
        return oracle.random_reads(rng, 30, 60, 140) * 2
    if kind == "very_long":  # K=95: six key words
        return oracle.random_reads(rng, 16, 100, 200) * 2
    if kind == "k15_cap":  # runs past the 250-base cap at K=15
        return oracle.random_reads(rng, 8, 400, 900) * 2
    if kind == "one_read":  # fewer reads than ranks
        return ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTTTGACCA"]
    if kind == "poly_a":  # one poly-A bucket dominates
        return oracle.random_reads(rng, 30, 40, 100) * 2 + ["A" * 300] * 6
    if kind == "top_bit":  # the heavy key has its top bit set
        return testing.supermer_reads("heavy_top_bit", 31, 8)
    if kind == "late_skew":  # poly-A only in a later batch
        return oracle.random_reads(rng, 60, 40, 80) + ["A" * 4000] * 2
    raise ValueError(kind)


BASE = dict(k=31, m=17, lower=2, upper=50, pad_multiple=256)
SUPERMER = dict(BASE, routing="supermer")
RR = dict(SUPERMER, dispatcher="round_robin")
WIDE = dict(SUPERMER, lower=1, upper=2**15)
K15 = dict(SUPERMER, k=15, m=7, lower=1, upper=100)
K55 = dict(SUPERMER, k=55, m=13, lower=1, upper=100)
K95 = dict(SUPERMER, k=95, m=17, lower=1, upper=100)
EXT = dict(SUPERMER, extension=True)
ONE_SHOT = "count_reads_sharded"
STREAM = "count_reads_sharded_streaming"
SEXT = "count_reads_sharded_ext"
SEXT_STREAM = "count_reads_sharded_ext_streaming"

# (name, world size, reads, config fields, job kind, job options)
SCENARIOS = [
    ("balanced", 2, "random", SUPERMER, ONE_SHOT, {}),
    ("round_robin", 2, "random", RR, ONE_SHOT, {}),
    ("k15", 2, "random", K15, ONE_SHOT, {}),
    ("k15_cap", 2, "k15_cap", K15, ONE_SHOT, {}),
    ("k55", 2, "long", K55, ONE_SHOT, {}),
    ("k95", 2, "very_long", K95, ONE_SHOT, {}),
    ("heavy_kept", 2, "poly_a", WIDE, ONE_SHOT, {}),
    ("heavy_filtered", 2, "poly_a", SUPERMER, ONE_SHOT, {}),
    ("heavy_off", 2, "poly_a", dict(WIDE, classifier="plain"), ONE_SHOT, {}),
    ("heavy_top_bit", 2, "top_bit", WIDE, ONE_SHOT, {}),
    ("one_read", 2, "one_read", dict(SUPERMER, lower=1, upper=10), ONE_SHOT, {}),
    ("exchange_entry", 2, "poly_a", WIDE, "count_reads_supermer_exchange", {}),
    ("flat", 2, "random", SUPERMER, "count_flat_sharded", {}),
    ("ext", 2, "random", EXT, SEXT, dict(read_id_offset=5)),
    ("ext_k15", 2, "random", dict(K15, extension=True), SEXT, {}),
    ("ext_k95", 2, "very_long", dict(K95, extension=True), SEXT, {}),
    ("ext_entry", 2, "random", EXT, "count_reads_supermer_ext", dict(read_id_offset=3)),
    ("stream", 2, "random", SUPERMER, STREAM, dict(batch_bases=600)),
    ("stream_k55", 2, "long", K55, STREAM, dict(batch_bases=1500)),
    ("stream_late_skew", 2, "late_skew", WIDE, STREAM, dict(batch_bases=1500)),
    ("stream_entry", 2, "poly_a", WIDE, "count_reads_supermer_streaming",
     dict(batch_bases=900)),
    ("ext_stream", 2, "random", EXT, SEXT_STREAM, dict(batch_bases=600, read_id_offset=7)),
    ("facade", 2, "poly_a", WIDE, "kmer_count", {}),
    ("facade_ext", 2, "random", EXT, "kmer_count", {}),
    ("balanced", 4, "random", SUPERMER, ONE_SHOT, {}),
    ("round_robin", 4, "random", RR, ONE_SHOT, {}),
    ("k95", 4, "very_long", K95, ONE_SHOT, {}),
    ("heavy_kept", 4, "poly_a", WIDE, ONE_SHOT, {}),
    ("heavy_filtered", 4, "poly_a", SUPERMER, ONE_SHOT, {}),
    ("heavy_top_bit", 4, "top_bit", WIDE, ONE_SHOT, {}),
    ("one_read", 4, "one_read", dict(SUPERMER, lower=1, upper=10), ONE_SHOT, {}),
    ("ext", 4, "random", EXT, SEXT, dict(read_id_offset=5)),
    ("ext_one_read", 4, "one_read", dict(EXT, lower=1, upper=10), SEXT, {}),
    ("stream", 4, "random", SUPERMER, STREAM, dict(batch_bases=600)),
    ("stream_late_skew", 4, "late_skew", WIDE, STREAM, dict(batch_bases=1500)),
    ("stream_one_read", 4, "one_read", dict(SUPERMER, lower=1, upper=10), STREAM,
     dict(batch_bases=20)),
    ("ext_stream", 4, "random", EXT, SEXT_STREAM, dict(batch_bases=900)),
]
IDS = [f"{name}-{ws}ranks" for name, ws, *_ in SCENARIOS]
HEAVY = {"heavy_kept", "heavy_filtered", "heavy_top_bit", "exchange_entry",
         "stream_late_skew", "stream_entry", "facade"}


def _jax_result(ws, reads_kind, fields, kind, opts):
    codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
    cfg = JKmerConfig(**fields)
    mesh = make_mesh(jax.devices()[:ws])
    offset = opts.get("read_id_offset", 0)
    if kind == "count_flat_sharded":
        flat, valid = jsharded.distribute_reads(codes, lengths, cfg, ws)
        return jsharded.count_flat_sharded(flat, valid, cfg, mesh)
    if kind in (STREAM, "count_reads_supermer_streaming"):
        return jsharded.count_reads_sharded_streaming(
            codes, lengths, cfg, opts["batch_bases"], mesh)
    if kind == SEXT or (kind == "kmer_count" and cfg.extension):
        return jsharded.count_reads_sharded_ext(codes, lengths, cfg, mesh,
                                                read_id_offset=offset)
    if kind == "count_reads_supermer_ext":
        return jroute.count_reads_supermer_ext(codes, lengths, cfg, mesh,
                                               read_id_offset=offset)
    if kind == "count_reads_supermer_exchange":
        return jroute.count_reads_supermer_exchange(codes, lengths, cfg, mesh)
    if kind == SEXT_STREAM:
        return jsharded.count_reads_sharded_ext_streaming(
            codes, lengths, cfg, opts["batch_bases"], mesh, read_id_offset=offset)
    return jsharded.count_reads_sharded(codes, lengths, cfg, mesh)


def _jax_flags_heavy(ws, reads_kind, fields, batch_bases=None) -> bool:
    """Whether the JAX classifier flags a bucket on these reads (in some
    batch, with batch_bases): the heavy scenarios must pre-count."""
    codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
    cfg = JKmerConfig(**fields)
    nb = ws * cfg.avg_buckets_per_shard
    batches = [(codes, lengths)]
    if batch_bases:
        offs = np.concatenate([[0], np.cumsum(lengths)])
        batches = [(codes[offs[s]: offs[e]], lengths[s:e])
                   for s, e in jsharded.batch_spans(lengths, batch_bases)]
    for c, l in batches:
        flat, valid = jfasta.flatten_for_device(c, l, cfg.k, cfg.pad_multiple)
        dest = jroute.host_destinations(flat, cfg.k, cfg.m, nb)
        sizes = np.bincount(dest[valid], minlength=nb).astype(np.int64)
        if (jdispatch.classify(sizes, cfg.heavy_ratio) == jdispatch.HEAVY).any():
            return True
    return False


def _spawn_jobs(scenarios, root, device="cpu", timeout=SPAWN_TIMEOUT):
    """Every scenario through the port, one spawn per world size:
    {(name, ws): [rank outputs]}."""
    out = {}
    for ws in sorted({s[1] for s in scenarios}):
        d = root / f"ranks{ws}"
        d.mkdir()
        jobs = []
        for name, w, reads_kind, fields, kind, opts in scenarios:
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
                             device=device, **opts))
        spawn_ranks(testing.run_rank_jobs, ws, (jobs, str(d)), workdir=str(d),
                    device=device, timeout=timeout)
        for job in jobs:
            out[(job["name"], ws)] = [
                dict(np.load(os.path.join(d, f"{job['name']}.{r}.npz")))
                for r in range(ws)]
    return out


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    return _spawn_jobs(SCENARIOS, tmp_path_factory.mktemp("supermer"))


def _as_ext(got, k):
    """A rank's saved extension-mode arrays as a KmerListExt."""
    ends = np.cumsum(got["counts"].astype(np.int64))
    starts = ends - got["counts"]
    return hysortk_tpu_torch.KmerListExt(
        keys=got["keys"], counts=got["counts"], k=k,
        pos=[got["occ_pos"][s:e] for s, e in zip(starts, ends)],
        rid=[got["occ_rid"][s:e] for s, e in zip(starts, ends)],
    )


def _assert_equal(ranks, want, want_hist, fields):
    for got in ranks:  # every rank holds the whole list
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert np.array_equal(got["keys"], want.keys)
        assert np.array_equal(got["counts"], want.counts)
        assert np.array_equal(got["hist"], want_hist)
        if fields.get("extension"):
            assert _as_ext(got, fields["k"]).as_dict() == want.as_dict()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_supermer_route_matches_jax(port_results, scenario):
    name, ws, reads_kind, fields, kind, opts = scenario
    want, want_hist = _jax_result(ws, reads_kind, fields, kind, opts)
    ranks = port_results[(name, ws)]
    _assert_equal(ranks, want, want_hist, fields)
    assert len(want.keys) > 0
    filt = oracle.oracle_filtered(_reads(reads_kind), fields["k"], fields["lower"],
                                  fields["upper"])
    got = hysortk_tpu_torch.KmerList(want.keys, want.counts, fields["k"]).as_dict()
    assert got == {km.encode(): c for km, c in filt.items()}

    calls = dict(zip(testing.COUNTED, ranks[0]["calls"].tolist()))
    bodies = sum(n for b, n in calls.items() if b.startswith("_shard_body"))
    if kind == "count_flat_sharded":  # no supermer branch: kmer_hash blocks
        assert calls["_supermer_step"] == 0 and calls["_shard_body_bucketed"] == 1
        return
    assert bodies == 0 and calls["_supermer_step"] >= 1
    if kind in (ONE_SHOT, SEXT) or kind.startswith("count_reads_supermer") and \
            "stream" not in kind:
        assert calls["_supermer_step"] == 1
    # The pre-count runs exactly where the JAX classifier flags a bucket
    # (never in extension mode, nor under the plain classifier).
    heavy = (not fields.get("extension") and fields.get("classifier") != "plain"
             and _jax_flags_heavy(ws, reads_kind, fields, opts.get("batch_bases")))
    assert bool(calls["heavy_precount"]) == heavy
    if name in HEAVY:
        assert heavy
    if name == "heavy_filtered":
        assert b"A" * 31 not in got  # the entries' total passes U: dropped
    if name in ("heavy_kept", "heavy_top_bit"):
        top = int(np.argmax(want.counts))
        assert want.counts[top] >= 1500
        assert (want.keys[top, 0] >= 2**31) == (name == "heavy_top_bit")
    if kind == "kmer_count":  # the facade's choice
        assert calls[SEXT if fields.get("extension") else ONE_SHOT] == 1


def test_jax_reference_flags_late_skew_in_a_later_batch_only():
    """The late-skew stream's poly-A batch is not batch 0: the assignment
    comes from a balanced batch and the pre-count from a later one, on both
    2 and 4 ranks."""
    codes, lengths = jfasta.reads_to_codes(_reads("late_skew"))
    cfg = JKmerConfig(**WIDE)
    spans = jsharded.batch_spans(lengths, 1500)
    assert len(spans) > 2
    s, e = spans[0]
    assert not _jax_flags_heavy_on(codes[: int(lengths[:e].sum())], lengths[s:e], cfg, 2)
    assert _jax_flags_heavy(2, "late_skew", WIDE, 1500)


def _jax_flags_heavy_on(codes, lengths, cfg, ws) -> bool:
    nb = ws * cfg.avg_buckets_per_shard
    flat, valid = jfasta.flatten_for_device(codes, lengths, cfg.k, cfg.pad_multiple)
    dest = jroute.host_destinations(flat, cfg.k, cfg.m, nb)
    sizes = np.bincount(dest[valid], minlength=nb).astype(np.int64)
    return bool((jdispatch.classify(sizes, cfg.heavy_ratio) == jdispatch.HEAVY).any())


CUDA_SCENARIOS = [s for s in SCENARIOS if s[1] == 2 and s[0] in (
    "balanced", "heavy_kept", "heavy_top_bit", "k95", "ext", "stream",
    "stream_late_skew", "ext_stream")]


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards", [1, 2])
def test_supermer_route_on_cuda_matches_jax(tmp_path, num_shards):
    """On the card: one rank under NCCL, or two ranks sharing the card over
    gloo (NCCL where there are two cards); each result equal to the JAX
    mesh's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scenarios = [(name, num_shards, *rest) for name, _, *rest in CUDA_SCENARIOS]
    results = _spawn_jobs(scenarios, tmp_path, device="cuda")
    for name, ws, reads_kind, fields, kind, opts in scenarios:
        want, want_hist = _jax_result(ws, reads_kind, fields, kind, opts)
        _assert_equal(results[(name, ws)], want, want_hist, fields)
