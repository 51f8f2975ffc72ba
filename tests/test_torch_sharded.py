"""The port's sharded range exchange, end to end, against the JAX package on
the CPU: hysortk_tpu_torch.parallel.pipeline.count_reads_sharded on 2 and 4
gloo ranks (spawned processes that import neither JAX nor hysortk_tpu and
return their results through tmp_path) equals
hysortk_tpu.parallel.pipeline.count_reads_sharded on a mesh of as many
virtual CPU devices: the same key rows in the same order (rank order, then
mixed-key order), the same counts, the same histogram, on every rank.

All jobs of one world size run in one spawn (a spawn costs a few seconds
of torch imports); each scenario is a test case of its own."""

import os

import jax
import numpy as np
import pytest
import torch

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

SPAWN_TIMEOUT = 240  # seconds for all jobs of one world size on the CPU


def _reads(kind: str):
    rng = np.random.default_rng(11)
    if kind == "random":
        reads = oracle.random_reads(rng, 40, 35, 90)
        return reads + reads[:20] + reads[:6]
    if kind == "long":  # K=55 needs longer reads
        reads = oracle.random_reads(rng, 30, 60, 140)
        return reads * 2
    if kind == "one_read":  # fewer reads than ranks
        return ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTTTGACCA"]
    if kind == "skewed":  # one poly-A k-mer dominates one destination
        return ["A" * 4000] * 4 + oracle.random_reads(rng, 10, 40, 80)
    raise ValueError(kind)


# (name, world size, reads, config fields, job kind, forced capacity)
BASE = dict(k=31, m=17, lower=2, upper=50, pad_multiple=256)
SCENARIOS = [
    ("k31", 2, "random", BASE, "count_reads_sharded", None),
    ("k15", 2, "random", dict(BASE, k=15, m=7, lower=1, upper=100), "count_reads_sharded", None),
    ("k55", 2, "long", dict(BASE, k=55, m=13, lower=1, upper=100), "count_reads_sharded", None),
    ("one_read", 2, "one_read", dict(BASE, lower=1, upper=10), "count_reads_sharded", None),
    ("combiner", 2, "random", dict(BASE, combiner=True), "count_reads_sharded", None),
    ("skewed", 2, "skewed", dict(BASE, lower=1, upper=2**15), "count_reads_sharded", None),
    ("overflow", 2, "random", dict(BASE, classifier="plain"), "count_reads_sharded", 64),
    ("flat", 2, "random", BASE, "count_flat_sharded", None),
    ("facade", 2, "random", BASE, "kmer_count", None),
    ("k31", 4, "random", BASE, "count_reads_sharded", None),
    ("one_read", 4, "one_read", dict(BASE, lower=1, upper=10), "count_reads_sharded", None),
    ("combiner", 4, "random", dict(BASE, combiner=True), "count_reads_sharded", None),
    ("skewed", 4, "skewed", dict(BASE, lower=1, upper=2**15), "count_reads_sharded", None),
    ("overflow", 4, "random", dict(BASE, classifier="plain"), "count_reads_sharded", 64),
]
IDS = [f"{name}-{ws}ranks" for name, ws, *_ in SCENARIOS]
# routing="supermer" through both entries, in the same spawn.
SUPERMER_SCENARIOS = [
    ("supermer", 2, "random", dict(BASE, routing="supermer"), "count_reads_sharded", None),
    ("supermer_flat", 2, "random", dict(BASE, routing="supermer"), "count_flat_sharded",
     None),
]


def _jax_result(ws, reads_kind, fields, kind):
    reads = _reads(reads_kind)
    cfg = JKmerConfig(**fields)
    codes, lengths = jfasta.reads_to_codes(reads)
    mesh = make_mesh(jax.devices()[:ws])
    if kind == "count_flat_sharded":
        flat, valid = jsharded.distribute_reads(codes, lengths, cfg, ws)
        return jsharded.count_flat_sharded(flat, valid, cfg, mesh)
    return jsharded.count_reads_sharded(codes, lengths, cfg, mesh)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every scenario through the port: one spawn per world size."""
    root = tmp_path_factory.mktemp("sharded")
    out = {}
    for ws in sorted({s[1] for s in SCENARIOS}):
        d = root / f"ranks{ws}"
        d.mkdir()
        jobs = []
        for name, w, reads_kind, fields, kind, capacity in SCENARIOS + SUPERMER_SCENARIOS:
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
                             device="cpu", capacity=capacity))
        spawn_ranks(testing.run_rank_jobs, ws, (jobs, str(d)), workdir=str(d),
                    device="cpu", timeout=SPAWN_TIMEOUT)
        for job in jobs:
            out[(job["name"], ws)] = [
                dict(np.load(os.path.join(d, f"{job['name']}.{r}.npz")))
                for r in range(ws)]
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_sharded_matches_jax(port_results, scenario):
    name, ws, reads_kind, fields, kind, capacity = scenario
    want, want_hist = _jax_result(ws, reads_kind, fields, kind)
    ranks = port_results[(name, ws)]
    for got in ranks:  # every rank holds the whole list
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert np.array_equal(got["keys"], want.keys)
        assert np.array_equal(got["counts"], want.counts)
        assert np.array_equal(got["hist"], want_hist)
    assert len(want.keys) > 0
    # And the oracle: the counts are the filtered canonical counts.
    filt = oracle.oracle_filtered(_reads(reads_kind), fields["k"], fields["lower"],
                                  fields["upper"])
    got = hysortk_tpu_torch.KmerList(want.keys, want.counts, fields["k"]).as_dict()
    assert got == {km.encode(): c for km, c in filt.items()}

    passes = int(ranks[0]["passes"]), int(ranks[0]["combiner_passes"])
    if fields.get("combiner"):
        assert passes == (0, 1)
    elif name == "skewed" and ws == 4:
        # The classifier reads the first pass's totals and re-runs the step
        # through the combiner.
        assert passes == (1, 1)
    elif name == "skewed":
        # Two ranks cannot flag a destination (it would need more than 2.3x
        # the mean of two); one rank's poly-A run overflows its segment and
        # the capacity doubles instead.
        assert passes[0] > 1 and passes[1] == 0
    elif capacity:
        assert passes[0] > 1 and passes[1] == 0  # the overflow retry ran
    else:
        assert passes == (1, 0)


def test_jax_reference_takes_the_same_routes():
    """The skewed input trips the JAX classifier on a 4-device mesh, and
    not on 2: the routes the port's pass counts above must mirror."""
    from hysortk_tpu.parallel import dispatch as jdispatch

    codes, lengths = jfasta.reads_to_codes(_reads("skewed"))
    cfg = JKmerConfig(**dict(BASE, lower=1, upper=2**15))
    for ws, heavy in ((2, False), (4, True)):
        mesh = make_mesh(jax.devices()[:ws])
        packed, lens, block, _ = jsharded.distribute_reads_packed(codes, lengths, cfg, ws)
        out = jsharded._count_sharded_packed_jit(
            jax.numpy.asarray(packed), jax.numpy.asarray(lens.reshape(-1)),
            cfg=cfg, num_shards=ws, capacity=4 * block, block_len=block, mesh=mesh)
        types = jdispatch.classify(np.asarray(out[6]), cfg.heavy_ratio)
        assert bool((types == jdispatch.HEAVY).any()) == heavy


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 7])
def test_distribute_reads_match_jax(num_shards):
    """The partition, the flat blocks and the wire blocks of every shard."""
    reads = _reads("random") + ["ACGT" * 3] + [""] + _reads("one_read")
    codes, lengths = jfasta.reads_to_codes(reads)
    cfg = KmerConfig(**BASE)
    jcfg = JKmerConfig(**BASE)
    assert sharded.partition_read_indices(lengths, num_shards) == \
        jsharded.partition_read_indices(lengths, num_shards)
    for got, want in zip(sharded.distribute_reads(codes, lengths, cfg, num_shards),
                         jsharded.distribute_reads(codes, lengths, jcfg, num_shards)):
        assert np.array_equal(got, want)
    got = sharded.distribute_reads_packed(codes, lengths, cfg, num_shards, 5, 4096, 3)
    want = jsharded.distribute_reads_packed(codes, lengths, jcfg, num_shards, 5, 4096, 3)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", range(4))
def test_partition_matches_jax_on_ragged_lengths(seed):
    """The vectorized partition against the JAX package's loop: zero-length
    reads, equal lengths (ties at the target), int32 and int64 lengths,
    more shards than reads."""
    rng = np.random.default_rng(seed)
    for trial in range(40):
        lengths = rng.integers(0, 200, int(rng.integers(0, 50)))
        if trial % 3 == 0:
            lengths[rng.random(lengths.size) < 0.4] = 0
        if trial % 5 == 0:
            lengths[:] = int(rng.integers(0, 5))
        lengths = lengths.astype(np.int32 if trial % 2 else np.int64)
        for num_shards in (1, 2, 3, 4, 7, 8):
            assert sharded.partition_read_indices(lengths, num_shards) == \
                jsharded.partition_read_indices(lengths, num_shards)


def test_unported_routes_raise(port_results):
    """routing="supermer" is ported: count_reads_sharded ships supermers
    (the supermer step runs, no other step body) and count_flat_sharded
    takes the kmer_hash destination on its flat blocks, as the JAX function
    does under this routing; both equal the JAX package on the same mesh
    size."""
    for name, ws, reads_kind, fields, kind, _ in SUPERMER_SCENARIOS:
        want, want_hist = _jax_result(ws, reads_kind, fields, kind)
        for got in port_results[(name, ws)]:
            assert np.array_equal(got["keys"], want.keys), name
            assert np.array_equal(got["counts"], want.counts), name
            assert np.array_equal(got["hist"], want_hist), name
            calls = dict(zip(testing.COUNTED, got["calls"].tolist()))
            flat = kind == "count_flat_sharded"
            assert calls["_supermer_step"] == (0 if flat else 1), name
            assert calls["_shard_body_bucketed"] == (1 if flat else 0), name
        assert len(want.keys) > 0


def test_facade_inside_a_group_routes_to_the_sharded_path(monkeypatch):
    """kmer_count inside a group of more than one rank counts sharded:
    extension mode by count_reads_sharded_ext, a share over the headroom by
    count_reads_sharded_streaming in batches of suggest_batch_bases x the
    rank count, else count_reads_sharded."""
    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch.runtime import memcheck
    from hysortk_tpu_torch.runtime import scheduler

    calls = []
    monkeypatch.setattr(ht._dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ht._dist, "get_world_size", lambda group=None: 2)
    for entry in ("count_reads_sharded", "count_reads_sharded_ext",
                  "count_reads_sharded_streaming"):
        monkeypatch.setattr(sharded, entry,
                            lambda *a, _e=entry, **k: calls.append((_e, a, k)) or _e)
    codes, lengths = jfasta.reads_to_codes(_reads("random"))
    assert ht.kmer_count(codes, lengths, KmerConfig(**BASE), device="cpu") == \
        "count_reads_sharded"
    assert calls[-1][2]["device"] == torch.device("cpu")
    ext = KmerConfig(**dict(BASE, extension=True))
    assert ht.kmer_count(codes, lengths, ext, device="cpu") == "count_reads_sharded_ext"
    monkeypatch.setattr(memcheck, "hbm_headroom_bytes", lambda dev, safety=0.9: 1)
    assert ht.kmer_count(codes, lengths, KmerConfig(**BASE), device="cpu") == \
        "count_reads_sharded_streaming"
    batch = scheduler.suggest_batch_bases(KmerConfig(**BASE), torch.device("cpu"))
    assert calls[-1][1][3] == 2 * batch
    # Extension mode does not stream by itself, as in the JAX facade.
    assert ht.kmer_count(codes, lengths, ext, device="cpu") == "count_reads_sharded_ext"
    with pytest.raises(NotImplementedError):
        ht.kmer_count(codes, lengths, KmerConfig(**BASE), device=["cpu", "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards", [1, 2])
def test_sharded_on_cuda_matches_jax(tmp_path, num_shards):
    """On a card: one rank with NCCL, or two ranks sharing the card over
    gloo with host staging; the result equals the JAX mesh's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = str(tmp_path / "in.npz")
    codes, lengths = jfasta.reads_to_codes(_reads("random"))
    np.savez(inputs, codes=codes, lengths=lengths)
    job = dict(name="k31", kind="count_reads_sharded", inputs=inputs, cfg=BASE,
               device="cuda")
    spawn_ranks(testing.run_rank_jobs, num_shards, ([job], str(tmp_path)),
                workdir=str(tmp_path), device="cuda", timeout=SPAWN_TIMEOUT)
    want, want_hist = _jax_result(num_shards, "random", BASE, "count_reads_sharded")
    for r in range(num_shards):
        got = np.load(tmp_path / f"k31.{r}.npz")
        assert np.array_equal(got["keys"], want.keys)
        assert np.array_equal(got["counts"], want.counts)
        assert np.array_equal(got["hist"], want_hist)
