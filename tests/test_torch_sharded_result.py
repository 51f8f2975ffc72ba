"""The sharded and multi-process results of the port, kept on the card until
one copy-out, against the JAX package on the CPU.

Each rank's kept rows stay on its device with their histogram (one bincount
there); the list is gathered where the collectives lie and leaves the card
once, the histogram is the ranks' summed by one all-reduce; the sharded
streams hold their per-batch partials on the device and merge them there,
draining to the host only on the budget or on torch.cuda.OutOfMemoryError.
The scenarios run on 2 and 4 gloo ranks (spawned processes that import
neither JAX nor hysortk_tpu), all jobs of one world size in one spawn,
against hysortk_tpu.parallel.pipeline on a mesh of as many virtual CPU
devices, with exact equality: the same key rows in the same order, the same
counts and dtypes, the same histogram on every rank, and that histogram
equal to host_histogram of the returned list. Each rank also records its
host crossings (testing.copy_counters) and what its stream's store held and
drained (scheduler.partials)."""

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
from hysortk_tpu_torch.pipeline import host_histogram

SPAWN_TIMEOUT = 400  # seconds for all jobs of one world size on the CPU
POLY_A = 4 * (4000 - 31 + 1)  # the poly-A 31-mer's count in "skewed"


def _reads(kind: str):
    rng = np.random.default_rng(37)
    if kind == "random":
        reads = oracle.random_reads(rng, 40, 35, 90)
        return reads + reads[:20] + reads[:6]
    if kind == "very_long":  # K=95: six key words
        return oracle.random_reads(rng, 16, 100, 200) * 2
    if kind == "one_read":  # fewer reads than ranks
        return ["ACGTACGTACGTACGTACGTACGTACGTACGTACGTTTGACCA"]
    if kind == "skewed":  # poly-A dominates batch 0
        return ["A" * 4000] * 4 + oracle.random_reads(rng, 10, 40, 80)
    if kind == "poly_a":  # one poly-A bucket dominates
        return oracle.random_reads(rng, 30, 40, 100) * 2 + ["A" * 300] * 6
    if kind == "late_skew":  # poly-A only in a later batch
        return oracle.random_reads(rng, 60, 40, 80) + ["A" * 4000] * 2
    raise ValueError(kind)


BASE = dict(k=31, m=17, lower=2, upper=50, pad_multiple=256)
WIDE = dict(BASE, lower=1, upper=2**15)
K95 = dict(BASE, k=95, m=17, lower=1, upper=100)
AT_U = dict(BASE, lower=1, upper=3)  # "random" has counts of exactly 3: uint8
SM_WIDE = dict(WIDE, routing="supermer")
EXT = dict(BASE, extension=True)
ONE_SHOT = "count_reads_sharded"
STREAM = "count_reads_sharded_streaming"
FLAT = "count_flat_sharded"
SEXT = "count_reads_sharded_ext"
B600 = dict(batch_bases=600)

# (name, world size, reads, config fields, job kind, job options)
SCENARIOS = [
    ("range", 2, "random", BASE, ONE_SHOT, {}),
    ("range_at_u", 2, "random", AT_U, ONE_SHOT, {}),
    ("range_poly_a_at_u", 2, "skewed", dict(BASE, lower=1, upper=POLY_A), ONE_SHOT, {}),
    ("range_unfiltered", 2, "skewed", dict(BASE, unfiltered=True), ONE_SHOT, {}),
    ("range_k95", 2, "very_long", K95, ONE_SHOT, {}),
    ("minimizer_wide", 2, "skewed", dict(WIDE, routing="minimizer"), ONE_SHOT, {}),
    ("flat_kmer_hash", 2, "random", dict(BASE, routing="kmer_hash"), FLAT, {}),
    ("stream", 2, "random", BASE, STREAM, B600),
    ("stream_k95", 2, "very_long", K95, STREAM, dict(batch_bases=2500)),
    ("supermer_heavy", 2, "poly_a", SM_WIDE, ONE_SHOT, {}),
    ("supermer_stream_late_skew", 2, "late_skew", SM_WIDE, STREAM,
     dict(batch_bases=1500)),
    ("ext", 2, "random", EXT, SEXT, dict(read_id_offset=3)),
    ("supermer_ext", 2, "random", dict(EXT, routing="supermer"), SEXT, {}),
    # The streams' drains, each on one rank while the other holds: the
    # budget at batch 0, the budget at batch 1 (batch 0 held, then drained),
    # an out-of-memory error in the device merge; and the supermer stream's
    # heavy run joining the host merge after a drain at batch 1.
    ("drain_batch0", 2, "random", BASE, STREAM,
     dict(B600, headroom_seq=[1], fault_ranks=[0])),
    ("drain_middle", 2, "random", BASE, STREAM,
     dict(B600, headroom_seq=[None, 1], fault_ranks=[1])),
    ("drain_oom", 2, "random", BASE, STREAM, dict(B600, merge_oom=True, fault_ranks=[0])),
    ("drain_supermer_heavy", 2, "late_skew", SM_WIDE, STREAM,
     dict(batch_bases=1500, headroom_seq=[None, 1], fault_ranks=[0])),
    ("range", 4, "random", BASE, ONE_SHOT, {}),
    ("range_one_read", 4, "one_read", dict(BASE, lower=1, upper=10), ONE_SHOT, {}),
    ("range_wide_skewed", 4, "skewed", WIDE, ONE_SHOT, {}),
    ("range_k95", 4, "very_long", K95, ONE_SHOT, {}),
    ("stream_one_read", 4, "one_read", dict(BASE, lower=1, upper=10), STREAM,
     dict(batch_bases=20)),
    ("stream_wide_skewed", 4, "skewed", WIDE, STREAM, dict(batch_bases=5000)),
    ("supermer_heavy", 4, "poly_a", SM_WIDE, ONE_SHOT, {}),
    ("supermer_one_read", 4, "one_read", dict(BASE, routing="supermer", lower=1,
                                              upper=10), ONE_SHOT, {}),
    ("supermer_stream_late_skew", 4, "late_skew", SM_WIDE, STREAM,
     dict(batch_bases=1500)),
    ("drain_oom", 4, "random", BASE, STREAM, dict(B600, merge_oom=True, fault_ranks=[1, 2])),
]
IDS = [f"{name}-{ws}ranks" for name, ws, *_ in SCENARIOS]
HEAVY = {"supermer_heavy", "supermer_stream_late_skew", "drain_supermer_heavy"}

# The multi-process entries on the same spawns, each rank reading its own
# records of a FASTA file: (name, world size, reads, fields, entry, options).
MULTIHOST = [
    ("mh_range", 2, "random", BASE, "count_fasta_multihost", {}),
    ("mh_stream", 2, "random", BASE, "count_fasta_multihost_streaming",
     dict(batch_bases=700)),
    ("mh_stream_drain", 2, "random", BASE, "count_fasta_multihost_streaming",
     dict(batch_bases=700, merge_oom=True, fault_ranks=[1])),
    ("mh_supermer_heavy", 2, "poly_a", SM_WIDE, "count_fasta_multihost_supermer", {}),
    ("mh_ext", 2, "random", EXT, "count_fasta_multihost_ext", {}),
    ("mh_range", 4, "one_read", dict(BASE, lower=1, upper=10), "count_fasta_multihost",
     {}),
    ("mh_supermer_stream", 4, "late_skew", SM_WIDE,
     "count_fasta_multihost_supermer_streaming", dict(batch_bases=1500)),
]
MH_IDS = [f"{name}-{ws}ranks" for name, ws, *_ in MULTIHOST]


def _write_fasta(path: str, reads: list[str]) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j: j + 60] + "\n")


def _jobs(ws: int, d, device: str = "cpu", scenarios=None, multihost=None) -> list[dict]:
    jobs = []
    for name, w, reads_kind, fields, kind, opts in (
            SCENARIOS if scenarios is None else scenarios):
        if w != ws:
            continue
        codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
        inputs = str(d / f"{name}.in.npz")
        if kind == FLAT:
            flat, valid = sharded.distribute_reads(codes, lengths, KmerConfig(**fields), ws)
            np.savez(inputs, codes=flat, valid=valid)
        else:
            np.savez(inputs, codes=codes, lengths=lengths)
        jobs.append(dict(name=name, kind=kind, inputs=inputs, cfg=fields, device=device,
                         **opts))
    for name, w, reads_kind, fields, kind, opts in (
            MULTIHOST if multihost is None else multihost):
        if w != ws:
            continue
        fasta = str(d / f"{name}.fa")
        _write_fasta(fasta, _reads(reads_kind))
        jobs.append(dict(name=name, kind=kind, fasta=fasta, cfg=fields, device=device,
                         **opts))
    return jobs


def _spawn(ws: int, d, device: str = "cpu", **which) -> dict:
    jobs = _jobs(ws, d, device, **which)
    spawn_ranks(testing.run_rank_jobs, ws, (jobs, str(d)), workdir=str(d),
                device=device, timeout=SPAWN_TIMEOUT)
    return {(job["name"], ws): [dict(np.load(os.path.join(d, f"{job['name']}.{r}.npz")))
                                for r in range(ws)] for job in jobs}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every scenario through the port: one spawn per world size."""
    root = tmp_path_factory.mktemp("sharded_result")
    out = {}
    for ws in sorted({s[1] for s in SCENARIOS + MULTIHOST}):
        d = root / f"ranks{ws}"
        d.mkdir()
        out.update(_spawn(ws, d))
    return out


def _jax_result(ws, reads_kind, fields, kind, opts):
    codes, lengths = jfasta.reads_to_codes(_reads(reads_kind))
    cfg = JKmerConfig(**fields)
    mesh = make_mesh(jax.devices()[:ws])
    if kind == FLAT:
        flat, valid = jsharded.distribute_reads(codes, lengths, cfg, ws)
        return jsharded.count_flat_sharded(flat, valid, cfg, mesh)
    if kind == STREAM:
        return jsharded.count_reads_sharded_streaming(codes, lengths, cfg,
                                                      opts["batch_bases"], mesh)
    if kind == SEXT:
        return jsharded.count_reads_sharded_ext(
            codes, lengths, cfg, mesh, read_id_offset=opts.get("read_id_offset", 0))
    return jsharded.count_reads_sharded(codes, lengths, cfg, mesh)


def _as_ext(got, k):
    return hysortk_tpu_torch.KmerListExt.from_flat(got["keys"], got["counts"], k,
                                                   got["occ_rid"], got["occ_pos"])


def _calls(got) -> dict:
    return dict(zip(testing.COUNTED, got["calls"].tolist()))


def _n_batches(reads_kind: str, batch_bases: int) -> int:
    return len(jsharded.batch_spans(jfasta.reads_to_codes(_reads(reads_kind))[1],
                                    batch_bases))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_sharded_result_matches_jax(port_results, scenario):
    """Keys, counts, order, dtypes and histogram equal to the JAX mesh's on
    every rank; the histogram equal to host_histogram of the returned list
    (the heavy entries counted once); the list's rows copied out once per
    rank and nothing uploaded again (no drain), or the drained partials
    copied out and merged on the host on the faulting ranks only."""
    name, ws, reads_kind, fields, kind, opts = scenario
    want, want_hist = _jax_result(ws, reads_kind, fields, kind, opts)
    ranks = port_results[(name, ws)]
    ext = fields.get("extension", False)
    for got in ranks:
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert got["keys"].shape == (len(want.keys), -(-fields["k"] // 16))
        assert np.array_equal(got["keys"], want.keys)
        assert np.array_equal(got["counts"], want.counts)
        assert np.array_equal(got["hist"], want_hist)
        assert np.array_equal(got["hist"], host_histogram(got["counts"], fields["upper"]))
        if ext:
            assert _as_ext(got, fields["k"]).as_dict() == want.as_dict()
    if name.endswith("at_u"):  # the edge is in the data
        assert want.counts.max() == fields["upper"]
    if name == "range_unfiltered":  # counts past U, left out of the histogram
        assert want.counts.max() > fields["upper"]
        assert want_hist.sum() < len(want.counts)

    stream = kind == STREAM
    faulty = set(opts.get("fault_ranks", range(ws))) if (
        "headroom_seq" in opts or opts.get("merge_oom")) else set()
    w_rows = -(-fields["k"] // 16) + 1
    heavy_runs = []
    for r, got in enumerate(ranks):
        calls, crossings = _calls(got), {
            n: got[f"crossings_{n}"].tolist() for n in testing.CROSSINGS}
        held, held_bytes, drained = got["partials"].tolist()
        # A step that pre-counts a heavy bucket copies out the distinct
        # heavy keys (where the rank holds any) and their all-gather.
        heavy_crossings = 2 * calls["heavy_precount_device"]
        heavy = calls["heavy_precount_device"] > 0
        assert heavy or name not in HEAVY

        def copied_out(n, crossings=crossings, extra=heavy_crossings):
            assert n <= len(crossings["to_host"]) <= n + extra

        if ext:  # the gathered partial's one copy-out; the histogram on the card
            copied_out(1)
            assert crossings["to_device"] == [] and crossings["host_histogram"] == []
            continue
        if not stream:  # the list once; nothing uploaded after the step
            copied_out(1)
            assert crossings["to_device"] == []
            # The summed heavy entries' histogram is added once, on the host,
            # where any is kept.
            assert len(crossings["host_histogram"]) <= heavy
            continue
        assert crossings["host_histogram"] == []
        n_batches = _n_batches(reads_kind, opts["batch_bases"])
        if r in faulty:
            assert (held, held_bytes, drained) == (0, 0, n_batches)
            assert (calls["merge_key_partials_device"], calls["merge_key_partials"]) \
                == (0, 1)
            # Each drained partial and then the list cross once; the host
            # merge uploads its W + 1 rows once (a heavy run among them).
            copied_out(n_batches + 1)
            assert len(crossings["to_device"]) == w_rows
        else:
            assert (held, drained) == (n_batches, 0) and held_bytes > 0
            assert (calls["merge_key_partials_device"], calls["merge_key_partials"]) \
                == (1, 0)
            copied_out(1)
            # Only the rank's heavy run (where it owns heavy entries) crosses
            # to the card, once.
            assert len(crossings["to_device"]) in ((0, w_rows) if heavy else (0,))
            heavy_runs.append(len(crossings["to_device"]) == w_rows)
    if stream and name in HEAVY and not faulty:
        assert any(heavy_runs)


@pytest.mark.parametrize("scenario", MULTIHOST, ids=MH_IDS)
def test_multihost_result(port_results, scenario):
    """A multi-process entry's shares: each rank's own rows in one copy-out
    and the histogram the ranks' summed (heavy entries added once), the
    same on every rank and equal to host_histogram of the ranks' lists
    together; the union of the shares equal to the JAX mesh's list of the
    same reads."""
    name, ws, reads_kind, fields, kind, opts = scenario
    ranks = port_results[(name, ws)]
    ext = fields.get("extension", False)
    counts = np.concatenate([got["counts"] for got in ranks])
    for got in ranks:
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert np.array_equal(got["hist"], ranks[0]["hist"])
        assert np.array_equal(got["hist"], host_histogram(counts, fields["upper"]))
    jfields = dict(fields, routing="range")
    want, want_hist = _jax_result(ws, reads_kind, jfields, SEXT if ext else ONE_SHOT, {})
    assert np.array_equal(ranks[0]["hist"], want_hist)
    if ext:
        got = {}
        for r in ranks:
            got.update(_as_ext(r, fields["k"]).as_dict())
        assert got == want.as_dict()
    else:
        got = {}
        for r in ranks:
            got.update(hysortk_tpu_torch.KmerList(r["keys"], r["counts"],
                                                  fields["k"]).as_dict())
        assert got == hysortk_tpu_torch.KmerList(want.keys, want.counts,
                                                 fields["k"]).as_dict()
    faulty = set(opts.get("fault_ranks", [])) if opts.get("merge_oom") else set()
    for r, got in enumerate(ranks):
        crossings = {n: got[f"crossings_{n}"].tolist() for n in testing.CROSSINGS}
        held, _, drained = got["partials"].tolist()
        if kind.endswith("streaming"):
            assert (drained > 0) == (r in faulty) and (held > 0) != (r in faulty)
        elif "supermer" not in kind:  # the rank's own rows, once
            assert len(crossings["to_host"]) == 1 and crossings["to_device"] == []
        if "supermer" not in kind:
            assert crossings["host_histogram"] == []


@pytest.mark.cuda
def test_nccl_one_rank_equals_the_cpu(tmp_path):
    """On a card: one rank over NCCL (the gather on the card, one copy-out,
    the histogram's all-reduce there) equal to one rank on the CPU, keys,
    counts and histogram, for the one-shot, streamed, supermer and forced
    drain scenarios; the list crosses once, nothing is uploaded again."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    picked = [(n, 1, *rest) for n, ws, *rest in SCENARIOS if ws == 2 and n in (
        "range", "range_at_u", "range_k95", "stream", "supermer_heavy",
        "supermer_stream_late_skew", "drain_oom", "ext")]
    picked = [s[:5] + (dict(s[5], fault_ranks=[0]) if "fault_ranks" in s[5] else s[5],)
              for s in picked]
    out = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        d.mkdir()
        out[device] = _spawn(1, d, device, scenarios=picked, multihost=[])
    for name, *_ in picked:
        got, want = out["cuda"][(name, 1)][0], out["cpu"][(name, 1)][0]
        for key in ("keys", "counts", "hist", "crossings_to_host", "crossings_to_device"):
            assert np.array_equal(got[key], want[key]), (name, key)
