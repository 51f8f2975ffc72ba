"""The port's multi-process runs (hysortk_tpu_torch.parallel.multihost and the
multi-process supermer entries) against the JAX package's, per process.

The JAX side runs hysortk_tpu.parallel.multihost and
hysortk_tpu.parallel.supermer_route's count_fasta_multihost* entries in N real
jax.distributed processes on the CPU, one virtual device each (each a fresh
interpreter with its own JAX_PLATFORMS and XLA_FLAGS, since tests/conftest.py
gives the test process 8 devices); the port's entries run on N spawned gloo
ranks. All scenarios of one world size share one launch of
each. Both read each scenario's seeded FASTA file, each process only its own
records.

The tolerance is exact equality per rank: the same key rows in the same
order, the same counts, the same global histogram; extension mode the same
occurrences (as_dict(), since the JAX sort is unstable). Each scenario at
N = 2 and N = 3 is a test case of its own; the union of the ranks' lists is
also held against the oracle.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import hysortk_tpu_torch
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.io import fasta
from hysortk_tpu_torch.parallel import multihost
from hysortk_tpu_torch.parallel import supermer_route as route
from hysortk_tpu_torch.parallel.spawn import spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds for all scenarios of one world size, either package
WORLD_SIZES = (2, 3)

BASE = dict(k=31, m=17, lower=2, upper=50, pad_multiple=256)
WIDE = dict(BASE, lower=1, upper=2**15)
SUPERMER = dict(WIDE, routing="supermer")
EXT = dict(BASE, extension=True)
ONE = "count_fasta_multihost"
STREAM = "count_fasta_multihost_streaming"
EXT_ONE = "count_fasta_multihost_ext"
EXT_STREAM = "count_fasta_multihost_ext_streaming"
SM_ONE = "count_fasta_multihost_supermer"
SM_STREAM = "count_fasta_multihost_supermer_streaming"

# (name, reads, config fields, entry, batch_bases)
SCENARIOS = [
    ("range", "random", BASE, ONE, None),
    # heavy_ratio 1.5: a destination can reach 2x the mean on 2 ranks only.
    ("range_heavy", "poly_a", dict(WIDE, heavy_ratio=1.5), ONE, None),
    ("minimizer", "random", dict(BASE, routing="minimizer"), ONE, None),
    ("kmer_hash", "random", dict(BASE, routing="kmer_hash"), ONE, None),
    ("stream", "random", BASE, STREAM, 700),
    ("ext", "random", EXT, EXT_ONE, None),
    ("ext_stream", "random", EXT, EXT_STREAM, 700),
    ("ext_stream_kmer_hash", "random", dict(EXT, routing="kmer_hash"), EXT_STREAM, 700),
    ("supermer_heavy", "poly_a", SUPERMER, SM_ONE, None),
    ("supermer_stream_heavy", "poly_a", SUPERMER, SM_STREAM, 900),
    ("supermer_ext_stream", "random", dict(EXT, routing="supermer"), SM_STREAM, 700),
    ("empty_rank", "few", dict(BASE, lower=1), ONE, None),
    ("empty_rank_ext_stream", "few", dict(EXT, lower=1), EXT_STREAM, 40),
    ("empty_rank_supermer_stream", "few", dict(SUPERMER, lower=1), SM_STREAM, 40),
]
CASES = [(s, ws) for ws in WORLD_SIZES for s in SCENARIOS]
IDS = [f"{s[0]}-{ws}ranks" for s, ws in CASES]


def _reads(kind: str, ws: int) -> list[str]:
    rng = np.random.default_rng(31)
    if kind == "random":
        reads = oracle.random_reads(rng, 40, 35, 90)
        return reads + reads[:20] + reads[:6]
    if kind == "poly_a":  # poly-A makes ~70% of the k-mers
        reads = oracle.random_reads(rng, 24, 40, 90)
        return reads + reads[:8] + ["A" * 300] * 10
    if kind == "few":  # fewer records than ranks: rank 0 has none (must_advance)
        return [r * 2 for r in oracle.random_reads(rng, ws - 1, 40, 60)]
    raise ValueError(kind)


def _write_fasta(path: str, reads: list[str]) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j: j + 60] + "\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------
# The JAX side: this file run as a script, one process a rank.


# A JAX process joins its group before anything of JAX runs, then loads this
# file and runs its jobs: argv = port, processes, process id, jobs, out dir,
# this file.
JAX_RANK = (
    "import runpy, sys\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.distributed.initialize(coordinator_address='127.0.0.1:' + sys.argv[1],\n"
    "                           num_processes=int(sys.argv[2]),\n"
    "                           process_id=int(sys.argv[3]))\n"
    "runpy.run_path(sys.argv[6])['_jax_rank_jobs'](int(sys.argv[3]), sys.argv[4],\n"
    "                                              sys.argv[5])\n"
    "jax.distributed.shutdown()\n"
)


def _jax_rank_jobs(pid: int, jobs_path: str, out_dir: str) -> None:
    from hysortk_tpu import KmerConfig
    from hysortk_tpu.parallel import multihost as jmultihost
    from hysortk_tpu.parallel import supermer_route as jroute

    with open(jobs_path) as f:
        jobs = json.load(f)
    for job in jobs:
        kind = job["kind"]
        entry = getattr(jmultihost, kind, None) or getattr(jroute, kind)
        batch = (job["batch_bases"],) if kind.endswith("streaming") else ()
        kl, hist = entry(job["fasta"], KmerConfig(**job["cfg"]), *batch)
        out = dict(keys=np.asarray(kl.keys), counts=np.asarray(kl.counts),
                   hist=np.asarray(hist))
        if hasattr(kl, "rid"):
            empty = np.zeros(0, np.int32)
            out.update(occ_rid=np.concatenate([empty, *kl.rid]).astype(np.int32),
                       occ_pos=np.concatenate([empty.view(np.uint32), *kl.pos]))
        np.savez(os.path.join(out_dir, f"{job['name']}.{pid}.npz"), **out)


def _start_jax(ws: int, jobs: list[dict], d: str) -> list[subprocess.Popen]:
    jobs_path = os.path.join(d, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", JAX_RANK, str(port), str(ws), str(pid), jobs_path, d,
         os.path.abspath(__file__)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(ws)]


def _wait(procs: list[subprocess.Popen]) -> None:
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{(name, ws): (port ranks, JAX ranks)}: every scenario through both
    packages, the JAX processes running while the port's ranks do."""
    root = tmp_path_factory.mktemp("multihost")
    launches = []
    for ws in WORLD_SIZES:
        jdir, pdir = root / f"jax{ws}", root / f"port{ws}"
        jdir.mkdir()
        pdir.mkdir()
        jjobs, pjobs = [], []
        for name, reads_kind, fields, kind, batch in SCENARIOS:
            reads = _reads(reads_kind, ws)
            job = dict(name=name, kind=kind, cfg=fields, batch_bases=batch)
            jpath, ppath = str(jdir / f"{name}.fa"), str(pdir / f"{name}.fa")
            _write_fasta(jpath, reads)
            _write_fasta(ppath, reads)
            # The JAX processes would each write a missing index at once;
            # the port's rank 0 writes it while the others wait.
            jfasta.load_or_build_fai(jpath)
            jjobs.append(dict(job, fasta=jpath))
            pjobs.append(dict(job, fasta=ppath, device="cpu"))
        launches.append((ws, jdir, pdir, pjobs, _start_jax(ws, jjobs, str(jdir))))
    out = {}
    try:
        for ws, jdir, pdir, pjobs, procs in launches:
            spawn_ranks(testing.run_rank_jobs, ws, (pjobs, str(pdir)),
                        workdir=str(pdir), device="cpu", timeout=TIMEOUT)
        for ws, jdir, pdir, pjobs, procs in launches:
            _wait(procs)
            for name, *_ in SCENARIOS:
                out[(name, ws)] = tuple(
                    [dict(np.load(d / f"{name}.{r}.npz")) for r in range(ws)]
                    for d in (pdir, jdir))
    finally:
        for *_, procs in launches:
            for p in procs:
                if p.poll() is None:
                    p.kill()
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


@pytest.mark.parametrize("scenario,ws", CASES, ids=IDS)
def test_multihost_matches_jax_per_rank(results, scenario, ws):
    name, reads_kind, fields, kind, batch = scenario
    ours, theirs = results[(name, ws)]
    ext = fields.get("extension", False)
    for got, want in zip(ours, theirs):
        assert got["keys"].dtype == np.uint32 and got["counts"].dtype == np.int32
        assert np.array_equal(got["keys"], want["keys"].reshape(got["keys"].shape))
        assert np.array_equal(got["counts"], want["counts"])
        assert got["hist"].dtype == np.int32
        assert np.array_equal(got["hist"], want["hist"])
        if ext:
            assert _as_ext(got, fields["k"]).as_dict() == \
                _as_ext(want, fields["k"]).as_dict()

    # The shares are disjoint and together the oracle's list.
    union = {}
    for got in ours:
        part = hysortk_tpu_torch.KmerList(got["keys"], got["counts"],
                                          fields["k"]).as_dict()
        assert not set(part) & set(union)
        union.update(part)
    filt = oracle.oracle_filtered(_reads(reads_kind, ws), fields["k"],
                                  fields["lower"], fields["upper"])
    assert union == {km.encode(): c for km, c in filt.items()} and union
    hist = {c: int(n) for c, n in enumerate(ours[0]["hist"]) if n > 0}
    assert hist == oracle.oracle_histogram(filt)

    calls = dict(zip(testing.COUNTED, ours[0]["calls"].tolist()))
    if name == "range_heavy":  # the classifier re-ran the step with the combiner
        assert calls["_shard_body_range"] == 1
        assert calls["_shard_body_range_combiner"] == 1
    if name.startswith("supermer") or kind.startswith(SM_ONE):
        assert calls["_supermer_step"] >= 1
        assert sum(n for b, n in calls.items() if b.startswith("_shard_body")) == 0
    if "heavy" in name and kind.startswith(SM_ONE):  # pre-counted on the device
        assert calls["heavy_precount_device"] >= 1
    assert calls["heavy_precount"] == 0  # the host pre-count is off the route
    if ext and kind in (EXT_STREAM, SM_STREAM):  # one merge, on the device
        assert calls["merge_ext_partials_device"] == 1
        assert calls["merge_ext_partials"] == 0
    if name.startswith("empty_rank"):  # one rank read no record
        records = [fasta.FaiRecord(str(i), len(r), 0, 60, 61)
                   for i, r in enumerate(_reads(reads_kind, ws))]
        parts = fasta.partition_records(records, ws)
        assert sum(not p for p in parts) == 1


# --------------------------------------------------------------------------
# Pure functions and the module's edges.


def test_read_displacements_and_owner_match_jax():
    rng = np.random.default_rng(5)
    records = [fasta.FaiRecord(f"r{i}", int(n), 0, 60, 61)
               for i, n in enumerate(rng.integers(0, 400, 37))]
    for shards in (1, 2, 3, 5, 40):
        parts = fasta.partition_records(records, shards)
        assert parts == jfasta.partition_records(records, shards)
        displs = fasta.read_displacements(parts)
        want = jfasta.read_displacements(parts)
        assert displs.dtype == want.dtype == np.int64
        assert np.array_equal(displs, want)
        ids = np.arange(len(records))
        owner = fasta.getreadowner(displs, ids)
        assert np.array_equal(owner, jfasta.getreadowner(want, ids))
        assert fasta.getreadowner(displs, 7) == jfasta.getreadowner(want, 7)
        assert isinstance(fasta.getreadowner(displs, 7), int)
        for bad in (-1, len(records), [0, len(records)]):
            with pytest.raises(IndexError, match="out of range"):
                fasta.getreadowner(displs, bad)
            with pytest.raises(IndexError, match="out of range"):
                jfasta.getreadowner(want, bad)


def _shard_job(rank: int, path: str, out_dir: str) -> None:
    codes, lengths = multihost.read_my_shard(path)
    records, first = multihost.my_records(path, None)
    np.savez(os.path.join(out_dir, f"shard.{rank}.npz"), codes=codes, lengths=lengths,
             first=np.int64(first), n=np.int64(len(records)))


@pytest.mark.parametrize("ws", [1, 2, 3])
def test_read_my_shard_tiles_the_reads(tmp_path, ws):
    """Each rank's records, read by itself (rank 0 writes the missing
    index), tile the read set in order, and each rank's first read id is
    the count of the reads before it."""
    reads = oracle.random_reads(np.random.default_rng(8), 11, 20, 200)
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, reads)
    spawn_ranks(_shard_job, ws, (path, str(tmp_path)), workdir=str(tmp_path),
                device="cpu", timeout=120)
    shards = [np.load(tmp_path / f"shard.{r}.npz") for r in range(ws)]
    codes, lengths = fasta.reads_to_codes(reads)
    assert np.array_equal(np.concatenate([s["codes"] for s in shards]), codes)
    assert np.array_equal(np.concatenate([s["lengths"] for s in shards]), lengths)
    assert [int(s["first"]) for s in shards] == \
        list(np.cumsum([0] + [int(s["n"]) for s in shards])[:-1])
    assert all(int(s["n"]) for s in shards)


def test_facade_exports_the_multihost_entries():
    for name in ("count_fasta_multihost", "count_fasta_multihost_ext",
                 "count_fasta_multihost_streaming",
                 "count_fasta_multihost_ext_streaming"):
        assert name in hysortk_tpu_torch.__all__
        assert getattr(hysortk_tpu_torch, name) is getattr(multihost, name)
    assert hysortk_tpu_torch.count_fasta_multihost_supermer is \
        route.count_fasta_multihost_supermer


def test_entries_default_to_cuda_and_raise_without_a_card(tmp_path):
    """Inside a group on the CPU, an entry called without device="cpu"
    asks for the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, _reads("random", 1))
    spawn_ranks(_default_device_job, 1, (path, str(tmp_path)), workdir=str(tmp_path),
                device="cpu", timeout=120)
    with open(tmp_path / "raised.json") as f:
        assert json.load(f) == [True] * 6


def _default_device_job(rank: int, path: str, out_dir: str) -> None:
    from hysortk_tpu_torch.config import KmerConfig

    raised = []
    for entry, cfg, batch in (
            (multihost.count_fasta_multihost, BASE, ()),
            (multihost.count_fasta_multihost_streaming, BASE, (700,)),
            (multihost.count_fasta_multihost_ext, EXT, ()),
            (multihost.count_fasta_multihost_ext_streaming, EXT, (700,)),
            (route.count_fasta_multihost_supermer, SUPERMER, ()),
            (route.count_fasta_multihost_supermer_streaming, SUPERMER, (700,))):
        try:
            entry(path, KmerConfig(**cfg), *batch)
            raised.append(False)
        except RuntimeError as e:
            raised.append("cuda" in str(e).lower())
    with open(os.path.join(out_dir, "raised.json"), "w") as f:
        json.dump(raised, f)


@pytest.mark.parametrize("process_id", [0, 1], ids=["coordinator", "peer"])
def test_a_peer_that_never_joins_times_out(tmp_path, process_id):
    """A process of 2 whose other process never starts (the one that
    listens at the coordinator, or the one that should come to it):
    initialize_distributed raises after RENDEZVOUS_TIMEOUT instead of
    waiting for ever."""
    code = (
        "import sys, time\n"
        "from hysortk_tpu_torch.parallel import multihost\n"
        "multihost.RENDEZVOUS_TIMEOUT = 3\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        f"    multihost.initialize_distributed(sys.argv[1], 2, {process_id}, device='cpu')\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, round(time.monotonic() - t0))\n"
        "    sys.exit(0)\n"
        "sys.exit('joined a group of two alone')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, f"127.0.0.1:{_free_port()}"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("raised")
    assert int(proc.stdout.split()[-1]) < 60


def test_a_collective_outlasts_the_rendezvous_timeout(tmp_path):
    """The rendezvous timeout bounds only the joining: two processes join
    with RENDEZVOUS_TIMEOUT = 2, then process 1 comes to an all-reduce
    three times that late, and process 0 waits for it there."""
    code = (
        "import sys, time, torch, torch.distributed as dist\n"
        "from hysortk_tpu_torch.parallel import multihost\n"
        "multihost.RENDEZVOUS_TIMEOUT = 2\n"
        "rank = int(sys.argv[2])\n"
        "multihost.initialize_distributed(sys.argv[1], 2, rank, device='cpu')\n"
        "if rank == 1:\n"
        "    time.sleep(6)\n"
        "t = torch.ones(1)\n"
        "dist.all_reduce(t)\n"
        "print('sum', int(t))\n"
        "dist.destroy_process_group()\n"
    )
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", code, address, str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, out + err[-3000:]
            assert out.strip() == "sum 2"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


def test_initialize_distributed_is_a_no_op_without_a_coordinator():
    import torch.distributed as dist

    assert multihost.initialize_distributed(None, device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        multihost.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")
