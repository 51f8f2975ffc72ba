"""The port's runtime modules (hysortk_tpu_torch.runtime: memcheck, timer,
logger, profiling) and the facade's choice between one-shot and streaming
counting, against the JAX package where it has a counterpart on the CPU."""

import dataclasses
import io
import re
import time

import numpy as np
import pytest
import torch

import hysortk_tpu
import hysortk_tpu_torch
from hysortk_tpu import testing as oracle
from hysortk_tpu.runtime import memcheck as jmemcheck
from hysortk_tpu.runtime import scheduler as jsched
from hysortk_tpu.runtime import timer as jtimer
from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch.runtime import logger, memcheck, profiling, scheduler, timer

GIB = 1 << 30


@pytest.fixture
def fake_card(monkeypatch):
    """A card of 80 GiB whose free memory, reserved and allocated bytes the
    test sets: memcheck reads torch.cuda.mem_get_info and the caching
    allocator's counters."""
    state = {"free": 80 * GIB, "reserved": 0, "allocated": 0}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (state["free"], 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: state["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: state["allocated"])
    return state


def test_headroom_from_mem_get_info(fake_card):
    assert memcheck.hbm_headroom_bytes("cpu") is None
    assert memcheck.get_hbm_stats(torch.device("cpu")) is None
    assert memcheck.hbm_headroom_bytes("cuda") == int(80 * GIB * 0.9)
    fake_card.update(free=50 * GIB)
    assert memcheck.get_hbm_stats("cuda:0") == {
        "bytes_in_use": 30 * GIB, "bytes_limit": 80 * GIB}
    assert memcheck.hbm_headroom_bytes("cuda", safety=0.5) == 10 * GIB


def test_headroom_counts_cached_blocks_as_free(fake_card):
    """Blocks the caching allocator holds but has free are headroom: a
    process's second call must not see less than its first did."""
    first = memcheck.hbm_headroom_bytes("cuda")
    fake_card.update(free=70 * GIB, reserved=10 * GIB, allocated=0)
    assert memcheck.hbm_headroom_bytes("cuda") == first
    fake_card.update(allocated=4 * GIB)
    assert memcheck.hbm_headroom_bytes("cuda") == first - 4 * GIB


def test_proc_probes_match_jax():
    assert memcheck.get_rss_gb() > 0 and memcheck.get_peak_rss_gb() > 0
    assert abs(memcheck.get_rss_gb() - jmemcheck.get_rss_gb()) < 0.5
    assert memcheck.get_free_memory_kb() > 0
    ours = memcheck.gathered_memory_report().splitlines()
    theirs = jmemcheck.gathered_memory_report().splitlines()
    assert ours[0] == theirs[0] == "-- memory --" and len(ours) == len(theirs) == 3
    assert ours[1].startswith("  proc 0: rss ") and ours[2].endswith("across 1 procs")


def _reads_and_cfg():
    rng = np.random.default_rng(12)
    reads = oracle.random_reads(rng, 30, 35, 120)
    reads += reads[:15]
    j = hysortk_tpu.KmerConfig(k=31, m=17, lower=2, upper=50, pad_multiple=256)
    return fasta_io.reads_to_codes(reads), config.from_jax_fields(dataclasses.asdict(j))


def _facade_on_fake_card(monkeypatch, calls):
    """kmer_count(device="cuda") with no card: the device resolves, and the
    two counting paths record their call and run on the CPU."""
    monkeypatch.setattr(hysortk_tpu_torch, "resolve_device", torch.device)

    def streaming(codes, lengths, cfg, batch_bases, device):
        calls.append(("streaming", batch_bases, str(device)))
        return scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")

    def one_shot(codes, lengths, cfg, device):
        calls.append(("one_shot", str(device)))
        return pipeline.count_reads(codes, lengths, cfg, device="cpu")

    monkeypatch.setattr(hysortk_tpu_torch, "count_reads_streaming", streaming)
    monkeypatch.setattr(hysortk_tpu_torch, "count_reads", one_shot)


def test_kmer_count_streams_when_headroom_is_short(fake_card, monkeypatch):
    (codes, lengths), cfg = _reads_and_cfg()
    want = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    calls = []
    _facade_on_fake_card(monkeypatch, calls)
    need = int(codes.size) * (4 + 2 * cfg.words * 4 + 8) * 2

    kl, hist = hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cuda")
    assert calls == [("one_shot", "cuda")]  # 72 GiB of headroom

    # Leave less headroom than the working set: 0.9 x 80 GiB - in use < need.
    fake_card.update(free=80 * GIB - int(80 * GIB * 0.9) + need // 2)
    calls.clear()
    kl, hist = hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cuda")
    assert [c[0] for c in calls] == ["streaming"]
    assert calls[0][1] == scheduler.suggest_batch_bases(cfg, "cuda") == (1 << 20) - 16
    assert np.array_equal(kl.keys, want[0].keys)
    assert np.array_equal(kl.counts, want[0].counts)
    assert np.array_equal(hist, want[1])

    # No headroom at all (another process fills the card): one-shot, and the
    # out-of-memory error is the caller's to see, as in the JAX facade.
    fake_card.update(free=0)
    calls.clear()
    hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cuda")
    assert calls == [("one_shot", "cuda")]


def test_kmer_count_swallows_no_exception(fake_card, monkeypatch):
    (codes, lengths), cfg = _reads_and_cfg()
    _facade_on_fake_card(monkeypatch, [])
    fake_card.update(free=8 * GIB + 1000)  # short headroom: the streaming branch

    def broken(*a, **k):
        raise RuntimeError("nvcc failed (exit 1)")

    monkeypatch.setattr(hysortk_tpu_torch, "count_reads_streaming", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cuda")


def test_kmer_count_on_cpu_is_one_shot(monkeypatch):
    (codes, lengths), cfg = _reads_and_cfg()
    monkeypatch.setattr(
        hysortk_tpu_torch, "count_reads_streaming",
        lambda *a, **k: pytest.fail("the CPU has no headroom to run short of"),
    )
    kl, _ = hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cpu")
    assert len(kl) > 0


def test_batch_and_depth_suggestions_match_jax_rule(fake_card):
    cfg = config.KmerConfig(k=55, m=17)
    jcfg = hysortk_tpu.KmerConfig(k=55, m=17)
    assert scheduler.suggest_batch_bases(cfg, "cpu") == \
        jsched.suggest_batch_bases(jcfg) == (1 << 26) - 16
    assert scheduler.suggest_pipe_depth(1 << 26, 4, "cpu") == \
        jsched.suggest_pipe_depth(1 << 26, 4) == 2
    # 72 GiB of headroom, W = 4: 44 B/base with 2x slack, capped at 2^28.
    assert scheduler.suggest_batch_bases(cfg, "cuda") == (1 << 28) - 16
    fake_card.update(free=20 * GIB)  # 12 GiB of headroom
    assert scheduler.suggest_batch_bases(cfg, "cuda") == (1 << 27) - 16
    per_batch = 6 * (1 << 26) * 4
    assert scheduler.suggest_pipe_depth(1 << 26, 4, "cuda") == \
        (12 * GIB - 4 * per_batch) // per_batch
    assert scheduler.suggest_pipe_depth(1 << 30, 4, "cuda") == 1


def test_timer_matches_jax_report():
    ours, theirs = timer.Timer(), jtimer.Timer()
    for t in (ours, theirs):
        for name in ("a", "b", "a"):
            with t.span(name):
                time.sleep(0.002)
    assert ours.last("a") >= 0.002 and ours.total("a") >= 0.004
    assert ours.total("missing") == 0
    # The same lines once the measured seconds are blanked.
    blank = lambda text: re.sub(r"\d+\.\d{3}s", "#s", text)
    assert blank(ours.report()) == blank(theirs.report()) == \
        "-- timing --\n  a: #s over 2 calls\n  b: #s"
    with timer.Timer(synchronized=True).span("sync"):
        pass  # no card in use: nothing to wait for


def test_logger_layout():
    out = io.StringIO()
    log = logger.Logger(out)
    log.root("now")
    log.log("later 1")
    log.log("later 2")
    log.flush("label")
    log.flush()
    assert out.getvalue() == "now\n## label\n[proc 0] later 1\nlater 2\n"


def test_profiling_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("span"):
            torch.arange(1000).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert 0 <= profiling.device_seconds(lambda: torch.arange(1000).sum(), iters=2) < 1


# --------------------------------------------------------------------------
# The gathers across ranks: two gloo ranks in one spawn.

LATE = 0.5  # seconds rank 1 comes late to a synchronized span


def _runtime_ranks_job(rank: int, out_dir: str) -> None:
    import json
    import os

    out = io.StringIO()
    log = logger.Logger(out, rank=rank)
    log.log(f"rank {rank} line 1")
    log.log(f"rank {rank} line 2")
    log.flush("label")
    report = memcheck.gathered_memory_report()
    t = timer.Timer(synchronized=True)
    if rank == 1:
        time.sleep(LATE)
    t0 = time.perf_counter()
    with t.span("together"):
        entered = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"runtime.{rank}.json"), "w") as f:
        json.dump(dict(log=out.getvalue(), report=report, entered=entered,
                       span=t.last("together")), f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import json

    from hysortk_tpu_torch.parallel.spawn import spawn_ranks

    d = tmp_path_factory.mktemp("runtime_ranks")
    spawn_ranks(_runtime_ranks_job, 2, (str(d),), workdir=str(d), device="cpu",
                timeout=120)
    return [json.loads((d / f"runtime.{r}.json").read_text()) for r in range(2)]


def test_logger_flush_gathers_every_rank_in_rank_order(two_ranks):
    assert two_ranks[0]["log"] == (
        "## label\n[proc 0] rank 0 line 1\n[proc 0] rank 0 line 2\n"
        "[proc 1] rank 1 line 1\n[proc 1] rank 1 line 2\n")
    assert two_ranks[1]["log"] == ""  # rank 0 prints for every rank


def test_gathered_memory_report_has_a_row_per_rank(two_ranks):
    for r in two_ranks:
        lines = r["report"].splitlines()
        assert lines[0] == "-- memory --" and len(lines) == 4
        assert lines[1].startswith("  proc 0: rss ")
        assert lines[2].startswith("  proc 1: rss ")
        rss = [float(re.search(r"rss ([\d.]+) GB", line).group(1)) for line in lines[1:3]]
        total = float(re.search(r"total rss ([\d.]+) GB across 2 procs", lines[3]).group(1))
        assert abs(total - sum(rss)) <= 0.011


def test_synchronized_timer_span_waits_at_a_barrier(two_ranks):
    """Rank 1 comes LATE seconds late: rank 0's span starts only once
    rank 1 has come (a barrier), and the span itself times only its body."""
    assert two_ranks[0]["entered"] >= LATE * 0.8
    assert two_ranks[1]["entered"] < LATE * 0.8
    assert all(r["span"] < LATE * 0.8 for r in two_ranks)
