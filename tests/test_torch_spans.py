"""The port's stage spans (runtime/timer.stage) on the one-shot path, on the
CPU: the spans `count_reads` and `count_reads_ext` record inside
`record_stages`, and the ranges they open in a torch.profiler trace, nested
as the spans are; the copy-out split into its wait and its host copy over a
result's pieces; the facade's headroom check; the protocol by which a dict
that takes `record_stages`' place sees each span (a setdefault as a
host-clock span starts and one store as it ends, one store alone for a
device-clock span once its events have passed); the device clock's events
resolved only once passed, with fakes for the card's events; and, with
recording off, no profiler range, no CUDA event and no synchronize. The
test marked `cuda` checks on the card that every event-timed span is in the
dict when `kmer_count` returns."""

import ast
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hysortk_tpu_torch
from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.parallel import exchange
from hysortk_tpu_torch.runtime import memcheck, timer

# The one-shot path's spans on the CPU (its copy-out takes the ring only
# from a card, and the headroom check runs only for a card).
ONE_SHOT = ("staging", "host pack", "wire copy", "wire decode", "key build",
            "radix sort", "fused count", "compaction")
EXT = ONE_SHOT + ("result assembly",)
FUSED = ("staging", "host pack", "wire copy", "wire decode", "fused sort", "fused count",
         "compaction")
COPY_OUT = ("copy-out", "copy-out wait", "copy-out host copy")


def _reads(seed=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, 140, 40)
    lengths[::7] = lengths[0]  # some reads repeat, so counts pass 1
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    start = int(lengths[0])
    for i in range(7, lengths.size, 7):
        off = int(lengths[:i].sum())
        codes[off:off + start] = codes[:start]
    return codes, lengths


CFG = config.KmerConfig(k=21, m=11, lower=1, upper=60)


def _count(kind, monkeypatch):
    codes, lengths = _reads()
    if kind == "fused":
        monkeypatch.setenv("HYSORTK_FUSED_SORT", "1")
    if kind == "ext":
        return pipeline.count_reads_ext(codes, lengths, dataclasses.replace(
            CFG, extension=True), device="cpu")
    return pipeline.count_reads(codes, lengths, CFG, device="cpu")


EXPECTED = {"one_shot": ONE_SHOT, "ext": EXT, "fused": FUSED}


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_one_shot_records_its_spans(kind, monkeypatch):
    """Each stage of the one-shot path is a span of its own, with seconds."""
    with timer.record_stages() as seconds:
        _count(kind, monkeypatch)
    assert tuple(seconds) == EXPECTED[kind]
    assert all(s >= 0 for s in seconds.values())
    assert not timer._pending


def _annotations(prof) -> list:
    """(name, start, end) of the trace's host ranges that the program opened."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.is_user_annotation]


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_spans_are_profiler_ranges(kind, monkeypatch):
    """Under torch.profiler every span is a user range of its name, each
    inside the span it was entered in, and the path's stages one after the
    other."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.record_stages():
            with timer.stage("call"):
                _count(kind, monkeypatch)
    ranges = _annotations(prof)
    assert [r[0] for r in ranges] == ["call", *EXPECTED[kind]]
    stages = ranges[1:]
    assert all(_within(r, ranges[0]) for r in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("chunk, sizes", [(64, (100, 30)), (256, (1000, 7)), (4096, (9, 0))])
def test_copy_out_splits_wait_and_host_copy(chunk, sizes):
    """The ring's copy-out over several pieces is one "copy-out" span with a
    "copy-out wait" and a "copy-out host copy" span inside, and its arrays
    equal the CPU route's."""
    tensors = [torch.arange(sizes[0], dtype=torch.int32) * 7,
               torch.arange(sizes[1], dtype=torch.int64).reshape(-1, 1)]
    dtypes = [None, torch.int32]
    ring = pipeline.CopyRing(chunk)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.record_stages() as seconds:
            got = ring.copy_out(tensors, dtypes)
    want = pipeline.to_host(tensors, dtypes)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    assert tuple(seconds) == COPY_OUT and all(s >= 0 for s in seconds.values())
    ranges = _annotations(prof)
    pieces = len(pipeline.copy_plan([(t.numel(), t.element_size()) for t in tensors], chunk))
    assert pieces >= 1 and [r[0] for r in ranges] == \
        ["copy-out"] + ["copy-out wait", "copy-out host copy"] * pieces
    assert all(_within(r, ranges[0]) for r in ranges[1:])


class _Card:
    """torch.cuda's memory queries for a card that is not there."""

    @staticmethod
    def install(monkeypatch):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (50 << 30, 80 << 30))
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 6 << 30)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 4 << 30)


def test_headroom_check_is_a_span(monkeypatch):
    """The facade's and the scheduler's headroom check is one span around
    the card's memory queries; the CPU asks none."""
    _Card.install(monkeypatch)
    with timer.record_stages() as seconds:
        assert memcheck.get_hbm_stats("cpu") is None
        assert seconds == {}
        stats = memcheck.get_hbm_stats("cuda")
    assert stats == {"bytes_in_use": (30 << 30) - (2 << 30), "bytes_limit": 80 << 30}
    assert list(seconds) == ["headroom check"] and seconds["headroom check"] >= 0


class _CountingLog(dict):
    """A dict in `record_stages`' place that, like the benchmark's span log,
    takes a setdefault as a span that writes on entry opens and a store as
    it closes, and counts both by name."""

    def __init__(self):
        super().__init__()
        self.open: dict[str, int] = {}
        self.entered: dict[str, int] = {}
        self.stored: dict[str, int] = {}

    def setdefault(self, name, default=None):
        self.open[name] = self.open.get(name, 0) + 1
        self.entered[name] = self.entered.get(name, 0) + 1
        return super().setdefault(name, default)

    def __setitem__(self, name, value):
        if self.open.get(name):
            self.open[name] -= 1
        self.stored[name] = self.stored.get(name, 0) + 1
        super().__setitem__(name, value)


def _logged(fn):
    with timer.record_stages():
        log = timer._recording = _CountingLog()
        fn()
    return log


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_a_span_log_sees_balanced_entries_and_stores(kind, monkeypatch):
    log = _logged(lambda: _count(kind, monkeypatch))
    assert tuple(log) == EXPECTED[kind]
    assert log.entered == log.stored and not any(log.open.values())


def test_a_span_log_sees_each_copy_out_piece():
    tensors = [torch.arange(1000, dtype=torch.int32)]
    log = _logged(lambda: pipeline.CopyRing(256).copy_out(tensors, [None]))
    assert log.entered == log.stored == {"copy-out": 1, "copy-out wait": 16,
                                         "copy-out host copy": 16}
    assert not any(log.open.values())


class _FakeEvent:
    """A CUDA event of a card that is not there: `passed` says whether the
    card has reached it; `elapsed_time` gives the milliseconds between two
    events' `at`."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.passed = False
        self.at = None
        self.waited = False

    def record(self, stream=None):
        _FakeEvent.clock[0] += 2.5
        self.at = _FakeEvent.clock[0]

    def query(self):
        return self.passed

    def synchronize(self):
        self.waited = self.passed = True

    def elapsed_time(self, end):
        assert end.passed and end.at is not None
        return end.at - self.at


def test_device_clock_spans_store_once_their_events_pass(monkeypatch):
    """A device-clock span on a card records two events and no synchronize,
    writes nothing as it starts or ends, and stores the milliseconds between
    its events once its end has passed: `resolve` leaves it pending until
    then, `record_stages` waits for it as it ends."""
    made = []

    def event(**kw):
        made.append(_FakeEvent(**kw))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("torch.cuda.synchronize"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.record_stages():
            log = timer._recording = _CountingLog()
            with timer.stage("radix sort", "cuda", events=True):
                assert log == {}
            with timer.stage("fused count", "cuda:0", events=True):
                pass
            assert log == {} and len(timer._pending) == 2
            made[1].passed = True  # the radix sort's end, not the count's
            timer.resolve()
            assert log == {"radix sort": pytest.approx(2.5e-3)}
            assert len(timer._pending) == 1
    assert log == {"radix sort": pytest.approx(2.5e-3), "fused count": pytest.approx(2.5e-3)}
    assert made[3].waited and not made[1].waited and not timer._pending
    assert log.entered == {} and log.stored == {"radix sort": 1, "fused count": 1}
    assert [r[0] for r in _annotations(prof)] == ["radix sort", "fused count"]


def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} was called")
    return refuse


def test_nothing_outside_record_stages(monkeypatch):
    """Outside `record_stages` a span opens no profiler range, makes no CUDA
    event and no synchronize, on every clock, and leaves nothing pending."""
    for mod, name in ((torch.profiler, "record_function"), (torch.cuda, "Event"),
                      (torch.cuda, "synchronize"), (torch.cuda, "current_stream")):
        monkeypatch.setattr(mod, name, _refuse(name))
    _Card.install(monkeypatch)
    for kind in ("one_shot", "ext", "fused"):  # the fused sort's variable stays set
        _count(kind, monkeypatch)
    pipeline.CopyRing(64).copy_out([torch.arange(100)], [None])
    memcheck.get_hbm_stats("cuda")
    with timer.stage("radix sort", "cuda", events=True), timer.stage("exchange", "cuda"):
        pass
    assert timer._recording is None and not timer._pending


def test_exchange_makes_no_synchronize(tmp_path, monkeypatch):
    """all_to_all_exchange counts calls and bytes and waits for no device:
    its source calls no synchronize, and one exchange on a one-rank gloo
    group runs with torch.cuda.synchronize refused."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(exchange.all_to_all_exchange)))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert "synchronize" not in called
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("torch.cuda.synchronize"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        exchange.reset_traffic()
        send = torch.arange(12, dtype=torch.int32).reshape(1, 3, 4)
        recv, counts, valid = exchange.all_to_all_exchange(send, [3])
    finally:
        dist.destroy_process_group()
    assert torch.equal(recv, send) and counts.tolist() == [3]
    assert valid.tolist() == [[True, True, True, False]]
    assert exchange.traffic == {"calls": 1, "bytes_sent": 12 * 4 + 4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("extension", [False, True])
def test_event_spans_are_in_the_dict_when_kmer_count_returns(cuda, extension):
    """On the card every span of the one-shot path, the event-timed ones
    included, is in the dict as kmer_count returns, before record_stages
    ends, with positive seconds; none is left pending. The keys-only call
    also stops its result pages' faulting ("prefault stop")."""
    codes, lengths = _reads()
    cfg = dataclasses.replace(CFG, extension=extension)
    hysortk_tpu_torch.kmer_count(codes, lengths, cfg, "cuda")  # kernels built
    with timer.record_stages() as seconds:
        hysortk_tpu_torch.kmer_count(codes, lengths, cfg, "cuda")
        got = dict(seconds)
        assert not timer._pending
    want = (EXT if extension else ("headroom check",) + ONE_SHOT + ("prefault stop",)) + COPY_OUT
    assert set(got) == set(want)
    assert all(got[name] > 0 for name in ("wire copy", "wire decode", "key build",
                                          "radix sort", "fused count", "compaction"))
