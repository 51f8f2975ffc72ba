"""The arithmetic of the metrics: the window rate, the device's busy union
and idle gaps, and the roofline's bytes."""

from __future__ import annotations

import pytest

from kmerbench import harness, roofline, trace


def test_kmerbench_union_and_gaps():
    busy = trace.union([(5, 10), (0, 3), (8, 12), (12, 13), (20, 20), (2, 4)])
    assert busy == [(0, 4), (5, 13)]
    assert trace.gaps(busy, 0, 30) == [(4, 5), (13, 30)]
    assert trace.gaps([], 3, 9) == [(3, 9)]


def test_kmerbench_reduce_intervals_busy_kernels_and_idle_names():
    us = 1000
    device = [
        (0, 100 * us, "sort", "kernel"),
        (50 * us, 150 * us, "Memcpy DtoH", "memcpy"),   # overlaps the kernel
        (300 * us, 400 * us, "count", "kernel"),
        (400 * us + 5 * us, 500 * us, "count", "kernel"),  # a 5 us gap
        (900 * us, 1200 * us, "late", "kernel"),          # ends past the window
    ]
    host = [(0, 1000 * us, "kmer_count"), (150 * us, 300 * us, "host pack"),
            (500 * us, 700 * us, "copy_out")]
    out = trace.reduce_intervals(device, host, 0, 1000 * us)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx((150 + 100 + 95 + 100) * 1e-6)
    assert out["kernel_s"] == pytest.approx((100 + 100 + 95 + 100) * 1e-6)
    assert out["ops"]["count"] == pytest.approx(195e-6)
    assert out["idle"]["host pack"] == pytest.approx(150e-6)
    # The gap after the last count: 200 us in copy_out, then 200 back in
    # kmer_count.
    assert out["idle"]["copy_out"] == pytest.approx(200e-6)
    assert out["idle"]["kmer_count"] == pytest.approx(200e-6)
    assert out["idle"][trace.SHORT_GAP_NAME] == pytest.approx(5e-6)
    assert sum(out["idle"].values()) + out["busy_s"] == pytest.approx(out["window_s"])


def test_kmerbench_innermost_range():
    ranges = trace.HostRanges([(0, 100, "call"), (10, 50, "pack"), (20, 30, "staging")])
    assert ranges.innermost(25) == "staging"
    assert ranges.innermost(40) == "pack"
    assert ranges.innermost(60) == "call"
    assert ranges.innermost(200) == trace.NO_RANGE


def test_kmerbench_top_cuts_and_orders():
    got = trace.top({"a" * 200: 1.0, "b": 3.0, "c": 2.0}, n=2, width=10)
    assert got == [["b", 3.0], ["c", 2.0]]


def test_kmerbench_call_bytes():
    # 2^30 bases in 71,582 reads, 30 M kept rows of two words, counts to 40.
    got = roofline.call_bytes(1 << 30, 71582, 30_000_000, 2, 40)
    assert got == (1 << 28) + 4 * 71582 + 30_000_000 * 9 + 4 * 41
    assert roofline.call_bytes(16, 1, 0, 2, 300, occurrences=5) == 4 + 4 + 4 * 301 + 40
    assert roofline.count_bytes(40) == 1 and roofline.count_bytes(300) == 2
    assert roofline.count_bytes(65536) == 4
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert roofline.peak("some other card", "hbm_bytes_per_s") is None


def fake_context(calls=4, window_s=2.0, ranks=None):
    cell = harness.Cell.load("hifi.oneshot")
    opts = harness.Options(cell, 1, 1.0, True, 0.0, device="cpu", bases=1 << 20)
    ranks = ranks or [{
        "rank": 0, "calls": calls, "window_s": window_s, "setup_s": 7.5,
        "peak_bytes": 3 << 30, "kind": "NVIDIA H100 80GB HBM3",
        "sizes": {"rows": 1000, "words": 2},
        "spans": [{"staging": 0.001, "host pack": 0.002, "pack": 0.01}] * calls,
        "copy_out_s": [0.004] * calls,
        "trace": {"busy_s": 0.5, "window_s": 2.0, "kernel_s": 0.4, "ops": {}, "idle": {}},
    }]
    return harness.Context(cell, opts, ranks)


def test_kmerbench_window_rate_and_readers():
    ctx = fake_context()
    lens = ctx.kmers_per_call
    assert lens == ctx.bases - 30 * ctx.reads
    assert harness.read_metric("kmers_per_s", ctx) == pytest.approx(lens * 4 / 2.0)
    assert harness.read_metric("peak_device_gib", ctx) == pytest.approx(3.0)
    assert harness.read_metric("setup_s", ctx) == 7.5
    assert harness.read_metric("host_pack_ms", ctx) == pytest.approx(3.0)
    assert harness.read_metric("copy_out_ms", ctx) == pytest.approx(4.0)
    assert harness.read_metric("device_idle_pct", ctx) == pytest.approx(75.0)
    assert harness.read_metric("supermer_pack_ms", ctx) == pytest.approx(10.0)
    assert harness.read_metric("exchange_ms", ctx) is None
    work = roofline.call_bytes(ctx.bases, ctx.reads, 1000, 2, 40)
    assert harness.read_metric("kernel_roofline_pct", ctx) == pytest.approx(
        100 * work / 3.35e12 / 0.1)


def test_kmerbench_readers_take_the_largest_rank():
    base = fake_context().ranks[0]
    other = dict(base, rank=1, spans=[{"staging": 0.004, "host pack": 0.004}] * 4,
                 copy_out_s=[0.001] * 4, trace=dict(base["trace"], busy_s=1.5))
    ctx = fake_context(ranks=[base, other])
    assert harness.read_metric("host_pack_ms", ctx) == pytest.approx(8.0)
    assert harness.read_metric("copy_out_ms", ctx) == pytest.approx(4.0)
    assert harness.read_metric("device_idle_pct", ctx) == pytest.approx(50.0)


def test_kmerbench_readers_find_nothing_without_a_trace():
    base = dict(fake_context().ranks[0], spans=[], copy_out_s=[], trace=None)
    ctx = fake_context(ranks=[base])
    for name in ("host_pack_ms", "copy_out_ms", "device_idle_pct", "kernel_roofline_pct",
                 "supermer_pack_ms", "exchange_ms"):
        assert harness.read_metric(name, ctx) is None


def test_kmerbench_path_wrong():
    expect = {"launches_per_call": {"keybuild": [1, 1], "fused_count": [1, 2]}}
    assert harness.path_wrong({"keybuild": 3, "fused_count": 5}, 3, expect) == 0
    assert harness.path_wrong({"keybuild": 12, "fused_count": 3}, 3, expect) == 1
    assert harness.path_wrong({}, 3, expect) == 2


class _Event:
    """A profiler event as older torch exposes it: no activity_type."""

    def __init__(self, name, device, start_us, dur_us, annotation=False):
        self._v = (name, device, start_us, dur_us, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[4]

    def start_us(self):
        return self._v[2]

    def duration_us(self):
        return self._v[3]


def test_kmerbench_reduce_profile_without_activity_types():
    events = [
        _Event(trace.WINDOW, False, 0, 1000, True),
        _Event("kmer_count", False, 0, 900, True),
        _Event("kmer_count", True, 0, 900, True),      # its device-side range
        _Event("kmer_count", True, 10, 800),           # the same, unflagged
        _Event("void sort_kernel", True, 100, 200),
        _Event("Memcpy DtoH (Device -> Pinned)", True, 300, 100),
        _Event("Memset (Device)", True, 450, 10),
        _Event("aten::copy_", False, 300, 50),
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    out = trace.reduce_profile(Prof)
    assert out["busy_s"] == pytest.approx(310e-6)
    assert out["kernel_s"] == pytest.approx(200e-6)
    assert set(out["ops"]) == {"void sort_kernel", "Memcpy DtoH (Device -> Pinned)",
                               "Memset (Device)"}
    assert out["idle"] == {"kmer_count": pytest.approx(590e-6),
                           trace.NO_RANGE: pytest.approx(100e-6)}
