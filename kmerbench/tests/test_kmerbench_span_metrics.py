"""The readers of the program's one-shot spans: the device core ("key build"
+ "radix sort" + "fused count"), the copy-out's host copy and its wait, in
ms a call on the rank that spends most; nothing where the spans are not
there."""

from __future__ import annotations

import pytest

from kmerbench import harness
from kmerbench.tests.test_kmerbench_metrics import fake_context

CALL = {"staging": 0.001, "host pack": 0.002, "wire copy": 0.0005, "wire decode": 0.0003,
        "key build": 0.004, "radix sort": 0.08, "fused count": 0.0055, "compaction": 0.003,
        "copy-out": 0.13, "copy-out wait": 0.007, "copy-out host copy": 0.115}
NEW = ("device_core_ms", "host_copy_ms", "copy_out_wait_ms")


def _rank(rank, calls):
    base = fake_context().ranks[0]
    return dict(base, rank=rank, calls=len(calls), spans=calls)


def test_kmerbench_span_readers_arithmetic():
    other = dict(CALL, **{"radix sort": 0.07, "copy-out wait": 0.009,
                          "copy-out host copy": 0.105})
    ctx = fake_context(ranks=[_rank(0, [CALL, other])])
    assert harness.read_metric("device_core_ms", ctx) == pytest.approx(
        1e3 * (0.004 + 0.0055 + (0.08 + 0.07) / 2))
    assert harness.read_metric("host_copy_ms", ctx) == pytest.approx(110.0)
    assert harness.read_metric("copy_out_wait_ms", ctx) == pytest.approx(8.0)


def test_kmerbench_span_readers_take_the_largest_rank():
    slow_core = dict(CALL, **{"radix sort": 0.2})
    slow_copy = dict(CALL, **{"copy-out wait": 0.05, "copy-out host copy": 0.3})
    ctx = fake_context(ranks=[_rank(0, [slow_core] * 3), _rank(1, [slow_copy] * 3)])
    assert harness.read_metric("device_core_ms", ctx) == pytest.approx(209.5)
    assert harness.read_metric("host_copy_ms", ctx) == pytest.approx(300.0)
    assert harness.read_metric("copy_out_wait_ms", ctx) == pytest.approx(50.0)


def test_kmerbench_span_readers_find_nothing_without_their_spans():
    untraced = fake_context(ranks=[dict(fake_context().ranks[0], spans=[], trace=None)])
    for name in NEW:
        assert harness.read_metric(name, untraced) is None
    # The fused sort's route has no "key build" and "radix sort" spans.
    fused = {k: v for k, v in CALL.items() if k not in ("key build", "radix sort")}
    ctx = fake_context(ranks=[_rank(0, [dict(fused, **{"fused sort": 0.09})] * 2)])
    assert harness.read_metric("device_core_ms", ctx) is None
    assert harness.read_metric("host_copy_ms", ctx) == pytest.approx(115.0)
    # The benchmark's first fake rank: host feed spans only.
    for name in NEW:
        assert harness.read_metric(name, fake_context()) is None
