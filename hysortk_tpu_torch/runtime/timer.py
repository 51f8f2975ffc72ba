"""Stage timing.

The port of hysortk_tpu/runtime/timer.py (reference Timer/TimerLocal,
include/timer.hpp:11-95). CUDA work is asynchronous, so a `synchronized`
timer waits for the device at both edges of a span
(torch.cuda.synchronize), and inside a torch.distributed group of more than
one rank it also waits at a barrier as a span starts, so that every rank's
span starts together (the reference Timer's MPI_Barrier + MPI_Wtime); without
it a span measures the host's part only, the TimerLocal equivalent.
Device-level profiling uses torch.profiler traces (runtime/profiling.py)
instead of the reference's manual Wtime hooks.

`stage` spans mark the counting paths' stages (the one-shot path's wire
copy, wire decode, key build, radix sort, fused count, compaction, copy-out
and result assembly; the facade's headroom check; the streaming
scheduler's batches and merges; the sharded paths' pack, step, merge and
result; the supermer step's feed, plan and encode and the spans inside
them, down to each kernel's; the wire feed's pinned staging and host pack;
the kernel library's first load; the multi-process entries' read_shard and
its read_index). They cost nothing unless a caller asks: outside
`record_stages()` a span is one check of `_recording`, with no clock read,
no profiler range, no CUDA event and no synchronize. Inside it, each span
opens a torch.profiler range of its name for its host extent (on a card, a
range over the kernels it launched), and adds its seconds to the dict that
the block yields, per process, by one of two clocks:

  * host clock (the default): from the span's start to its end, where
    `device` is a CUDA device ended by a synchronize of it. Such a span
    writes its name into the dict as it starts (setdefault) and its seconds
    by one store as it ends, so a span inside another comes after it.
  * device clock (`events=True`, on a CUDA device): the device milliseconds
    between two CUDA events recorded on the current stream at the span's
    edges, with no synchronize. Its seconds are stored (one store, no
    setdefault) once the end event has passed, which `resolve` checks
    without waiting: the copy-out (pipeline.to_host) resolves them as its
    last piece has arrived, which every event before it has passed too, and
    `record_stages` waits for any left when it ends. On the CPU such a
    span takes the host clock.

A span name means one clock on every path: "wire copy", "wire decode", "key
build", "radix sort", "fused sort", "fused count" and "compaction" are
device-clock spans wherever they are entered (the supermer route's receive
side and feed included), every other name a host-clock span.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_recording: Optional[Dict[str, float]] = None
# Device-clock spans whose events are not resolved yet: (the dict of the
# recording they belong to, name, start event, end event).
_pending: list = []


@contextlib.contextmanager
def record_stages():
    """Within the block, every `stage` span adds its seconds to the dict
    yielded (name -> seconds); device-clock spans still pending as the block
    ends are waited for."""
    global _recording
    outer, _recording = _recording, {}
    try:
        yield _recording
    finally:
        resolve(wait=True)
        _recording = outer


@contextlib.contextmanager
def stage(name: str, device=None, events: bool = False):
    """A stage of a counting path. Inside `record_stages` its seconds are
    recorded and it is a profiler range: on the device's own clock where
    `events` and `device` is a CUDA device, else on the host clock, where
    `device` is a CUDA device the span ending when its work does. Outside,
    it does nothing."""
    seconds = _recording
    if seconds is None:
        yield
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if events and cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                _pending.append((seconds, name, start, end))
            return
        seconds.setdefault(name, 0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def resolve(wait: bool = False) -> None:
    """Store the seconds of the pending device-clock spans whose end event
    has passed (every one where `wait`, waiting for each); the others stay
    pending."""
    if not _pending:
        return
    left = []
    for seconds, name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            left.append((seconds, name, start, end))
            continue
        seconds[name] = seconds.get(name, 0.0) + start.elapsed_time(end) / 1e3
    _pending[:] = left


class Timer:
    def __init__(self, synchronized: bool = False):
        self._spans: Dict[str, List[float]] = {}
        self._synchronized = synchronized

    def _sync(self, barrier: bool = False) -> None:
        if not self._synchronized:
            return
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if barrier and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            dist.barrier()

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync(barrier=True)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - t0
            self._spans.setdefault(name, []).append(elapsed)

    def last(self, name: str) -> float:
        return self._spans[name][-1]

    def total(self, name: str) -> float:
        return sum(self._spans.get(name, []))

    def report(self) -> str:
        lines = ["-- timing --"]
        for name, vals in self._spans.items():
            lines.append(
                f"  {name}: {sum(vals):.3f}s"
                + (f" over {len(vals)} calls" if len(vals) > 1 else "")
            )
        return "\n".join(lines)
