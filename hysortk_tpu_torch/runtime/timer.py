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

`stage` spans mark the counting paths' stages (the sharded drivers' pack,
step, merge and result; the supermer step's feed, plan and encode and the
spans inside them, down to each kernel's; the wire feed's pinned staging
and host pack; the kernel library's first load; the multi-process entries'
read_shard and its read_index). They cost nothing unless a caller asks: inside
`record_stages()` each span adds its seconds, ended by a synchronize of its
device, to the dict that the block yields, per process, in the order the
spans were entered (a span inside another comes after it).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_recording: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def record_stages():
    """Within the block, every `stage` span adds its seconds to the dict
    yielded (name -> seconds)."""
    global _recording
    outer, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = outer


@contextlib.contextmanager
def stage(name: str, device=None):
    """A stage of a counting path. Inside `record_stages` its seconds are
    recorded, and where `device` is a CUDA device the span ends when its
    work does; outside, it does nothing."""
    if _recording is None:
        yield
        return
    seconds = _recording
    seconds.setdefault(name, 0.0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


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
