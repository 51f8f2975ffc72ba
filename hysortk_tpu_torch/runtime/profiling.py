"""Device profiling: torch.profiler traces.

The port of hysortk_tpu/runtime/profiling.py. The reference's observability
is compile-time-gated wall-clock timers (reference include/timer.hpp):

  * `trace(logdir)` captures a CPU + CUDA trace and writes it as a Chrome
    trace (Perfetto / chrome://tracing), per kernel; inside
    runtime/timer.record_stages the program's stage spans are its named
    ranges.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace into logdir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
