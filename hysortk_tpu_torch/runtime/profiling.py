"""Device profiling: torch.profiler traces + steady-state timing.

The port of hysortk_tpu/runtime/profiling.py. The reference's observability
is compile-time-gated wall-clock timers (reference include/timer.hpp):

  * `trace(logdir)` captures a CPU + CUDA trace and writes it as a Chrome
    trace (Perfetto / chrome://tracing), per kernel instead of per stage.
  * `device_seconds(fn)` times a callable on the device with CUDA events
    (host wall clock where no CUDA device is in use).
  * `annotate(name)` names a span in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

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


def device_seconds(fn: Callable, *args, iters: int = 3) -> float:
    """Best-of-iters steady-state seconds for fn(*args), after one warm-up
    call (which also builds the kernels)."""
    fn(*args)
    on_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    best = float("inf")
    for _ in range(iters):
        if on_cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
