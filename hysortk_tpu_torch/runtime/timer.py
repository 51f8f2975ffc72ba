"""Stage timing.

The port of hysortk_tpu/runtime/timer.py (reference Timer/TimerLocal,
include/timer.hpp:11-95). CUDA work is asynchronous, so a `synchronized`
timer waits for the device at both edges of a span
(torch.cuda.synchronize); without it a span measures the host's part only,
the TimerLocal equivalent. Device-level profiling uses torch.profiler traces
(runtime/profiling.py) instead of the reference's manual Wtime hooks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


class Timer:
    def __init__(self, synchronized: bool = False):
        self._spans: Dict[str, List[float]] = {}
        self._synchronized = synchronized

    def _sync(self) -> None:
        if self._synchronized and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
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
