"""The reduction of a torch.profiler trace to the device's busy time, its
kernel time by name and its idle gaps, each gap named by what the host was
in when it began.

Works on plain (start_ns, end_ns, name) intervals, so the arithmetic is
tested without a card: `reduce_intervals`. `reduce_profile` reads them from
a finished torch.profiler.profile.
"""

from __future__ import annotations

import numpy as np

# Activities that occupy the device. gpu_user_annotation ranges span whole
# groups of kernels and their gaps, so they never count as busy.
DEVICE_ACTIVITIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
WINDOW = "kmerbench.window"
# Gaps shorter than this are summed under one name and not looked up.
SHORT_GAP_NS = 10_000
SHORT_GAP_NAME = "gaps under 10 us"
NO_RANGE = "no host range"


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merged, sorted intervals (start, end) of the input's union."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no busy interval covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


class HostRanges:
    """The host's ranges; `innermost(t)` names the one that started last
    among those that hold [t, t + 1)."""

    def __init__(self, ranges: list[tuple[int, int, str]]):
        ranges = sorted(ranges)
        self.starts = np.array([r[0] for r in ranges], dtype=np.int64)
        self.ends = np.array([r[1] for r in ranges], dtype=np.int64)
        self.names = [r[2] for r in ranges]

    def innermost(self, t: int) -> str:
        i = int(np.searchsorted(self.starts, t, side="right"))
        if i == 0:
            return NO_RANGE
        hold = np.nonzero(self.ends[:i] > t)[0]
        return self.names[hold[-1]] if hold.size else NO_RANGE


def reduce_intervals(device: list[tuple[int, int, str, str]],
                     host: list[tuple[int, int, str]], lo: int, hi: int) -> dict:
    """device: (start, end, name, kind) of each device activity (kind
    "kernel", "memcpy" or "memset"); host: (start, end, name) of the host's
    ranges; [lo, hi) the window, in ns. Returns seconds: busy_s (the union
    of device activity), window_s, kernel_s (summed kernel time), ops
    (seconds by device activity name) and idle (idle seconds by the host
    range the host was innermost in, a gap cut where ranges start or end)."""
    clipped = [(max(s, lo), min(e, hi), n, k) for s, e, n, k in device if e > lo and s < hi]
    busy = union([(s, e) for s, e, _, _ in clipped])
    ops: dict[str, float] = {}
    kernel_ns = 0
    for s, e, name, kind in clipped:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        if kind == "kernel":
            kernel_ns += e - s
    ranges = HostRanges(host)
    edges = np.unique(np.concatenate([ranges.starts, ranges.ends]))
    idle: dict[str, float] = {}
    for s, e in gaps(busy, lo, hi):
        if e - s < SHORT_GAP_NS:
            idle[SHORT_GAP_NAME] = idle.get(SHORT_GAP_NAME, 0.0) + (e - s) / 1e9
            continue
        # The gap cut where a host range starts or ends: each piece goes to
        # the range the host was innermost in.
        cuts = edges[(edges > s) & (edges < e)].tolist()
        for a, b in zip([s] + cuts, cuts + [e]):
            name = ranges.innermost(a)
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "ops": ops,
        "idle": idle,
    }


def _flag(ev, method: str) -> bool:
    fn = getattr(ev, method, None)
    return bool(fn()) if fn is not None else False


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns (older torch gives us only)."""
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def activity(ev) -> str:
    """The event's kineto activity kind; where torch does not expose it,
    worked out from the device type, the annotation flag and the name."""
    fn = getattr(ev, "activity_type", None)
    if fn is not None:
        return str(fn())
    on_device = str(ev.device_type()).endswith("CUDA")
    if _flag(ev, "is_user_annotation"):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = ev.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def reduce_profile(prof) -> dict:
    """reduce_intervals over a finished torch.profiler.profile whose window
    is the host range named WINDOW. Also returns the activity kinds seen
    (`kinds`), so a trace with no device activity shows why."""
    events = prof.profiler.kineto_results.events()
    device, host, kinds = [], [], {}
    lo = hi = None
    for ev in events:
        kind = activity(ev)
        kinds[kind] = kinds.get(kind, 0) + 1
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if kind in DEVICE_ACTIVITIES:
            device.append((start, end, name, DEVICE_ACTIVITIES[kind]))
        elif kind == "user_annotation":
            if name == WINDOW:
                lo, hi = start, end
            else:
                host.append((start, end, name))
        elif kind == "cpu_op" and end - start >= 100_000:
            host.append((start, end, name))
    if lo is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    # A device-side copy of a host range is no work of the device's.
    annotations = {name for _, _, name in host} | {WINDOW}
    device = [d for d in device if d[2] not in annotations]
    out = reduce_intervals(device, host, lo, hi)
    out["kinds"] = kinds
    return out


def top(named: dict[str, float], n: int = 10, width: int = 120) -> list[list]:
    """The n largest entries as [name (cut to width), seconds]."""
    items = sorted(named.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], seconds] for name, seconds in items]
