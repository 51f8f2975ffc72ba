"""Host + device memory telemetry.

The port of hysortk_tpu/runtime/memcheck.py (reference src/memcheck.cpp:7-106):
VmRSS/VmHWM from /proc/self/status and MemFree from /proc/meminfo, plus the
device's memory from torch.cuda.mem_get_info. The reference uses MemFree to
pick its sorter (src/kmerops.cpp:1344-1379); here the device headroom sizes
streaming batches and decides whether a call streams at all.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _proc_status_kb(field: str) -> Optional[int]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def get_rss_gb() -> float:
    """Current resident set size in GiB (reference VmRSS probe)."""
    kb = _proc_status_kb("VmRSS")
    return (kb or 0) / (1024 * 1024)


def get_peak_rss_gb() -> float:
    """Peak RSS in GiB (reference VmHWM probe)."""
    kb = _proc_status_kb("VmHWM")
    return (kb or 0) / (1024 * 1024)


def get_free_memory_kb() -> int:
    """Host MemFree in kB (reference get_free_memory_kb)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemFree:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def get_hbm_stats(device) -> Optional[dict]:
    """{'bytes_in_use', 'bytes_limit'} of a CUDA device; None for the CPU.

    torch.cuda.mem_get_info counts the blocks PyTorch's caching allocator
    holds but has free as used. They are added back (reserved - allocated),
    or a process's second call would see less headroom than its first for
    no reason but the first call's cache."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return {"bytes_in_use": total - free - cached, "bytes_limit": total}


def hbm_headroom_bytes(device, safety: float = 0.9) -> Optional[int]:
    """Usable device-memory headroom; the analogue of the reference's
    sort_decision input (90% of MemFree, src/kmerops.cpp:1358-1376).
    None for a CPU device."""
    stats = get_hbm_stats(device)
    if not stats or not stats["bytes_limit"]:
        return None
    return int(stats["bytes_limit"] * safety) - stats["bytes_in_use"]


def gathered_memory_report() -> str:
    """Every process's RSS / peak / MemFree, in the layout of the
    reference's get_mem_gb gather + root print (src/memcheck.cpp:60-106):
    one row per rank of a torch.distributed group of more than one rank (one
    all_gather_object, the same text on every rank), else this process's."""
    row = (get_rss_gb(), get_peak_rss_gb(), get_free_memory_kb() / 1024 / 1024)
    rows = [row]
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, row)
    lines = [
        f"  proc {i}: rss {r[0]:.2f} GB, peak {r[1]:.2f} GB, free {r[2]:.2f} GB"
        for i, r in enumerate(rows)
    ]
    lines.append(f"  total rss {sum(r[0] for r in rows):.2f} GB across "
                 f"{len(rows)} procs")
    return "-- memory --\n" + "\n".join(lines)
