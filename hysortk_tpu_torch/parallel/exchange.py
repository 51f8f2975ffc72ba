"""Key-range exchange between the ranks of a process group.

The port of hysortk_tpu/parallel/exchange.py: `pack_sorted_ranges` (range
routing), `pack_by_destination` (the bucketed routings: minimizer and
kmer_hash), `mask_invalid_slots`, `all_to_all_exchange`. The JAX package moves fixed (S, capacity) blocks with one
`lax.all_to_all` per array over the mesh axis; here every key and payload
row of a step rides ONE `dist.all_to_all_single` of an (S, rows, capacity)
tensor, and the per-destination counts a second, small one. Slot capacity
is static, as in the JAX package, and an overflow is a flag the caller
answers by doubling the capacity (parallel/pipeline.py).

Transport, by the backend rule of parallel/group.py: under NCCL the
collective takes the rank's CUDA tensors; under gloo (ranks sharing one
card, or the CPU) it takes host tensors, so CUDA rows are staged through
pinned host buffers, a copy out and a copy back around the collective.

`traffic` counts, per process, the exchanges run, the bytes of their send
tensors (the rank's own block included) and their seconds on the host
clock with the device synchronized at both ends (staging copies included).
`reset_traffic` clears it before a run whose traffic is to be shown.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import radix_sort
from . import group as group_mod

traffic = {"calls": 0, "bytes_sent": 0, "seconds": 0.0}


def reset_traffic() -> None:
    traffic.update(calls=0, bytes_sent=0, seconds=0.0)


def pack_sorted_ranges(
    sorted_words: Sequence[torch.Tensor],
    sorted_payloads: Sequence[torch.Tensor],
    offsets: Sequence[int],
    num_shards: int,
    capacity: int,
) -> tuple[torch.Tensor, np.ndarray, bool]:
    """Carve per-destination segments out of an already-sorted shard.

    Under range routing the destination of a key is a monotone function of
    the sort order, so the local sort has already grouped destinations
    into contiguous segments; `offsets` (S + 1 host integers) are their
    boundaries. Row s of the result holds the `capacity` slots starting at
    offsets[s] of every key row, then every payload row; a start within
    `capacity` of the end reads the all-ones pad there, as the JAX version
    pads each array by `capacity` so that no start clamps. Slots past a
    segment's count are masked or never read downstream.

    Returns (send (S, rows, capacity) int32, counts (S,) int64, overflow).
    """
    rows = list(sorted_words) + list(sorted_payloads)
    offsets = np.asarray(offsets, dtype=np.int64)
    counts = offsets[1:] - offsets[:-1]
    overflow = bool((counts > capacity).any())
    n = rows[0].shape[0]
    send = torch.empty((num_shards, len(rows), capacity), dtype=torch.int32,
                       device=rows[0].device)
    for s in range(num_shards):
        start = int(offsets[s])
        take = max(min(capacity, n - start), 0)
        for r, row in enumerate(rows):
            send[s, r, :take] = row[start:start + take]
        send[s, :, take:] = -1
    return send, counts, overflow


def pack_by_destination(
    valid: torch.Tensor,
    dest: torch.Tensor,
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    num_shards: int,
    capacity: int,
) -> tuple[torch.Tensor, np.ndarray, bool]:
    """Group the valid slots by destination into an (S, rows, capacity)
    send block: row s holds the first `capacity` slots bound for rank s,
    every key row and then every payload row; slots past the count hold the
    all-ones sentinel.

    The JAX version sorts [dest, *words, *payloads] together, which is up
    to 9 rows for extension mode at K > 80; here only the destination is
    sorted, with the slot index as its payload (ops/radix_sort: 2 rows at
    any key width), and the rows are gathered by index. A destination's
    slots therefore keep their input order instead of key order; the
    receive side sorts again, so the counted keys are the same.

    valid: (N,) bool; dest: (N,) int in [0, S) at valid slots. Returns
    (send (S, rows, capacity) int32, counts (S,) int64 on the host,
    overflow: some destination has more than `capacity` slots).
    """
    dev = dest.device
    n = dest.shape[0]
    rows = list(words) + list(payloads)
    send = torch.empty((num_shards, len(rows), capacity), dtype=torch.int32,
                       device=dev)
    if n == 0:
        return send.fill_(-1), np.zeros(num_shards, dtype=np.int64), False
    dest_key = torch.where(valid, dest.to(torch.int32), num_shards)
    (dest_s,), (order,) = radix_sort.sort_words(
        [dest_key], [torch.arange(n, dtype=torch.int32, device=dev)])
    counts_d = torch.bincount(dest_s.to(torch.int64), minlength=num_shards + 1)
    counts = counts_d[:num_shards].cpu().numpy()
    overflow = bool((counts > capacity).any())
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    take = torch.from_numpy(np.minimum(counts, capacity)).to(dev)
    inside = slot[None, :] < take[:, None]
    src = torch.from_numpy(offsets[:-1]).to(dev)[:, None] + slot[None, :]
    idx = order[torch.where(inside, src, 0).clamp(max=n - 1)].to(torch.int64)
    for r, row in enumerate(rows):
        send[:, r] = torch.where(inside, row[idx], -1)
    return send, counts, overflow


def mask_invalid_slots(
    recv_words: Sequence[torch.Tensor], recv_valid: torch.Tensor
) -> list[torch.Tensor]:
    """Overwrite slots beyond each row's count with the all-ones sentinel.

    Keeps every received row sorted ascending end to end (the garbage tail
    becomes a sentinel tail), which the run merge requires. Returns new
    contiguous (S, capacity) tensors.
    """
    return [torch.where(recv_valid, w, -1) for w in recv_words]


def all_to_all_exchange(
    send: torch.Tensor, send_counts: Sequence[int], group=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exchange (S, rows, capacity) blocks so that block s comes from rank s.

    Returns (recv (S, rows, capacity), recv_counts (S,) int32,
    recv_valid (S, capacity) bool), all on send's device.
    """
    num_shards = dist.get_world_size(group)
    if send.dim() != 3 or send.shape[0] != num_shards:
        raise ValueError(f"need an ({num_shards}, rows, capacity) send tensor, "
                         f"got {tuple(send.shape)}")
    dev = send.device
    cdev = group_mod.collective_device(dev, group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    counts = torch.as_tensor(np.asarray(send_counts, dtype=np.int32), device=cdev)
    recv_counts = torch.empty_like(counts)
    if cdev == dev:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=group)
    else:
        # gloo with CUDA rows: through pinned host buffers, chosen by the
        # backend rule (group.collective_device), never by a caught error.
        host_send = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host_send.copy_(send)
        host_recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        dist.all_to_all_single(host_recv, host_send, group=group)
        recv = host_recv.to(dev)
    dist.all_to_all_single(recv_counts, counts, group=group)
    recv_counts = recv_counts.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    traffic["calls"] += 1
    traffic["bytes_sent"] += send.numel() * send.element_size() + counts.numel() * 4
    traffic["seconds"] += time.perf_counter() - t0
    capacity = send.shape[2]
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    recv_valid = slot[None, :] < recv_counts[:, None]
    return recv, recv_counts, recv_valid
