"""Key-range exchange between the ranks of a process group.

The port of hysortk_tpu/parallel/exchange.py: `pack_sorted_ranges` (range
routing), `pack_by_destination` (the bucketed routings: minimizer and
kmer_hash; on the card the kernel csrc/dest_pack.cu), `mask_invalid_slots`,
`all_to_all_exchange`. The JAX package moves fixed (S, capacity) blocks with one
`lax.all_to_all` per array over the mesh axis; here every key and payload
row of a step rides ONE `dist.all_to_all_single` of an (S, rows, capacity)
tensor, and the per-destination counts a second, small one. Slot capacity
is static, as in the JAX package, and an overflow is a flag the caller
answers by doubling the capacity (parallel/pipeline.py).

Transport, by the backend rule of parallel/group.py: under NCCL the
collective takes the rank's CUDA tensors; under gloo (ranks sharing one
card, or the CPU) it takes host tensors, so CUDA rows are staged through
pinned host buffers, a copy out and a copy back around the collective.

`traffic` counts, per process, the exchanges run and the bytes of their
send tensors (the rank's own block included). `reset_traffic` clears it
before a run whose traffic is to be shown.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..ops import radix_sort
from . import group as group_mod

traffic = {"calls": 0, "bytes_sent": 0}
MAX_KERNEL_DEST = 255  # the pack kernel's S + 1 digits fit one byte


def reset_traffic() -> None:
    traffic.update(calls=0, bytes_sent=0)


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


def _pack_inputs(valid, dest, words, payloads, num_shards: int, capacity: int,
                 assign) -> list[torch.Tensor]:
    """Check pack_by_destination's arguments; the rows, key rows first."""
    rows = list(words) + list(payloads)
    n = dest.shape[0] if dest.dim() == 1 else -1
    if valid.dtype != torch.bool or valid.dim() != 1 or valid.shape[0] != n:
        raise ValueError(f"need (n,) bool validity and (n,) destinations, got "
                         f"{valid.dtype}{tuple(valid.shape)} and {tuple(dest.shape)}")
    if dest.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"need int32 or int64 destinations, got {dest.dtype}")
    if not 1 <= len(rows) <= radix_sort.MAX_ROWS:
        raise ValueError(f"need 1 to {radix_sort.MAX_ROWS} rows, got {len(rows)}")
    for r in rows:
        if r.dtype != torch.int32 or r.dim() != 1 or r.shape[0] != n:
            raise ValueError(f"every row must be an (n,) int32 tensor, n = {n}")
    if assign is not None and (assign.dtype != torch.int32 or assign.dim() != 1
                               or dest.dtype != torch.int32 or assign.numel() == 0):
        raise ValueError("a bucket -> rank table takes a non-empty (buckets,) int32 table "
                         "and int32 buckets")
    if any(t.device != dest.device for t in [valid, *rows]
           + ([assign] if assign is not None else [])):
        raise ValueError("every tensor of the pack must lie on one device")
    if num_shards < 1 or capacity < 0:
        raise ValueError(f"need num_shards >= 1 and capacity >= 0, got {num_shards}, "
                         f"{capacity}")
    return rows


def _dest_key(valid, dest, num_shards: int, assign) -> torch.Tensor:
    """Each slot's int64 destination rank (through `assign` where given),
    num_shards where the slot is not valid or its rank lies outside [0,
    num_shards): the digit the pack kernel groups by."""
    if assign is not None:
        dest = assign[torch.where(valid, dest, 0).to(torch.int64)]
    dest = dest.to(torch.int64)
    return torch.where(valid & (dest >= 0) & (dest < num_shards), dest, num_shards)


def pack_by_destination_plain(
    valid: torch.Tensor,
    dest: torch.Tensor,
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    num_shards: int,
    capacity: int,
    assign: torch.Tensor | None = None,
) -> tuple[torch.Tensor, np.ndarray, bool]:
    """The plain PyTorch version of the pack kernel, on any device: one
    stable torch.sort of the destination (num_shards where a slot is not
    sent), a bincount, and each slot's place in its destination from the
    sorted order; launches none of the port's kernels."""
    rows = _pack_inputs(valid, dest, words, payloads, num_shards, capacity, assign)
    dev = dest.device
    n = dest.shape[0]
    send = torch.full((num_shards, len(rows), capacity), -1, dtype=torch.int32,
                      device=dev)
    key = _dest_key(valid, dest, num_shards, assign)
    key_s, order = torch.sort(key, stable=True)
    counts_all = torch.bincount(key, minlength=num_shards + 1)
    starts = torch.cumsum(counts_all, 0) - counts_all
    place = torch.arange(n, device=dev) - starts[key_s]
    sent = (key_s < num_shards) & (place < capacity)
    d, c, src = key_s[sent], place[sent], order[sent]
    for r, row in enumerate(rows):
        send[d, r, c] = row[src]
    counts = counts_all[:num_shards].cpu().numpy()
    return send, counts, bool((counts > capacity).any())


def pack_by_destination(
    valid: torch.Tensor,
    dest: torch.Tensor,
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    num_shards: int,
    capacity: int,
    assign: torch.Tensor | None = None,
) -> tuple[torch.Tensor, np.ndarray, bool]:
    """Group the valid slots by destination into an (S, rows, capacity)
    send block: row s holds the first `capacity` slots bound for rank s, in
    input order, every key row and then every payload row; slots past the
    count hold the all-ones sentinel.

    The JAX version sorts [dest, *words, *payloads] together and orders a
    destination's slots by key; here they keep their input order (stable),
    and the receive side sorts again, so the counted keys are the same.

    valid: (N,) bool; dest: (N,) int32 or int64, the rank in [0, S) at
    valid slots, or with `assign` (a (buckets,) int32 bucket -> rank table)
    the int32 bucket; anything at invalid slots. Returns (send (S, rows,
    capacity) int32, counts (S,) int64 on the host, uncapped, overflow: some
    destination has more than `capacity` slots).

    On a CPU tensor the plain version; on a CUDA tensor the hand-written
    kernel csrc/dest_pack.cu (one stable pass whose digit is the
    destination, and a pad launch; one host read of the counts) for up to
    255 destinations. Past 255 (S + 1 digits no longer fit one byte) the
    destination is sorted by the radix-sort kernel with the slot index as
    payload and the rows are gathered: a rule on S alone.
    """
    rows = _pack_inputs(valid, dest, words, payloads, num_shards, capacity, assign)
    if dest.device.type == "cpu":
        return pack_by_destination_plain(valid, dest, words, payloads, num_shards,
                                         capacity, assign)
    if dest.device.type != "cuda":
        raise ValueError(f"unsupported device {dest.device}")
    if num_shards > MAX_KERNEL_DEST:
        return _pack_sorted(valid, dest, rows, num_shards, capacity, assign)
    return _pack_cuda(valid, dest, rows, num_shards, capacity, assign)


def _pack_cuda(valid, dest, rows, num_shards: int, capacity: int, assign):
    send, counts = launch_pack(valid, dest, rows, num_shards, capacity, assign)
    host = counts.cpu().numpy().astype(np.int64)
    return send, host[:num_shards], bool(host[num_shards])


def launch_pack(valid, dest, rows, num_shards: int, capacity: int, assign):
    """The pack kernel's two launches on CUDA tensors, with no host read:
    (send (S, rows, capacity) int32, counts (S + 1,) int32 on the card, the
    uncapped counts and then the overflow flag). Up to MAX_KERNEL_DEST
    destinations; the arguments as pack_by_destination checks them."""
    dev = dest.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_pack(valid, dest, rows, num_shards, capacity, assign)
    n = dest.shape[0]
    if n >= 2**31 or capacity >= 2**31:
        raise ValueError(f"the pack takes n and capacity below 2^31, got {n}, {capacity}")
    valid, dest = valid.contiguous(), dest.contiguous()
    rows = [r.contiguous() for r in rows]
    if assign is not None:
        assign = assign.contiguous()
    lib = _build.lib()
    send = torch.empty((num_shards, len(rows), capacity), dtype=torch.int32, device=dev)
    counts = torch.empty(num_shards + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.hk_dest_pack_scratch(n, num_shards), dtype=torch.int32,
                          device=dev)
    status = lib.hk_dest_pack(
        valid.data_ptr(), dest.data_ptr(), dest.element_size() // 4,
        None if assign is None else assign.data_ptr(),
        0 if assign is None else assign.numel(), _build.pointer_array(rows), len(rows),
        n, num_shards, capacity, send.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(status, "dest pack launch")
    _build.launches["dest_pack"] += 1
    return send, counts


def _pack_sorted(valid, dest, rows, num_shards: int, capacity: int, assign):
    """More than MAX_KERNEL_DEST destinations on the card: the radix-sort
    kernel on the destination with the slot index as payload, a bincount
    and a gather per row."""
    dev = dest.device
    n = dest.shape[0]
    send = torch.empty((num_shards, len(rows), capacity), dtype=torch.int32,
                       device=dev)
    if n == 0:
        return send.fill_(-1), np.zeros(num_shards, dtype=np.int64), False
    dest_key = _dest_key(valid, dest, num_shards, assign).to(torch.int32)
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
    traffic["calls"] += 1
    traffic["bytes_sent"] += send.numel() * send.element_size() + counts.numel() * 4
    capacity = send.shape[2]
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    recv_valid = slot[None, :] < recv_counts[:, None]
    return recv, recv_counts, recv_valid
