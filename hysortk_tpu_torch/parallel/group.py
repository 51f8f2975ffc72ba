"""The process group of the sharded pipeline: ranks, devices, the backend.

The counterpart of hysortk_tpu/parallel/mesh.py. In the JAX package one
program drives a mesh of devices along one `shards` axis; here each rank is
one process that drives one device, and a torch.distributed process group
takes the place of the mesh axis: the rank is the shard index, the world
size the shard count (dist.get_rank(group), dist.get_world_size(group);
the pipeline takes `group`, None for the default group). This module holds
what the group does not: the device of a rank, the backend rule, joining.

The backend rule, in one place (`backend_for`):
  * NCCL when every rank of a host has a card of its own;
  * otherwise gloo: ranks that share one card (NCCL refuses two ranks on
    one GPU), and ranks on the CPU. Under gloo the exchange stages CUDA
    tensors through pinned host buffers (parallel/exchange.py).
A failed initialisation raises; nothing falls back from NCCL to gloo.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..pipeline import resolve_device

_LOG = logging.getLogger(__name__)


def local_rank() -> int:
    """This process's index among the ranks of its host: LOCAL_RANK (set
    by torchrun and by parallel/spawn.py), else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda") -> torch.device:
    """The device this rank drives: `device` as given where it names an
    index or the CPU, else cuda:(local_rank % device_count). Raises where
    CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL when every rank of the host has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init(init_method: str | None, rank: int, world_size: int, device="cuda",
         local_world_size: int | None = None, store=None) -> torch.device:
    """Join the default process group as `rank` of `world_size` and return
    this rank's device. The backend follows `backend_for`; rank 0 logs the
    choice. local_world_size defaults to world_size (one host). A `store`
    (a torch.distributed Store every rank has already reached) takes the
    place of init_method."""
    dev = rank_device(device)
    lws = world_size if local_world_size is None else local_world_size
    backend = backend_for(dev, lws)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    meeting = {"init_method": init_method} if store is None else {"store": store}
    dist.init_process_group(backend, rank=rank, world_size=world_size, **meeting)
    if rank == 0:
        _LOG.info(
            "process group: %d ranks, backend %s (%s)", world_size, backend,
            "a card per rank" if backend == "nccl" else
            f"{lws} ranks on {dev.type}"
            + (f" with {torch.cuda.device_count()} card(s)"
               if dev.type == "cuda" else ""),
        )
    return dev


def init_from_env(device="cuda") -> torch.device:
    """Join the group that torchrun describes in the environment (RANK,
    WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return this
    rank's device. A default group already up is used as it is."""
    if dist.is_initialized():
        return rank_device(device)
    ws = int(os.environ["WORLD_SIZE"])
    return init("env://", int(os.environ["RANK"]), ws, device,
                int(os.environ.get("LOCAL_WORLD_SIZE", ws)))


def collective_device(device: torch.device, group=None) -> torch.device:
    """Where this group's collectives take their tensors: the rank's card
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")
