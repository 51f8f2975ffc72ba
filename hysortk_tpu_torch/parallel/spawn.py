"""Run a function on S local ranks: S spawned processes in one process group.

    spawn_ranks(fn, world_size, args, workdir, device="cuda", timeout=600)

calls fn(rank, *args) in each of `world_size` processes started with the
`spawn` method (a fork after CUDA is initialised is unsafe), each joined to
the default group through a file:// rendezvous under `workdir` (no port to
collide) by parallel/group.init, with LOCAL_RANK set to its rank, so that
device="cuda" gives rank r the card r % device_count: ranks that share one
card take gloo, one card each NCCL. A child that raises makes spawn_ranks
raise with its traceback after the others are killed; a run past `timeout`
seconds (a collective that some rank never reached) kills every child and
raises TimeoutError. fn and args must pickle (a module-level function).
"""

from __future__ import annotations

import os
import time
import uuid

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from . import group as group_mod


def _rank_entry(rank: int, fn, world_size: int, init_method: str, device,
                args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    group_mod.init(init_method, rank, world_size, device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (), *, workdir: str,
                device="cuda", timeout: float = 600.0) -> None:
    init_method = "file://" + os.path.join(
        os.path.abspath(workdir), f"rendezvous-{uuid.uuid4().hex}")
    ctx = torch_mp.start_processes(
        _rank_entry, args=(fn, world_size, init_method, device, args),
        nprocs=world_size, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
