"""Multi-process runs: joining, per-process reading, per-rank results.

The port of hysortk_tpu/parallel/multihost.py. The reference scales across
nodes with MPI ranks: each rank reads only its own base-balanced slice of the
FASTA (src/fastaindex.cpp:102-200), keeps only the k-mers it owns and writes
`<rank>.out` (src/hysortk.cpp:138-164); only the histogram is summed
(MPI_Allreduce, src/hysortk.cpp:115). Here:

  * initialize_distributed         <-> MPI_Init: joins the default
    torch.distributed group over a TCP rendezvous at the coordinator
    (parallel/group.init; NCCL where every rank of the host has a card of its
    own, else gloo), one device a process;
  * read_my_shard                  <-> getpartition + Scatterv: every process
    parses the small .fai itself (io/fasta.partition_bounds) and reads only
    its own records;
  * the count_fasta_multihost* entries run the per-rank drivers of
    parallel/pipeline.py (parallel/supermer_route.py for routing="supermer")
    on the rank's own reads: they are its block, every dimension that
    reaches a collective is agreed by one all-reduce MAX, and the rank
    returns its own share of the filtered list (the keys it owns, in its key
    order) with the global histogram (one all-reduce SUM).

Every rank runs the same collectives whether or not it holds reads: with
fewer records than processes the last ranks read none and count nothing. Per
rank, each result equals the JAX multi-process entry's for that process
(extension mode by as_dict()). The stages (read_shard here, with its
read_index part; pack (the supermer step's with its feed, plan and encode
parts), step, merge, result in the per-rank counting paths) are timed inside
runtime/timer.record_stages.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import KmerConfig
from ..io import fasta as fasta_io
from ..pipeline import KmerList, KmerListExt, resolve_device
from ..runtime.scheduler import ExtPartialStore
from ..runtime.timer import stage
from . import group as group_mod
from . import pipeline as sharded

__all__ = [
    "count_fasta_multihost",
    "count_fasta_multihost_ext",
    "count_fasta_multihost_ext_streaming",
    "count_fasta_multihost_streaming",
    "initialize_distributed",
    "read_my_shard",
]

RENDEZVOUS_TIMEOUT = 600.0  # seconds a process waits for its peers to join


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> torch.device:
    """Join the default process group as rank `process_id` of
    `num_processes`, over a TCP rendezvous at `coordinator_address`
    ("host:port"; process 0 listens there). A no-op where the group is
    already up or no coordinator is given (one process). Returns this
    process's device.

    The card: LOCAL_RANK and LOCAL_WORLD_SIZE where the environment sets
    them, else one host (the local rank is the process id, the local world
    the process count), so that process r takes card r % device_count:
    processes that share one card take gloo, one card each NCCL
    (group.backend_for). The rendezvous is a TCPStore that waits
    RENDEZVOUS_TIMEOUT seconds for every process to arrive and then raises;
    once all have arrived, the store and the collectives take torch's
    default timeout."""
    if dist.is_initialized() or coordinator_address is None:
        return group_mod.rank_device(device)
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT))
    store.set_timeout(dist.default_pg_timeout)
    return group_mod.init(None, process_id, num_processes, dev, local_world, store=store)


def my_records(fasta_path: str, group) -> tuple[fasta_io.FaiIndex, int]:
    """This rank's slice of the FASTA's index (its records of the
    base-balanced partition) and the global index of its first record (0
    where it has none). Rank 0 builds a missing .fai while the others wait
    at a barrier (every rank passes it, whether or not the index was
    there), so that no rank reads an index another is still writing; every
    other rank, and rank 0 where the file was there, then parses it once."""
    rank = dist.get_rank(group)
    index = None
    if rank == 0 and not os.path.exists(fasta_path + ".fai"):
        index = fasta_io.load_or_build_fai(fasta_path)
    dist.barrier(group)
    if index is None:
        index = fasta_io.load_or_build_fai(fasta_path)
    bounds = fasta_io.partition_bounds(index, dist.get_world_size(group))
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    return index[lo:hi], (lo if hi > lo else 0)


def read_my_records(fasta_path: str, group=None):
    """(codes, lengths, global index of the first read) of this rank's
    records (read_my_shard with the read-id offset)."""
    with stage("read_shard"):
        with stage("read_index"):
            records, first = my_records(fasta_path, group)
        codes, lengths = fasta_io.read_records(fasta_path, records)
    return codes, lengths, first


def read_my_shard(fasta_path: str, cfg: KmerConfig | None = None,
                  group=None) -> tuple[np.ndarray, np.ndarray]:
    """This rank's base-balanced slice of the FASTA: (codes uint8, lengths
    int64). Unlike the reference (root parses and Scatterv,
    fastaindex.cpp:137-176) every rank parses the small .fai and reads its
    own byte range. `cfg` is accepted for parity with the JAX signature."""
    codes, lengths, _ = read_my_records(fasta_path, group)
    return codes, lengths


def count_fasta_multihost(
    fasta_path: str, cfg: KmerConfig, group=None, device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """The multi-process pipeline: this rank's records -> its block on the
    2-bit wire -> the exchange and count of parallel/pipeline.py's step
    (range routing: the packed range exchange, re-run through the combiner
    where the classifier flags a heavy destination in the all-reduced
    totals, as in the JAX package; minimizer and kmer_hash: their plans).
    routing="supermer" goes to supermer_route.count_fasta_multihost_supermer
    (extension mode included); extension mode is count_fasta_multihost_ext.

    Returns this rank's share of the filtered list and the global
    histogram."""
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_fasta_multihost_supermer(fasta_path, cfg, group,
                                                             device)
    codes, lengths, _ = read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    return _with_global_histogram(sharded._count_rank(codes, lengths, cfg, group, dev),
                                  cfg, group, dev)


def count_fasta_multihost_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int = 1 << 26, group=None,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Bounded-memory multi-process counting: each rank streams its own
    records through the exchange in batches of batch_bases (the batch count
    agreed by all-reduce MAX; a rank that runs out feeds empty batches).
    The route is planned on batch 0 and kept, the combiner switched on there
    where the classifier flags batch 0; each batch's unfiltered partial list
    stays on its rank (the routing is fixed, so a key keeps its owner) and
    the rank merges them once at the end at their exact run bounds
    (parallel/pipeline._merge_partials), [L, U] on the merged totals. Peak
    device memory is set by batch_bases at any process count (the
    reference's bounded rounds, src/kmerops.cpp:906-1007). Who owns a key
    follows batch 0 of every rank, so the shares can differ from a one-shot
    run's. routing="supermer" goes to
    supermer_route.count_fasta_multihost_supermer_streaming (extension mode
    included); otherwise extension mode is
    count_fasta_multihost_ext_streaming."""
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_fasta_multihost_supermer_streaming(
            fasta_path, cfg, batch_bases, group, device)
    if cfg.extension:
        raise ValueError("use count_fasta_multihost_ext_streaming for extension mode")
    codes, lengths, _ = read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    batches = sharded._own_batches(codes, lengths, batch_bases, dev, group)
    return _with_global_histogram(sharded._count_rank_streaming(batches, cfg, group, dev),
                                  cfg, group, dev)


def count_fasta_multihost_ext(
    fasta_path: str, cfg: KmerConfig, group=None, device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Multi-process extension mode: (read id, position) of every
    occurrence through the exchange (the reference's distributed EXTENSION
    mode, src/kmerops.cpp:1430-1438). Read ids are global: a rank's count
    from the index of its first record (the reference's MPI_Exscan of read
    counts, src/kmerops.cpp:66), 0 on a rank with none.
    routing="supermer" goes to supermer_route.count_fasta_multihost_supermer
    (the run-format wire with {len, pos, rid} headers).

    Returns this rank's KmerListExt and the global histogram."""
    cfg = _extension(cfg)
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_fasta_multihost_supermer(fasta_path, cfg, group,
                                                             device)
    codes, lengths, rid_offset = read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    part = sharded._count_rank_ext(codes, lengths, cfg, group, dev, rid_offset, (0, 1))
    return _with_global_histogram(sharded._ext_list(part, cfg.k), cfg, group, dev)


def count_fasta_multihost_ext_streaming(
    fasta_path: str, cfg: KmerConfig, batch_bases: int = 1 << 26, group=None,
    device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Bounded-memory multi-process extension mode: each rank streams its
    own records in batches of batch_bases (the batch count agreed by
    all-reduce MAX), each batch counted unfiltered with read ids advanced
    by the batches before it; its own partials stay on its device and merge
    there once (runtime/scheduler.ExtPartialStore, [L, U] on the merged
    totals; the merge runs no collective, so a rank that drains to the host
    keeps in step). routing="supermer" goes to the supermer stream in
    extension mode.

    Returns this rank's KmerListExt and the global histogram."""
    cfg = _extension(cfg)
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_fasta_multihost_supermer_streaming(
            fasta_path, cfg, batch_bases, group, device)
    codes, lengths, first = read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    min_dims = sharded.ext_stream_dims(lengths, batch_bases, cfg, 1)
    store = ExtPartialStore(cfg, dev)
    for b_codes, b_lengths, rid in sharded._own_batches(codes, lengths, batch_bases, dev,
                                                        group, first):
        store.add(sharded._count_rank_ext(b_codes, b_lengths, cfg_pre, group, dev, rid,
                                          min_dims))
    with stage("merge", dev):
        merged, _ = store.result()
    return _with_global_histogram(merged, cfg, group, dev)


def _with_global_histogram(kmerlist, cfg: KmerConfig, group, dev):
    """(the rank's list, the histogram of every rank's list summed)."""
    return kmerlist, sharded._global_histogram(kmerlist.counts, cfg.upper, dev, group)


def _extension(cfg: KmerConfig) -> KmerConfig:
    return cfg if cfg.extension else dataclasses.replace(cfg, extension=True)
