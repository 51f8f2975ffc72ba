"""Heavy-hitter classifier, bucket dispatchers and the bucket measurement.

The port of hysortk_tpu/parallel/dispatch.py. The reference over-partitions
the key space into virtual tasks, classifies heavy hitters (> heavy_ratio x
avg, HeavyHitterClassifier, src/kmerops.cpp:1157-1199), and places tasks on
ranks with a bounded first-fit dispatcher (BalancedDispatcher,
src/kmerops.cpp:1214-1327). Under the default range routing only the
classifier runs: on the per-destination totals of the exchange's first pass
(parallel/pipeline.py), a destination above heavy_ratio x mean switches the
step to the combiner. The dispatchers serve minimizer routing, whose bucket
sizes are measured on the device (`bucket_sizes_device`); the assignment is
a small host computation, like the reference's root-rank dispatch + Bcast.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import count as count_ops

NORMAL, HEAVY = 0, 1  # task types; reference kmerops.hpp task_type semantics


def bucket_sizes_device(
    dest: torch.Tensor, valid: torch.Tensor, num_buckets: int
) -> torch.Tensor:
    """(num_buckets,) int32 valid k-mers per destination bucket (local)."""
    return count_ops.chunked_bincount(dest, valid, num_buckets)


def classify(sizes: np.ndarray, heavy_ratio: float = 2.3) -> np.ndarray:
    """Mark buckets whose size exceeds heavy_ratio x mean as HEAVY.

    Mirrors HeavyHitterClassifier (src/kmerops.cpp:1157-1199). In the TPU
    pipeline heavy buckets get the combiner pre-aggregation; the reference
    instead switches them to the ScatteredKmerList send path.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.size == 0:
        return np.zeros(0, dtype=np.int32)
    avg = sizes.mean()
    return np.where(sizes > heavy_ratio * avg, HEAVY, NORMAL).astype(np.int32)


def balanced_assignment(
    sizes: np.ndarray,
    num_shards: int,
    coe_start: float = 0.95,
    coe_step: float = 0.05,
    coe_max: float = 1.5,
) -> np.ndarray:
    """bucket -> shard assignment balancing total size.

    Same strategy as BalancedDispatcher::dispatch (src/kmerops.cpp:1274-1327):
    sort buckets by size, give the largest `num_shards` buckets one shard
    each, then first-fit the rest under a bound avg*coe, sweeping coe upward
    until feasible; falls back to least-loaded placement if the sweep fails.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    num_buckets = sizes.size
    assert num_buckets >= num_shards, (num_buckets, num_shards)
    order = np.argsort(-sizes)  # descending
    avg = max(sizes.sum() / num_shards, 1.0)

    coe = coe_start
    while coe <= coe_max + 1e-9:
        assign = np.full(num_buckets, -1, dtype=np.int32)
        load = np.zeros(num_shards, dtype=np.int64)
        # Phase 1: largest bucket per shard.
        for s in range(num_shards):
            b = order[s]
            assign[b] = s
            load[s] += sizes[b]
        # Phase 2: first-fit under bound.
        ok = True
        for b in order[num_shards:]:
            placed = False
            for s in np.argsort(load):
                if load[s] + sizes[b] <= avg * coe or load[s] == 0:
                    assign[b] = s
                    load[s] += sizes[b]
                    placed = True
                    break
            if not placed:
                ok = False
                break
        if ok:
            return assign
        coe += coe_step

    # Fallback: least-loaded greedy (always feasible).
    assign = np.full(num_buckets, -1, dtype=np.int32)
    load = np.zeros(num_shards, dtype=np.int64)
    for b in order:
        s = int(np.argmin(load))
        assign[b] = s
        load[s] += sizes[b]
    return assign


def round_robin_assignment(num_buckets: int, num_shards: int) -> np.ndarray:
    """bucket i -> shard i % num_shards (RoundRobinDispatcher,
    src/kmerops.cpp:1201-1211)."""
    return (np.arange(num_buckets, dtype=np.int64) % num_shards).astype(
        np.int32
    )


def imbalance(sizes: np.ndarray, assign: np.ndarray, num_shards: int) -> float:
    """max shard load / mean shard load (1.0 = perfect)."""
    load = np.zeros(num_shards, dtype=np.int64)
    np.add.at(load, assign, np.asarray(sizes, dtype=np.int64))
    mean = load.mean()
    return float(load.max() / mean) if mean else 1.0
