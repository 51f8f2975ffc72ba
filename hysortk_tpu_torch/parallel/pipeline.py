"""Sharded k-mer counting over a torch.distributed process group.

The port of hysortk_tpu/parallel/pipeline.py (and of the packed-wire entry
of multihost._count_multihost_packed). Each rank is one process with one
device (parallel/group.py). The drivers here are per rank: a rank's own
reads are its block (every dimension that reaches a collective agreed by
one all-reduce MAX), and it ends with its own share of the result. The
entries below give every rank the same global reads: each cuts its share
(_rank_share, the base-balanced partition), runs the per-rank driver and
all-gathers every rank's rows. The multi-process entries
(parallel/multihost.py) give each rank its own reads and return its own
share with the global histogram (one all-reduce SUM).

The default route is the range exchange; per step, on every rank:

  wire decode -> key build -> mix (ops/mixkey.py) -> ONE local sort
  -> contiguous per-destination segments -> all_to_all_single
  -> run merge of the S received runs -> count + [L,U] filter
  -> compact -> unmix on the device -> all ranks' lists gathered

Because the mixed sort key doubles as the routing key, a step costs one
local sort plus a merge of the S received sorted runs. The ownership rule:
dest = range of the mixed first word, uniform even on skewed genomes; equal
keys mix equally, so they land together. The classifier
(cfg.classifier == "heavy_hitter") reads the global per-destination totals
that every pass computes anyway; a destination heavier than heavy_ratio x
mean, which under a keyed routing can only come from duplicate k-mers,
re-runs the step through the combiner, where each rank pre-aggregates its
local duplicates and exchanges (key, partial count) entries (reference
ScatteredKmerList, src/kmerops.cpp:363-417).

The bucketed routes (`_shard_body_bucketed`) send each key to a bucket's
owner: routing="minimizer" is the reference's virtual-task scheme (minimizer
buckets, ops/minimizer.py, placed on ranks by the balanced or round-robin
dispatcher; the balanced plan measures the bucket sizes first, so its
capacity is exact), routing="kmer_hash" the legacy hash-mod rule. Both pack
by destination, exchange, and sort again on the receive side.

Around the step: `count_reads_sharded_streaming` streams batches of reads
through it unfiltered in bounded device memory and merges each rank's
partial lists at the end without an exchange (keys stay with their owner);
`count_reads_sharded_ext[_streaming]` is extension mode, with (read id,
position) payloads riding the sort and the exchange.

routing="supermer" ships supermers instead of keys (parallel/supermer_route.py):
count_reads_sharded, count_reads_sharded_streaming and count_reads_sharded_ext
hand it to that module, as the JAX package does; count_flat_sharded has no
supermer branch there and none here (its flat blocks take the kmer_hash
destination).

Every result equals the JAX package's on a mesh of as many devices as there
are ranks: keys in rank order, then the rank's key order (mixed-key order
under range routing), the same counts and histogram; extension mode the
same occurrences.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..config import KmerConfig
from ..io import fasta as fasta_io
from ..io import supermer as supermer_io
from ..ops import count as count_ops
from ..ops import fused_count
from ..ops import hashes
from ..ops import keybuild
from ..ops import merge as merge_ops
from ..ops import minimizer
from ..ops import mixkey
from ..ops import radix_sort
from ..ops import run_length_sum
from ..ops import wire
from ..ops.kmer import widen
from ..pipeline import (
    ExtPartial,
    KmerList,
    KmerListExt,
    feed_wire,
    host_histogram,
    kept_partial,
    to_host,
)
from ..runtime.scheduler import ExtPartialStore, iter_read_batches, read_batch_spans
from ..runtime.timer import stage
from . import dispatch
from . import exchange
from . import group as group_mod

_ATTEMPTS = 6  # passes per route before an overflow is an error, as in JAX


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def run_with_capacity_retry(run, capacity: int, measured: bool):
    """Run `run(capacity)` under the capacity-overflow protocol. `run`
    returns a tuple whose last element is the overflow flag, true where
    any rank's segment overflowed (every rank sees the same flag). A
    measured capacity is exact and gets one attempt; otherwise the capacity
    doubles, for up to 4 attempts. Returns (outputs without the flag,
    capacity)."""
    attempts = 1 if measured else 4
    for _ in range(attempts):
        out = run(capacity)
        if not out[-1]:
            return out[:-1], capacity
        capacity *= 2
    raise RuntimeError(f"exchange capacity overflow after {attempts} attempts")


def _factor_capacity(n_local: int, num_shards: int, cfg: KmerConfig) -> int:
    """capacity_factor x the mean per-(source, destination) load, at least
    64 slots: the capacity rule of every route that is not measured."""
    return max(int(n_local / num_shards * cfg.capacity_factor), 64)


def range_capacity(n_local: int, num_shards: int, cfg: KmerConfig) -> int:
    """Exchange slot capacity for range routing.

    The mean per-(source, destination) segment plus max(mean/64, 64) slots
    for the hash-uniform overhang (sigma ~ sqrt(mean) << mean/64) at every
    mean: mixed keys are hash-uniform per range, so only duplicate-key skew
    can overflow, which is the classifier's job (combiner re-run), with the
    capacity-doubling retry as the last resort. EXT keeps the legacy
    power-of-two capacity. Reference analogue: exact receive preallocation,
    src/kmerops.cpp:439-471.
    """
    if cfg.extension:
        return _next_pow2(_factor_capacity(n_local, num_shards, cfg))
    mean = max(-(-n_local // num_shards), 128)
    return mean + max(mean >> 6, 64)


def _build_marked_mixed(codes, valid, cfg: KmerConfig) -> list[torch.Tensor]:
    """codes/valid -> sentinel-marked, invertibly-mixed key words."""
    marked = keybuild.canonical_keys_fused(codes, valid, cfg.k)
    return mixkey.mix_keys(marked)


def _bounds(cfg: KmerConfig) -> tuple[int, int]:
    return (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)


def _all_reduce_host(values, op, dev, group) -> np.ndarray:
    """One all-reduce of int64 host values; the result on the host."""
    t = torch.from_numpy(np.asarray(values, dtype=np.int64).copy())
    t = t.to(group_mod.collective_device(dev, group))
    dist.all_reduce(t, op=op, group=group)
    return t.cpu().numpy()


def _global_histogram(counts: np.ndarray, upper: int, dev, group) -> np.ndarray:
    """The histogram of the rank's counts summed over the ranks by one
    all-reduce (the reference's MPI_Allreduce SUM, src/hysortk.cpp:115), as
    int32."""
    hist = host_histogram(counts, upper)
    return _all_reduce_host(hist, dist.ReduceOp.SUM, dev, group).astype(np.int32)


def _count_merged(merged_words, cfg: KmerConfig):
    """Sorted sentinel-marked words -> (cnt, keep)."""
    return fused_count.run_length_count_filter(merged_words, *_bounds(cfg))


_SIGN = -(2**31)  # XOR with it: the signed order of int32 words is unsigned


def _segment_offsets(mixed_s, n_valid: torch.Tensor, num_shards: int) -> torch.Tensor:
    """(S + 1,) int64 offsets of the destination segments of sorted mixed
    keys: the S - 1 inner range boundaries searched in the first word, then
    n_valid, the count of non-sentinel slots. The words hold uint32 bits
    in int32, so both sides of the search have their sign bit flipped (a
    plain search of int32 words would misplace every top-bit key). A valid
    key whose first word is all ones sorts before the sentinels and after
    every inner boundary: it lies in the last segment."""
    dev = mixed_s[0].device
    bnd = mixkey.range_boundaries(num_shards)[1:-1].astype(np.uint32)
    inner = torch.searchsorted(
        mixed_s[0] ^ _SIGN,
        torch.from_numpy(bnd.view(np.int32) ^ np.int32(_SIGN)).to(dev),
        side="left",
    )
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return torch.cat([zero, inner, n_valid.reshape(1).to(torch.int64)])


def _range_exchange_merge(
    mixed_s, payloads_s, n_valid, cfg: KmerConfig, num_shards: int,
    capacity: int, group=None,
):
    """Sorted mixed keys (+ payloads) -> merged received runs (+ payloads).

    The shared middle of the range bodies: segment offsets from the static
    range boundaries; one all-reduce (SUM) of the per-destination counts
    and the rank's overflow flag, which gives the global dest_totals (the
    classifier's input, free) and the number of ranks whose segment
    overflowed `capacity` (> 0 is the JAX package's pmax'd flag); then the
    contiguous pack, the exchange, the sentinel mask and the merge of the S
    received rows by their bounds (ops/merge.merge_runs_at; the JAX
    receive side pads each run to a power of two instead). Every rank sees
    the same flag, so on an overflow all of them return before the
    exchange: (None, None, dest_totals, True).

    Returns (merged_words, merged_payloads, dest_totals (S,) int64 numpy,
    overflow bool).
    """
    dev = mixed_s[0].device
    cdev = group_mod.collective_device(dev, group)
    offsets_d = _segment_offsets(mixed_s, n_valid, num_shards)
    counts_d = offsets_d[1:] - offsets_d[:-1]
    flag = (counts_d > capacity).any().reshape(1).to(torch.int64)
    stats = torch.cat([counts_d, flag]).to(cdev)
    dist.all_reduce(stats, group=group)
    host = torch.cat([offsets_d.to(cdev), stats]).cpu().numpy()
    offsets, totals = host[: num_shards + 1], host[num_shards + 1: -1]
    if host[-1] > 0:
        return None, None, totals, True

    send, counts, _ = exchange.pack_sorted_ranges(
        mixed_s, payloads_s, offsets, num_shards, capacity
    )
    recv, _, recv_valid = exchange.all_to_all_exchange(send, counts, group)
    del send
    n_words = len(mixed_s)
    rows = exchange.mask_invalid_slots(
        [recv[:, r] for r in range(n_words)], recv_valid
    ) + [recv[:, n_words + j].contiguous() for j in range(len(payloads_s))]
    del recv
    merged = merge_ops.merge_runs_at(
        [r.reshape(-1) for r in rows], n_words,
        range(0, (num_shards + 1) * capacity, capacity),
    )
    return merged[:n_words], merged[n_words:], totals, False


def _shard_body_range(codes, valid, *, cfg: KmerConfig, num_shards: int,
                      capacity: int, group=None):
    """Default per-rank program: one sort, contiguous pack, merge, count.
    Returns (words, cnt, keep, dest_totals, overflow); the first three are
    None on an overflow."""
    mixed_s, _ = radix_sort.sort_words(_build_marked_mixed(codes, valid, cfg))
    # Mixing keeps the sentinel and maps no valid key onto it, so the
    # sentinel slots are the invalid ones.
    merged_w, _, totals, overflow = _range_exchange_merge(
        mixed_s, [], valid.sum(), cfg, num_shards, capacity, group
    )
    if overflow:
        return None, None, None, totals, True
    del mixed_s
    cnt, keep = _count_merged(merged_w, cfg)
    return merged_w, cnt, keep, totals, False


def _shard_body_range_combiner(codes, valid, *, cfg: KmerConfig,
                               num_shards: int, capacity: int, group=None):
    """Heavy-hitter per-rank program: pre-aggregate local duplicates, then
    exchange (mixed key, partial count) entries.

    Because destination order == mixed key order, the compaction of the
    per-distinct-key entries and their destination grouping are ONE sort:
    non-head slots are folded to the sentinel and sort away. The local
    count is the fused count with unbounded [1, 2^31 - 1], whose keep is the
    run head; the receive side sums the partial counts by run
    (ops/run_length_sum.py) and filters. Returns as _shard_body_range.
    """
    mixed_s, _ = radix_sort.sort_words(_build_marked_mixed(codes, valid, cfg))
    local_cnt, head = fused_count.run_length_count_filter(mixed_s, 1, 2**31 - 1)
    entry_words = [torch.where(head, w, -1) for w in mixed_s]
    del mixed_s
    entry_s, pay_s = radix_sort.sort_words(entry_words, [local_cnt])
    del entry_words, local_cnt
    merged_w, merged_p, totals, overflow = _range_exchange_merge(
        entry_s, pay_s, head.sum(), cfg, num_shards, capacity, group
    )
    if overflow:
        return None, None, None, totals, True
    head2, cnt = run_length_sum.run_length_sum_fused(merged_w, merged_p[0])
    keep = count_ops.frequency_filter(head2, cnt, *_bounds(cfg))
    return merged_w, cnt, keep, totals, False


def _hash_destinations(words, num_shards: int) -> torch.Tensor:
    """kmer_hash routing: dest = mix_words(key) mod S, unsigned."""
    return widen(hashes.mix_words(words)) % num_shards


def _num_buckets(cfg: KmerConfig, num_shards: int) -> int:
    return num_shards * cfg.avg_buckets_per_shard


def _global_stats(counts: np.ndarray, overflow: bool, dev, group):
    """One all-reduce (SUM) of the rank's per-destination counts and its
    overflow flag: the global per-destination totals, and whether any
    rank overflowed."""
    stats = torch.from_numpy(np.append(counts, int(overflow)).astype(np.int64))
    stats = stats.to(group_mod.collective_device(dev, group))
    dist.all_reduce(stats, group=group)
    host = stats.cpu().numpy()
    return host[:-1], bool(host[-1] > 0)


def _bucketed_exchange(valid, dest, words, payloads, num_shards: int,
                       capacity: int, group):
    """The bucketed routes' exchange: pack the valid slots by destination
    (exchange.pack_by_destination), then the global stats, so that on an
    overflow every rank returns before the exchange, (None, totals, True);
    else the received rows flattened, key rows with the sentinel past each
    source's count, then payload rows: (rows, totals, False)."""
    send, counts, overflow = exchange.pack_by_destination(
        valid, dest, words, payloads, num_shards, capacity)
    totals, overflow = _global_stats(counts, overflow, send.device, group)
    if overflow:
        return None, totals, True
    recv, _, recv_valid = exchange.all_to_all_exchange(send, counts, group)
    del send
    n_words = len(words)
    rows = exchange.mask_invalid_slots(
        [recv[:, r] for r in range(n_words)], recv_valid)
    rows = [w.reshape(-1) for w in rows]
    rows += [recv[:, r].reshape(-1) for r in range(n_words, recv.shape[1])]
    return rows, totals, False


def _shard_body_bucketed(codes, valid, *, assign, cfg: KmerConfig,
                         num_shards: int, capacity: int, group=None):
    """Bucketed per-rank program (minimizer or kmer_hash routing, with or
    without the combiner): pack by destination, exchange, sort the received
    rows, count. `assign` is the (buckets,) bucket -> rank table on the
    device under minimizer routing, else None. Returns as _shard_body_range.

    The combiner pre-aggregates local duplicates by one local sort and
    count. Under minimizer routing the JAX version sorts [bucket, *words]
    because the minimizer is positional and lost by the sort; here the
    bucket rides the sort as a payload instead (7 rows at K > 80 where a
    leading key word would need 7 key words): equal keys share their
    minimizer, so each run's head carries its bucket.
    """
    words = keybuild.canonical_keys_fused(codes, valid, cfg.k)
    bucket = None
    if cfg.routing == "minimizer":
        bucket = minimizer.kmer_destinations(
            codes, cfg.k, cfg.m, _num_buckets(cfg, num_shards))
    sent, payloads = valid, []  # the slots to send, with their payload rows
    if cfg.combiner:
        words, pay_s = radix_sort.sort_words(
            words, [bucket] if bucket is not None else [])
        local_cnt, sent = fused_count.run_length_count_filter(words, 1, 2**31 - 1)
        bucket = pay_s[0] if bucket is not None else None
        payloads = [local_cnt]
    if bucket is not None:
        dest = assign[bucket.to(torch.int64)]
    else:
        dest = _hash_destinations(words, num_shards)
    del bucket
    rows, totals, overflow = _bucketed_exchange(sent, dest, words, payloads,
                                                num_shards, capacity, group)
    del words, dest, sent, payloads
    if overflow:
        return None, None, None, totals, True
    words_s, pay_s = radix_sort.sort_words(rows[:cfg.words], rows[cfg.words:])
    del rows
    if cfg.combiner:
        head, cnt = run_length_sum.run_length_sum_fused(words_s, pay_s[0])
        keep = count_ops.frequency_filter(head, cnt, *_bounds(cfg))
    else:
        cnt, keep = _count_merged(words_s, cfg)
    return words_s, cnt, keep, totals, False


def _bucket_sizes(codes, valid, cfg: KmerConfig, num_shards: int, group):
    """Valid k-mers per minimizer bucket: the (S, buckets) matrix of every
    rank's local sizes, by one all_gather, and the global totals (its
    column sums, what the JAX version all-reduces). The totals are the
    dispatcher's input (reference Reduce of task sizes,
    src/kmerops.cpp:1157-1199); the local matrix gives the exact
    per-(source, destination) maxima of the assignment."""
    num_buckets = _num_buckets(cfg, num_shards)
    bucket = minimizer.kmer_destinations(codes, cfg.k, cfg.m, num_buckets)
    sizes = dispatch.bucket_sizes_device(bucket, valid, num_buckets)
    sizes = sizes.to(group_mod.collective_device(codes.device, group))
    local = [torch.empty_like(sizes) for _ in range(num_shards)]
    dist.all_gather(local, sizes, group=group)
    local = torch.stack(local).cpu().numpy().astype(np.int64)
    return local.sum(axis=0), local


def plan_sharded_step(codes, valid, cfg: KmerConfig, num_shards: int,
                      n_local: int, group=None):
    """(cfg, assign, capacity, measured) for a step on this rank's block.

    Range routing needs no measurement pass: the full-avalanche mix makes
    per-(src, dst) loads uniform, so the capacity rule with the overflow
    protocol suffices, and the classifier reads the totals the main pass
    returns. Minimizer routing under the balanced dispatcher measures the
    bucket sizes (the dispatcher's input) and with them the exact
    per-(source, destination) maxima of its assignment, so its capacity
    cannot overflow (measured=True). Round-robin and kmer_hash size the
    exchange by capacity_factor. `assign` is the bucket -> rank table on
    the device (minimizer routing) or None. Every rank computes the same
    plan: the assignment is a deterministic function of the all-gathered
    sizes."""
    factor_capacity = _factor_capacity(n_local, num_shards, cfg)
    if cfg.routing == "range":
        return cfg, None, range_capacity(n_local, num_shards, cfg), False
    if cfg.routing != "minimizer":  # kmer_hash, and supermer's flat blocks
        return cfg, None, factor_capacity, False
    num_buckets = _num_buckets(cfg, num_shards)
    if cfg.dispatcher == "round_robin":
        assign = dispatch.round_robin_assignment(num_buckets, num_shards)
        return cfg, torch.from_numpy(assign).to(codes.device), factor_capacity, False
    totals, local = _bucket_sizes(codes, valid, cfg, num_shards, group)
    assign = dispatch.balanced_assignment(totals, num_shards)
    onehot = np.zeros((num_buckets, num_shards), dtype=np.int64)
    onehot[np.arange(num_buckets), assign] = 1
    # With the combiner on, entries are distinct keys, at most these raw
    # counts: still an upper bound.
    capacity = max(int((local @ onehot).max()), 64)
    return cfg, torch.from_numpy(assign).to(codes.device), capacity, True


def _step_body(cfg: KmerConfig, assign):
    if cfg.routing == "range":
        return _shard_body_range_combiner if cfg.combiner else _shard_body_range
    return functools.partial(_shard_body_bucketed, assign=assign)


def _heavy_pending(cfg: KmerConfig) -> bool:
    """Whether the classifier reads a pass's totals: the range route
    without the combiner (never in extension mode, which has none)."""
    return (cfg.routing == "range" and not cfg.combiner
            and cfg.classifier == "heavy_hitter" and not cfg.extension)


def _run_passes(codes, valid, plan, num_shards: int, group, classify: bool = False):
    """One route's passes with the overflow protocol: the capacity doubles
    after a pass that overflowed, up to _ATTEMPTS passes; an overflow under
    a measured capacity is an error. With `classify`, a heavy destination
    in a pass's totals returns None (the caller re-runs through the
    combiner) before its overflow flag is read, as the JAX counting loops
    do. Returns ((words, cnt, keep) or None, the plan with the capacity
    that last ran)."""
    cfg, assign, capacity, measured = plan
    body = _step_body(cfg, assign)
    for _ in range(_ATTEMPTS):
        words, cnt, keep, totals, overflow = body(
            codes, valid, cfg=cfg, num_shards=num_shards, capacity=capacity,
            group=group,
        )
        if classify and (
                dispatch.classify(totals, cfg.heavy_ratio) == dispatch.HEAVY).any():
            return None, (cfg, assign, capacity, measured)
        if not overflow:
            return (words, cnt, keep), (cfg, assign, capacity, measured)
        if measured:
            raise RuntimeError("overflow under exactly-measured capacity")
        capacity *= 2
    raise RuntimeError("exchange capacity overflow after retries")


def _with_combiner(plan):
    return (dataclasses.replace(plan[0], combiner=True),) + tuple(plan[1:])


def _count_step(codes, valid, cfg: KmerConfig, n_local: int, group):
    """The step's route, then the combiner if the classifier flags a heavy
    destination (or at once under cfg.combiner)."""
    num_shards = dist.get_world_size(group)
    plan = plan_sharded_step(codes, valid, cfg, num_shards, n_local, group)
    result, plan = _run_passes(codes, valid, plan, num_shards, group,
                               classify=_heavy_pending(cfg))
    if result is None:
        result, _ = _run_passes(codes, valid, _with_combiner(plan), num_shards, group)
    return result


def _all_gather_rows(rows: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's (m_r, C) int32 rows, in rank order, on the host
    (_gather_rows, copied out)."""
    return [p.cpu() for p in _gather_rows(rows, group)]


def _gather_rows(rows: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's (m_r, C) int32 rows, in rank order, where `rows` lies
    (the collective's device): the sizes first, then one all_gather of rows
    padded to the largest."""
    num_shards = dist.get_world_size(group)
    size = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    sizes = [torch.empty_like(size) for _ in range(num_shards)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in torch.cat(sizes).cpu()]
    longest = max(max(sizes), 1)
    padded = torch.zeros((longest, rows.shape[1]), dtype=rows.dtype,
                         device=rows.device)
    padded[: rows.shape[0]] = rows
    parts = [torch.empty_like(padded) for _ in range(num_shards)]
    dist.all_gather(parts, padded, group=group)
    return [p[:m] for p, m in zip(parts, sizes)]


def _unmixed(keys: torch.Tensor, mixed: bool) -> torch.Tensor:
    """(m, W) int32 key rows, unmixed where they lie (mixkey.unmix_keys)
    if they are in the mixed key space (range routing)."""
    if not mixed:
        return keys
    return torch.stack(mixkey.unmix_keys(keys.unbind(1)), dim=1)


def _rank_rows(keys_dev, mixed: bool) -> np.ndarray:
    """(m, W) int32 key rows on the device -> (m, W) uint32 host keys,
    unmixed on the device first where they are mixed (_unmixed)."""
    return to_host(_unmixed(keys_dev, mixed)).view(np.uint32)


def _rank_list(words, cnt, keep, cfg: KmerConfig, mixed: bool) -> KmerList:
    """The rank's kept rows as its KmerList, keys unmixed on the device where
    `mixed` (range routing)."""
    with stage("result", keep.device):
        idx = torch.nonzero(keep).squeeze(1)
        keys = _rank_rows(torch.stack([w[idx] for w in words], dim=-1), mixed)
        return KmerList(keys=keys, counts=cnt[idx].cpu().numpy(), k=cfg.k)


def _empty_list(cfg: KmerConfig) -> KmerList:
    """A rank's list where no rank saw a batch."""
    return KmerList(np.zeros((0, cfg.words), np.uint32), np.zeros(0, np.int32), cfg.k)


def _gather_list(kmerlist: KmerList, group, dev) -> KmerList:
    """Every rank's list, in rank order, on every rank: one all_gather of
    (key words, count) int32 rows."""
    with stage("result", dev):
        rows = np.concatenate([kmerlist.keys.view(np.int32),
                               kmerlist.counts[:, None]], axis=1)
        cdev = group_mod.collective_device(dev, group)
        every = torch.cat(_all_gather_rows(torch.from_numpy(rows).to(cdev), group)).numpy()
    return KmerList(
        keys=np.ascontiguousarray(every[:, :-1]).view(np.uint32),
        counts=np.ascontiguousarray(every[:, -1]),
        k=kmerlist.k,
    )


def _every_rank(kmerlist: KmerList, cfg: KmerConfig, group, dev):
    """What the entries on global reads return: every rank's list in rank
    order (_gather_list) and its histogram."""
    kmerlist = _gather_list(kmerlist, group, dev)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def _gather_result(words, cnt, keep, cfg: KmerConfig, group, mixed: bool):
    """The rank's kept rows (_rank_list), then every rank's list and its
    histogram (_every_rank)."""
    return _every_rank(_rank_list(words, cnt, keep, cfg, mixed), cfg, group, keep.device)


def count_flat_sharded(
    codes: np.ndarray,
    valid: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Sharded entry on flat global (codes, valid), whose length must divide
    by the rank count: rank r counts slice r. Every rank returns the whole
    (KmerList, histogram). Under routing="supermer" the slices take the
    kmer_hash destination, as in the JAX package, which has no supermer
    branch here."""
    dev = group_mod.rank_device(device)
    num_shards = dist.get_world_size(group)
    n = codes.shape[0]
    if n % num_shards:
        raise ValueError(f"{n} slots do not divide among {num_shards} ranks")
    n_local = n // num_shards
    mine = slice(dist.get_rank(group) * n_local, (dist.get_rank(group) + 1) * n_local)
    codes_d = torch.from_numpy(np.asarray(codes[mine], dtype=np.int8)).to(dev)
    valid_d = torch.from_numpy(np.asarray(valid[mine], dtype=bool)).to(dev)
    words, cnt, keep = _count_step(codes_d, valid_d, cfg, n_local, group)
    return _gather_result(words, cnt, keep, cfg, group, cfg.routing == "range")


def _partition_bounds(lengths: np.ndarray, num_shards: int) -> list[int]:
    """The S + 1 read-index bounds of partition_read_indices' contiguous
    groups, by S - 1 vectorized searches instead of a Python loop over the
    reads (0.1-0.2 s at 447,392 reads). Shard s + 1 starts at the first
    read i after shard s's start a whose preceding bases in the shard,
    acc = C[i] - C[a] (C the exclusive cumulative sum), satisfy acc > 0 and
    acc + len[i] / 2 > total / S: the loop's test, with the same float64
    operations."""
    lengths = np.asarray(lengths)
    n = lengths.shape[0]
    csum = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    target = int(csum[-1]) / num_shards
    bounds, a = [0], 0
    for _ in range(num_shards - 1):
        if a < n:
            acc = csum[a + 1: n] - csum[a]
            hit = np.flatnonzero((acc > 0) & (acc + lengths[a + 1:] / 2 > target))
            a = a + 1 + int(hit[0]) if hit.size else n
        bounds.append(a)
    bounds.append(n)
    return bounds


def partition_read_indices(
    lengths: np.ndarray, num_shards: int
) -> list[list[int]]:
    """Greedy contiguous split of read indices balancing total bases —
    the in-memory analogue of the reference's getpartition
    (fastaindex.cpp:52-100)."""
    b = _partition_bounds(lengths, num_shards)
    return [list(range(b[s], b[s + 1])) for s in range(num_shards)]


def _shard_reads(codes: np.ndarray, lengths: np.ndarray, num_shards: int):
    """Per shard: (codes, int32 lengths, first read index) of its reads. A
    shard's reads are contiguous, so its codes are one slice (views)."""
    offsets = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    b = _partition_bounds(lengths, num_shards)
    return [(codes[offsets[lo]: offsets[hi]],
             np.asarray(lengths[lo:hi]).astype(np.int32), lo)
            for lo, hi in zip(b[:-1], b[1:])]


def _rank_share(codes: np.ndarray, lengths: np.ndarray, group):
    """This rank's share of the global reads: (codes, int32 lengths, index
    of its first read)."""
    return _shard_reads(codes, lengths, dist.get_world_size(group))[dist.get_rank(group)]


def distribute_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Split reads into `num_shards` base-balanced groups
    (fastaindex.cpp:52-100) and build one equal-size flat (codes, valid)
    block per shard, concatenated."""
    blocks = [fasta_io.flatten_for_device(c, l, cfg.k, cfg.pad_multiple)
              for c, l, _ in _shard_reads(codes, lengths, num_shards)]
    block_len = max(b[0].shape[0] for b in blocks)
    out_codes = np.zeros((num_shards, block_len), dtype=np.int8)
    out_valid = np.zeros((num_shards, block_len), dtype=bool)
    for s, (c, v) in enumerate(blocks):
        out_codes[s, : c.shape[0]] = c
        out_valid[s, : v.shape[0]] = v
    return out_codes.reshape(-1), out_valid.reshape(-1)


def _wire_dims(shards, cfg: KmerConfig, min_block_len: int = 0,
               min_lmax: int = 1) -> tuple[int, int]:
    """(block_len, lmax) shared by every shard: block_len a multiple of 16
    and cfg.pad_multiple with at least 16 spare slots, lmax the most reads
    of a shard."""
    gran = int(np.lcm(16, cfg.pad_multiple))
    raw = max(max(c.shape[0] for c, _, _ in shards) + 16, gran, min_block_len)
    lmax = max(max(l.shape[0] for _, l, _ in shards), 1, min_lmax)
    return -(-raw // gran) * gran, lmax


def _pack_shard(codes: np.ndarray, lens: np.ndarray, block_len: int,
                lmax: int) -> tuple[np.ndarray, np.ndarray]:
    """One shard in wire format: (block_len/16,) uint32 words, (lmax,)
    int32 zero-padded read lengths."""
    words = supermer_io.pack_codes_2bit_into(codes, np.empty(block_len // 16, np.uint32))
    l = np.zeros(lmax, dtype=np.int32)
    l[: lens.shape[0]] = lens
    return words, l


def distribute_reads_packed(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
    read_id_offset: int = 0,
    min_block_len: int = 0,
    min_lmax: int = 1,
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Base-balanced per-shard blocks in wire format, every shard.

    Returns (packed (S * block_len/16,) uint32, lengths2d (S, lmax) int32,
    block_len, rid_base (S,) int32 — the global id of each shard's first
    read). count_reads_sharded packs only its own rank's block.
    """
    shards = _shard_reads(codes, lengths, num_shards)
    block_len, lmax = _wire_dims(shards, cfg, min_block_len, min_lmax)
    packed = np.zeros((num_shards, block_len // 16), dtype=np.uint32)
    lens2d = np.zeros((num_shards, lmax), dtype=np.int32)
    rid_base = np.zeros(num_shards, dtype=np.int32)
    for s, (c, l, first) in enumerate(shards):
        packed[s], lens2d[s] = _pack_shard(c, l, block_len, lmax)
        rid_base[s] = read_id_offset + first
    return packed.reshape(-1), lens2d, block_len, rid_base


def _rank_wire(codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig, group,
               dev, min_dims: tuple[int, int] = (0, 1)):
    """The rank's reads as its block in wire format, on the device: (packed
    words, read lengths, block_len), fed through pipeline.feed_wire (pinned
    staging on CUDA). The dims are the most of any rank (one all-reduce MAX,
    as the JAX multi-process entries all-gather them; for shares of one
    partition, what a mesh computes from every shard), pinned from below by
    min_dims, as the JAX streaming callers do."""
    with stage("pack", dev):
        lengths = np.asarray(lengths)
        dims = _wire_dims([(codes, lengths, 0)], cfg, *min_dims)
        block_len, lmax = (int(d) for d in
                           _all_reduce_host(dims, dist.ReduceOp.MAX, dev, group))
        return (*feed_wire(codes, lengths, block_len, dev, lmax), block_len)


def _share_batches(codes: np.ndarray, lengths: np.ndarray, batch_bases: int, group):
    """The streaming batches of the global reads, the same on every rank
    (runtime/scheduler.read_batch_spans), each cut to this rank's share:
    (codes, lengths, global index of the share's first read)."""
    offsets = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    for s, e in read_batch_spans(np.asarray(lengths), batch_bases):
        c, l, first = _rank_share(codes[offsets[s]: offsets[e]], lengths[s:e], group)
        yield c, l, s + first


def _own_batches(codes: np.ndarray, lengths: np.ndarray, batch_bases: int, dev, group,
                 first: int = 0):
    """The streaming batches of a rank's own reads, the first of them the
    global read `first`: (codes, lengths, global index of the batch's first
    read). The batch count is the most of any rank (one all-reduce MAX): a
    rank that runs out feeds empty batches, so that every rank runs the same
    collectives (the JAX multi-process streaming loops)."""
    spans = read_batch_spans(np.asarray(lengths), batch_bases)
    (nb,) = _all_reduce_host([len(spans)], dist.ReduceOp.MAX, dev, group)
    offsets = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    for i in range(int(nb)):
        s, e = spans[i] if i < len(spans) else (0, 0)
        yield codes[offsets[s]: offsets[e]], lengths[s:e], first + s


def count_reads_sharded(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers across the ranks of `group` (default: the
    default group). Every rank is given the same global reads, computes the
    same partition and wire dims, packs and uploads only its own block
    (~2 bits/base + 4 B/read, ops/wire.py), runs the step, and returns the
    whole (KmerList, histogram). `device` as in group.rank_device: the
    rank's CUDA device unless the caller asks for the CPU.

    Every routing but supermer takes the wire here; the JAX package feeds
    the routes other than range (and the combiner) flat blocks
    (distribute_reads -> count_flat_sharded), which gives the same result.
    routing="supermer" goes to supermer_route.count_reads_supermer."""
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer(codes, lengths, cfg, group, device)
    dev = group_mod.rank_device(device)
    mine, lens, _ = _rank_share(codes, lengths, group)
    return _every_rank(_count_rank(mine, lens, cfg, group, dev), cfg, group, dev)


def _count_rank(codes, lengths, cfg: KmerConfig, group, dev) -> KmerList:
    """The rank's own reads -> its block on the wire -> the step -> its
    share of the filtered list (every routing but supermer)."""
    packed, lens, block_len = _rank_wire(codes, lengths, cfg, group, dev)
    codes_d, valid_d = wire.decode_block(packed, lens, cfg.k, block_len)
    del packed, lens
    with stage("step", dev):
        words, cnt, keep = _count_step(codes_d, valid_d, cfg, block_len, group)
    return _rank_list(words, cnt, keep, cfg, cfg.routing == "range")


# --------------------------------------------------------------------------
# Sharded streaming: bounded device memory at any input size. Device batches
# stream through the step with an UNFILTERED count (every distinct key
# survives, the per-batch combiner idea of ScatteredKmerList,
# src/kmerops.cpp:363-417); each rank keeps its compacted partial (key,
# count) lists in host memory, and a final pass merges them per rank with
# no exchange: the routing is fixed for the stream, so a key's owner never
# moves (the reference's bounded round loop, src/kmerops.cpp:906-1007).


def _merge_partials(parts, cfg: KmerConfig, dev):
    """A rank's R partial lists (each ascending, from sorted batch output)
    -> (words, total, keep): one merge of the R runs at their exact bounds
    (ops/merge.merge_runs_at), the weighted run-length sum of the partial
    counts, the [L, U] filter on the totals."""
    w = cfg.words
    with stage("merge", dev):
        rows = [torch.cat([p[0][i] for p in parts]).to(dev) for i in range(w)]
        rows.append(torch.cat([p[1] for p in parts]).to(dev))
        bounds = np.cumsum([0] + [p[1].shape[0] for p in parts])
        if bounds[-1]:
            rows = merge_ops.merge_runs_at(rows, w, bounds)
        head, total = run_length_sum.run_length_sum_fused(rows[:w], rows[w])
        keep = count_ops.frequency_filter(head, total, cfg.lower, cfg.upper)
    return rows[:w], total, keep


def count_reads_sharded_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    group=None,
    device="cuda",
    async_depth=None,
) -> tuple[KmerList, np.ndarray]:
    """Bounded-memory counting across the ranks of `group`: peak device
    memory is set by batch_bases (plus a rank's merged partials at the
    end), not by the input size. Equal to count_reads_sharded.

    Every rank cuts the same batches (runtime/scheduler.read_batch_spans
    on the global lengths), so every rank runs the same passes and
    collectives, with or without reads of its own in a batch. The route is
    planned on batch 0 and kept for the stream: the minimizer assignment,
    and the combiner if the classifier flags batch 0's totals; a later
    batch that overflows (a skew batch 0 did not show, or a measured
    capacity outgrown) re-runs on every rank at twice the capacity, which
    later batches keep.

    async_depth is accepted for parity with the JAX signature: there it is
    the number of batches in flight on the asynchronous dispatch. Here
    each batch settles, first in first out, before the next starts (the
    exchange reads its overflow flag on the host), so it changes nothing.
    routing="supermer" goes to supermer_route.count_reads_supermer_streaming.
    """
    if cfg.extension:
        raise ValueError("use count_reads_sharded_ext_streaming for extension mode")
    if async_depth is not None and async_depth < 1:
        raise ValueError(f"async_depth must be at least 1, got {async_depth}")
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer_streaming(
            codes, lengths, cfg, batch_bases, group, device, async_depth)
    dev = group_mod.rank_device(device)
    batches = _share_batches(codes, lengths, batch_bases, group)
    return _every_rank(_count_rank_streaming(batches, cfg, group, dev), cfg, group, dev)


def _count_rank_streaming(batches, cfg: KmerConfig, group, dev) -> KmerList:
    """The streaming driver (every routing but supermer) on the rank's
    batches, (codes, lengths, first read) of its own reads in each, as many
    on every rank (_share_batches, _own_batches). Returns the rank's share
    of the filtered list."""
    num_shards = dist.get_world_size(group)
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    plan = None
    parts = []
    for b_codes, b_lengths, _ in batches:
        packed, lens, block_len = _rank_wire(b_codes, b_lengths, cfg, group, dev)
        codes_d, valid_d = wire.decode_block(packed, lens, cfg.k, block_len)
        del packed, lens
        with stage("step", dev):
            classify = False
            if plan is None:
                plan = plan_sharded_step(codes_d, valid_d, cfg_pre, num_shards,
                                         block_len, group)
                # A measured capacity is exact for batch 0 only: later
                # batches double it on an overflow, as the JAX stream does.
                plan = plan[:3] + (False,)
                classify = _heavy_pending(cfg_pre)
            result, plan = _run_passes(codes_d, valid_d, plan, num_shards, group,
                                       classify)
            if result is None:
                plan = _with_combiner(plan)
                result, plan = _run_passes(codes_d, valid_d, plan, num_shards, group)
            words, cnt, keep = result
            idx = torch.nonzero(keep).squeeze(1)
            parts.append(([w[idx].cpu() for w in words], cnt[idx].cpu()))
        del codes_d, valid_d, words, cnt, keep, result, idx
    if plan is None:  # no reads: no rank saw a batch
        return _empty_list(cfg)
    words, total, keep = _merge_partials(parts, cfg, dev)
    return _rank_list(words, total, keep, cfg, plan[0].routing == "range")


# --------------------------------------------------------------------------
# Extension mode: (ReadId, PosInRead) through the exchange, the reference's
# EXTENSION wire format (include/kmer.hpp:346-360). There is no combiner in
# extension mode, as in the reference (src/kmerops.cpp:109-113).


def _shard_body_ext_range(codes, valid, rid, pos, *, cfg: KmerConfig,
                          num_shards: int, capacity: int, group=None):
    """Extension range program: rid and pos ride the local sort, the
    exchange and the merge as payload rows. Extension mode keeps the
    power-of-two capacity of range_capacity. Returns (words, cnt, keep,
    rid, pos, dest_totals, overflow); the first five are None on an
    overflow."""
    if capacity & (capacity - 1):
        raise ValueError(f"extension range exchange needs a power-of-two "
                         f"capacity, got {capacity}")
    mixed_s, payl_s = radix_sort.sort_words(
        _build_marked_mixed(codes, valid, cfg), [rid, pos])
    merged_w, merged_p, totals, overflow = _range_exchange_merge(
        mixed_s, payl_s, valid.sum(), cfg, num_shards, capacity, group
    )
    if overflow:
        return None, None, None, None, None, totals, True
    del mixed_s, payl_s
    cnt, keep = _count_merged(merged_w, cfg)
    return merged_w, cnt, keep, merged_p[0], merged_p[1], totals, False


def _shard_body_ext_bucketed(codes, valid, rid, pos, *, cfg: KmerConfig,
                             num_shards: int, capacity: int, group=None):
    """Extension under the bucketed routings: the kmer_hash destination,
    which the JAX package uses for every bucketed routing in extension
    mode. Returns as _shard_body_ext_range."""
    words = keybuild.canonical_keys_fused(codes, valid, cfg.k)
    rows, totals, overflow = _bucketed_exchange(
        valid, _hash_destinations(words, num_shards), words, [rid, pos],
        num_shards, capacity, group)
    del words
    if overflow:
        return None, None, None, None, None, totals, True
    words_s, (rid_s, pos_s) = radix_sort.sort_words(rows[:cfg.words],
                                                   rows[cfg.words:])
    del rows
    cnt, keep = _count_merged(words_s, cfg)
    return words_s, cnt, keep, rid_s, pos_s, totals, False


def build_ext_blocks(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    num_shards: int,
    read_id_offset: int = 0,
    min_block_len: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Per-shard equal-size (codes, valid, rid, pos) blocks for extension
    mode: (S, block_len) int8, bool, int32, uint32, and block_len: the JAX
    package's feed of its bucketed extension routes. The port's routes take
    the wire (`_count_rank_ext`); this stays for the parity tests."""
    blocks = [
        fasta_io.flatten_for_device_ext(c, l, cfg.k, cfg.pad_multiple,
                                        read_id_offset + first)
        for c, l, first in _shard_reads(codes, lengths, num_shards)
    ]
    block_len = max(max(b[0].shape[0] for b in blocks), min_block_len)
    sc = np.zeros((num_shards, block_len), dtype=np.int8)
    sv = np.zeros((num_shards, block_len), dtype=bool)
    sr = np.zeros((num_shards, block_len), dtype=np.int32)
    sp = np.zeros((num_shards, block_len), dtype=np.uint32)
    for s, (c, v, r, p) in enumerate(blocks):
        sc[s, : c.shape[0]] = c
        sv[s, : v.shape[0]] = v
        sr[s, : r.shape[0]] = r
        sp[s, : p.shape[0]] = p
    return sc, sv, sr, sp, block_len


def batch_spans(lengths: np.ndarray, batch_bases: int) -> list[tuple[int, int]]:
    """Read-index spans of the streaming batches: THE batching rule
    (runtime/scheduler.read_batch_spans)."""
    return read_batch_spans(lengths, batch_bases)


def ext_stream_dims(
    lengths: np.ndarray, batch_bases: int, cfg: KmerConfig, num_shards: int
) -> tuple[int, int]:
    """Exact (block_len, lmax) upper bounds of the wire blocks over every
    streaming batch, from the lengths alone; the stream pins its blocks to
    them from below (the JAX stream compiles once so)."""
    gran = int(np.lcm(16, cfg.pad_multiple))
    max_raw, max_lmax = gran, 1
    lengths = np.asarray(lengths)
    for s, e in batch_spans(lengths, batch_bases):
        l = lengths[s:e]
        csum = np.concatenate([[0], np.cumsum(l, dtype=np.int64)])
        b = _partition_bounds(l, num_shards)
        for lo, hi in zip(b[:-1], b[1:]):
            if hi > lo:
                max_raw = max(max_raw, int(csum[hi] - csum[lo]) + 16)
                max_lmax = max(max_lmax, hi - lo)
    return -(-max_raw // gran) * gran, max_lmax


def _ext_rows(words, cnt, keep, rid_s, pos_s, mixed: bool) -> ExtPartial:
    """The rank's kept keys and counts and their occurrences as an
    ExtPartial on the device (kept_partial), keys unmixed there where
    `mixed` (its rows then stay in mixed-key order, not ascending)."""
    with stage("result", keep.device):
        part, _ = kept_partial(words, cnt, keep, rid_s, pos_s)
        return dataclasses.replace(part, keys=_unmixed(part.keys, mixed),
                                   ascending=not mixed)


def _ext_list(part: ExtPartial, k: int) -> KmerListExt:
    """A partial's rows and occurrences, in its order, as a host KmerListExt
    (one `to_host` an array; the counts' prefix sums are its offsets)."""
    with stage("result"):
        return part.to_host(k)


def _gather_ext(part: ExtPartial, group, dev) -> ExtPartial:
    """Every rank's _ext_rows in rank order (two all_gathers), as one
    ExtPartial where the collectives leave it: on this rank's card under
    NCCL, on the host under gloo (a stream's ExtPartialStore uploads it
    once, a one-shot result needs no copy out)."""
    cdev = group_mod.collective_device(dev, group)
    with stage("result", dev):
        rows = torch.cat([part.keys, part.counts[:, None]], dim=1).to(cdev)
        occ = torch.stack([part.occ_rid, part.occ_pos], dim=1).to(cdev)
        rows = torch.cat(_gather_rows(rows, group))
        occ = torch.cat(_gather_rows(occ, group))
    one_rank = dist.get_world_size(group) == 1
    return ExtPartial(rows[:, :-1].contiguous(), rows[:, -1].contiguous(),
                      occ[:, 0].contiguous(), occ[:, 1].contiguous(),
                      ascending=part.ascending and one_rank)


def count_reads_sharded_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
    read_id_offset: int = 0,
    min_dims: tuple[int, int] = (0, 1),
) -> tuple[KmerListExt, np.ndarray]:
    """Extension mode across the ranks of `group`: every k-mer's (read id,
    position) occurrences; read ids count from read_id_offset. Under every
    routing the feed is the 2-bit wire and (rid, pos) are derived on the
    device from the read lengths (ops/wire.decode_block_ext); the JAX
    package feeds the bucketed routings flat blocks (build_ext_blocks),
    which gives the same result. min_dims pins
    (block_len, lmax) from below (the streaming caller's ext_stream_dims).
    Every rank returns the whole (KmerListExt, histogram), copied out of
    the gathered tensors once (_ext_list).
    routing="supermer" goes to supermer_route.count_reads_supermer_ext."""
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.count_reads_supermer_ext(
            codes, lengths, cfg, group, device, read_id_offset, min_dims)
    kl = _ext_list(_sharded_ext_partial(codes, lengths, cfg, group, device,
                                        read_id_offset, min_dims), cfg.k)
    return kl, host_histogram(kl.counts, cfg.upper)


def _sharded_ext_partial(codes, lengths, cfg: KmerConfig, group, device,
                         read_id_offset: int, min_dims) -> ExtPartial:
    """count_reads_sharded_ext's list before it becomes a host list: every
    rank's rows in rank order (_gather_ext; the supermer route's through
    supermer_route.supermer_ext_partial)."""
    if cfg.routing == "supermer":
        from . import supermer_route

        return supermer_route.supermer_ext_partial(codes, lengths, cfg, group, device,
                                                   read_id_offset, min_dims)
    dev = group_mod.rank_device(device)
    mine, lens, first = _rank_share(codes, lengths, group)
    return _gather_ext(_count_rank_ext(mine, lens, cfg, group, dev, read_id_offset + first,
                                       min_dims), group, dev)


def _count_rank_ext(codes, lengths, cfg: KmerConfig, group, dev, read_id_offset: int,
                    min_dims) -> ExtPartial:
    """Extension mode on the rank's own reads, read ids from read_id_offset
    (every routing but supermer): its block over the wire, (rid, pos)
    derived on the device from the read lengths; its share as _ext_rows."""
    num_shards = dist.get_world_size(group)
    packed, lens, block_len = _rank_wire(codes, lengths, cfg, group, dev, min_dims)
    inputs = wire.decode_block_ext(packed, lens, cfg.k, block_len, read_id_offset)
    del packed, lens
    capacity = _factor_capacity(block_len, num_shards, cfg)
    if cfg.routing == "range":
        body = _shard_body_ext_range
        capacity = _next_pow2(capacity)
    else:
        body = _shard_body_ext_bucketed
    with stage("step", dev):
        (words, cnt, keep, rid_s, pos_s, _), _ = run_with_capacity_retry(
            lambda cap: body(*inputs, cfg=cfg, num_shards=num_shards, capacity=cap,
                             group=group),
            capacity, False,
        )
    del inputs
    return _ext_rows(words, cnt, keep, rid_s, pos_s, cfg.routing == "range")


def count_reads_sharded_ext_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    group=None,
    device="cuda",
    read_id_offset: int = 0,
) -> tuple[KmerListExt, np.ndarray]:
    """Bounded-memory extension mode across the ranks: each batch runs the
    sharded extension pass UNFILTERED, and the per-batch (key, count,
    occurrences) partials stay on the rank's device and merge there once
    (runtime/scheduler.ExtPartialStore; [L, U] applies to the merged totals
    only): the reference's bounded round loop, where nothing in the
    exchange is EXT-conditional (src/kmerops.cpp:906-1007). Every batch's
    whole list is gathered before the merge (_sharded_ext_partial, sorted
    by key as it is held): under routing="supermer" each batch plans its own
    assignment, so a key's owner can change between batches. The merge
    runs no collective, so a rank that drains to the host keeps in step."""
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    min_dims = ext_stream_dims(lengths, batch_bases, cfg,
                               dist.get_world_size(group))
    dev = group_mod.rank_device(device)
    store = ExtPartialStore(cfg, dev)
    rid_off = read_id_offset
    for b_codes, b_lengths in iter_read_batches(codes, lengths, batch_bases):
        store.add(_sharded_ext_partial(b_codes, b_lengths, cfg_pre, group, device,
                                       rid_off, min_dims))
        rid_off += b_lengths.size
    with stage("merge", dev):
        return store.result()
