"""Sharded k-mer counting over a torch.distributed process group: the range
exchange.

The port of hysortk_tpu/parallel/pipeline.py's default route
(`count_reads_sharded` with routing="range", its packed-wire entry
`multihost._count_multihost_packed`, and the heavy-hitter combiner). Each
rank is one process with one device (parallel/group.py); per step, on
every rank:

  wire decode -> key build -> mix (ops/mixkey.py) -> ONE local sort
  -> contiguous per-destination segments -> all_to_all_single
  -> run merge of the S received runs -> count + [L,U] filter
  -> compact -> unmix on the host -> all ranks' lists gathered

Because the mixed sort key doubles as the routing key, a step costs one
local sort plus a merge of the S received sorted runs. The ownership rule:
dest = range of the mixed first word, uniform even on skewed genomes; equal
keys mix equally, so they land together.

The classifier (cfg.classifier == "heavy_hitter") reads the global
per-destination totals that every pass computes anyway; a destination
heavier than heavy_ratio x mean, which under a keyed routing can only come
from duplicate k-mers, re-runs the step through the combiner, where each
rank pre-aggregates its local duplicates and exchanges (key, partial count)
entries (reference ScatteredKmerList, src/kmerops.cpp:363-417).

The result equals the JAX package's count_reads_sharded on a mesh of as
many devices as there are ranks: keys in rank order, then mixed-key order,
with the same counts and histogram. Every rank returns the whole list.
Routings other than "range", sharded streaming and sharded extension mode
are not ported yet (slice C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import KmerConfig
from ..io import fasta as fasta_io
from ..io import supermer as supermer_io
from ..ops import count as count_ops
from ..ops import fused_count
from ..ops import keybuild
from ..ops import merge as merge_ops
from ..ops import mixkey
from ..ops import radix_sort
from ..ops import run_length_sum
from ..ops import wire
from ..pipeline import KmerList, host_histogram
from . import dispatch
from . import exchange
from . import group as group_mod

UNPORTED = "is not ported yet (slice C of the multi-device port)"
_ATTEMPTS = 6  # passes per route before an overflow is an error, as in JAX


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


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
        return _next_pow2(
            max(int(n_local / num_shards * cfg.capacity_factor), 64)
        )
    mean = max(-(-n_local // num_shards), 128)
    return mean + max(mean >> 6, 64)


def _build_marked_mixed(codes, valid, cfg: KmerConfig) -> list[torch.Tensor]:
    """codes/valid -> sentinel-marked, invertibly-mixed key words."""
    marked = keybuild.canonical_keys_fused(codes, valid, cfg.k)
    return mixkey.mix_keys(marked)


def _bounds(cfg: KmerConfig) -> tuple[int, int]:
    return (1, 2**31 - 1) if cfg.unfiltered else (cfg.lower, cfg.upper)


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


def plan_sharded_step(
    cfg: KmerConfig, num_shards: int, n_local: int
) -> tuple[KmerConfig, int, bool]:
    """(cfg, capacity, measured) for a step. Range routing needs no
    measurement pass: the full-avalanche mix makes per-(src, dst) loads
    uniform, so the capacity rule with the overflow protocol suffices
    (measured=False), and the classifier reads the totals the main pass
    returns. The measured minimizer plan waits for that routing."""
    if cfg.routing != "range":
        raise NotImplementedError(f"routing={cfg.routing!r} across ranks {UNPORTED}")
    return cfg, range_capacity(n_local, num_shards, cfg), False


def _run_passes(codes, valid, cfg: KmerConfig, num_shards: int, n_local: int,
                group, classify: bool):
    """One route's passes with the overflow protocol: the capacity doubles
    after a pass that overflowed, up to _ATTEMPTS passes. With `classify`,
    a heavy destination in a pass's totals returns None (the caller re-runs
    through the combiner) before its overflow flag is read, as the JAX
    counting loops do. Returns (words, cnt, keep)."""
    cfg, capacity, measured = plan_sharded_step(cfg, num_shards, n_local)
    body = _shard_body_range_combiner if cfg.combiner else _shard_body_range
    for _ in range(_ATTEMPTS):
        words, cnt, keep, totals, overflow = body(
            codes, valid, cfg=cfg, num_shards=num_shards, capacity=capacity,
            group=group,
        )
        if classify and (
                dispatch.classify(totals, cfg.heavy_ratio) == dispatch.HEAVY).any():
            return None
        if not overflow:
            return words, cnt, keep
        if measured:
            raise RuntimeError("overflow under exactly-measured capacity")
        capacity *= 2
    raise RuntimeError("exchange capacity overflow after retries")


def _count_step(codes, valid, cfg: KmerConfig, n_local: int, group):
    """The default route, then the combiner if the classifier flags a heavy
    destination (or at once under cfg.combiner)."""
    num_shards = dist.get_world_size(group)
    result = None
    if not cfg.combiner:
        result = _run_passes(codes, valid, cfg, num_shards, n_local, group,
                             classify=cfg.classifier == "heavy_hitter")
    if result is None:
        result = _run_passes(codes, valid, dataclasses.replace(cfg, combiner=True),
                             num_shards, n_local, group, classify=False)
    return result


def _all_gather_rows(rows: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's (m_r, C) int32 rows, in rank order, on the host: the
    sizes first, then one all_gather of rows padded to the largest."""
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
    return [p[:m].cpu() for p, m in zip(parts, sizes)]


def _gather_result(words, cnt, keep, cfg: KmerConfig, group):
    """The rank's kept rows, unmixed on the host, then every rank's list in
    rank order, and the histogram of the whole list."""
    dev = words[0].device
    idx = torch.nonzero(keep).squeeze(1)
    keys = mixkey.unmix_keys_np(
        torch.stack([w[idx] for w in words], dim=-1).cpu().numpy().view(np.uint32)
    )
    rows = np.concatenate(
        [keys.view(np.int32), cnt[idx].cpu().numpy()[:, None]], axis=1
    )
    cdev = group_mod.collective_device(dev, group)
    parts = _all_gather_rows(torch.from_numpy(rows).to(cdev), group)
    every = torch.cat(parts).numpy()
    kmerlist = KmerList(
        keys=np.ascontiguousarray(every[:, :-1]).view(np.uint32),
        counts=np.ascontiguousarray(every[:, -1]),
        k=cfg.k,
    )
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def _check_ported(cfg: KmerConfig) -> None:
    if cfg.routing != "range":
        raise NotImplementedError(f"routing={cfg.routing!r} across ranks {UNPORTED}")
    if cfg.extension:
        raise NotImplementedError(f"extension mode across ranks {UNPORTED}")


def count_flat_sharded(
    codes: np.ndarray,
    valid: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Sharded entry on flat global (codes, valid), whose length must divide
    by the rank count: rank r counts slice r. Every rank returns the whole
    (KmerList, histogram)."""
    _check_ported(cfg)
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
    return _gather_result(words, cnt, keep, cfg, group)


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
    c = np.zeros(block_len, dtype=np.int8)
    c[: codes.shape[0]] = codes
    l = np.zeros(lmax, dtype=np.int32)
    l[: lens.shape[0]] = lens
    return supermer_io.pack_codes_2bit(c), l


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
    rank's CUDA device unless the caller asks for the CPU."""
    _check_ported(cfg)
    dev = group_mod.rank_device(device)
    shards = _shard_reads(codes, lengths, dist.get_world_size(group))
    block_len, lmax = _wire_dims(shards, cfg)
    mine, lens, _ = shards[dist.get_rank(group)]
    packed, lens = _pack_shard(mine, lens, block_len, lmax)
    codes_d, valid_d = wire.decode_block(
        torch.from_numpy(packed.view(np.int32)).to(dev),
        torch.from_numpy(lens).to(dev), cfg.k, block_len,
    )
    words, cnt, keep = _count_step(codes_d, valid_d, cfg, block_len, group)
    return _gather_result(words, cnt, keep, cfg, group)
