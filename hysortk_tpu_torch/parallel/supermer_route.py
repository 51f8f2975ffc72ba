"""Supermer routing across the ranks of a torch.distributed process group.

The port of hysortk_tpu/parallel/supermer_route.py. Keys never travel:
*supermers* do (maximal runs of consecutive k-mers in one read that share a
destination, shipped as a lengths array plus 2-bit packed bases, ~0.28
B/base), and each rank extracts and counts the k-mers it received
(prepare_supermer src/kmerops.cpp:23-127, SupermerEncoder :1096-1148,
exchange :587-643, receive-side parse :484-521). Equal canonical k-mers share their minimizer, hence their bucket
and their rank, so the ranks' result sets are disjoint.

One driver, the exchange, because a rank feeds only its own card. The JAX
package has two transports: count_reads_supermer, where one host encodes
every shard's stream and feeds each device directly with no all_to_all, and
count_reads_supermer_exchange, where each host encodes its own reads into S
per-destination segments and one all_to_all swaps them; one process on a
mesh of S devices gives the same result either way. Here a rank is a
process that drives one device, so the first cannot be built: every rank
is given the same global reads, takes its own base-balanced share (the
partition of parallel/pipeline._shard_reads), and routes that share's
supermers through ONE all_to_all. What the JAX multi-process branch shares
between hosts, every rank shares here:

  * an all-reduce (SUM) of the per-bucket k-mer counts: every rank sees the
    global sizes, computes the same classification (heavy buckets,
    cfg.classifier) and the same bucket -> rank assignment (balanced or
    round-robin dispatcher, BalancedDispatcher src/kmerops.cpp:1274-1327);
  * an all-reduce (MAX) of the segment dimensions, so that every
    (source, destination) segment has one padded shape;
  * an all-gather of the heavy buckets' pre-counted entries.

Per step, on every rank, all on the rank's device but the plan:

  the 2-bit wire of the rank's reads (pipeline.wire_batch) -> decode
  (ops/wire) -> destination scan (ops/minimizer) -> bucket sizes
  (dispatch.bucket_sizes_device, one all-reduce) -> classification and
  assignment on the host (num_buckets integers) -> heavy pre-count (key
  build, radix sort and fused count over the heavy positions; only the
  distinct heavy keys reach the host, one all-gather) -> the run table
  (ops/supermer.run_table) -> per-destination layout (torch ops; segment
  dims by one all-reduce MAX) -> the segment pack (ops/supermer.
  pack_segments) -> all_to_all (parallel/exchange) -> one flat unpack and
  the validity of each received segment (ops/wire) -> key build -> radix
  sort -> fused count -> compact and gather of every rank's list

The send tensor is bit for bit the one the host encoder builds from the
same share (io/supermer.encode_supermer_streams[_ext] + `_segments`, the
JAX package's route): those host functions, with `host_destinations`,
`host_canonical_words` and `heavy_precount`, stay here as the reference
the tests hold the device send side to, and no route calls them.

count_reads_supermer, count_reads_supermer_exchange and
count_reads_supermer_ext are the JAX entries with `mesh` replaced by
`group=None, device="cuda"`; all three run this driver, and every rank
returns the whole result, equal to the JAX package's on a mesh of as many
devices as there are ranks: the keys in rank order, then the rank's key
order, the heavy entries (when any) last as one ascending list; extension
mode the same occurrences. Streaming (count_reads_supermer_streaming)
fixes the assignment on batch 0, pre-counts heavy buckets per batch and
merges each rank's partial lists with them as one extra sorted run.

The step is per rank, on the rank's own reads: the entries above cut each
rank's share of the global reads first (parallel/pipeline._rank_share) and
gather every rank's list after. The multi-process entries
(count_fasta_multihost_supermer, count_fasta_multihost_supermer_streaming
and, in extension mode, _multihost_supermer_ext_streaming) run the same
step on each process's own records of a FASTA file
(parallel/multihost.read_my_shard) from read id offset its first record's
index, and return the rank's own share (the heavy entries of its own
bucket set last) with the global histogram, equal per rank to the JAX
multi-process entries. Their streams batch the rank's own reads, the batch
count agreed by all-reduce MAX (a rank that runs out feeds empty batches),
the assignment fixed on batch 0 as above.

The send side launches two kernels of its own, the run table
(csrc/supermer_runs.cu) and the segment pack (csrc/supermer_pack.cu);
besides them the path launches the key build (the m-mer words of the
destination scan, the heavy keys, the k-mer words), the radix sort and the
fused count, and in streaming the run merge and the weighted run-length
sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import KmerConfig
from ..io import supermer as supermer_io
from ..ops import fused_count, keybuild, minimizer, radix_sort, wire
from ..ops import supermer as supermer_ops
from ..pipeline import KmerList, host_histogram, resolve_device, to_host, wire_batch
from ..runtime.scheduler import ExtPartialStore
from ..runtime.timer import stage
from . import dispatch, exchange
from . import group as group_mod
from . import pipeline as sharded

__all__ = [
    "count_fasta_multihost_supermer",
    "count_fasta_multihost_supermer_streaming",
    "count_reads_supermer",
    "count_reads_supermer_ext",
    "count_reads_supermer_exchange",
    "count_reads_supermer_streaming",
    "heavy_precount_device",
    "host_destinations",
    "wire_nbytes",
]


def host_destinations(
    codes: np.ndarray, k: int, m: int, num_buckets: int, device="cuda"
) -> np.ndarray:
    """(n,) int32 destination bucket of the k-mer at each flat position.

    Runs the same minimizer scan as the device routes
    (ops/minimizer.kmer_destinations) on `device` and copies the
    destinations to the host: one routing rule, as in the JAX package, which
    runs its jitted scan on its CPU backend. The scan is int64 torch ops,
    tens of milliseconds on a card and seconds on the CPU at 2^26 bases
    (the reference: FindKmerDestinationsParallel, src/kmerops.cpp:1010-1041).
    """
    dev = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(dev)
    return to_host([minimizer.kmer_destinations(c, k, m, num_buckets)])[0]


def host_canonical_words(
    codes: np.ndarray, k: int, device="cuda", positions: np.ndarray | None = None
) -> list[np.ndarray]:
    """Per-position canonical key words (uint32), built on `device` by the
    same key build as the device pipelines; with `positions` only those
    positions' words are copied to the host."""
    dev = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(dev)
    words = keybuild.canonical_keys_fused(c, torch.ones_like(c, dtype=torch.bool), k)
    if positions is not None:
        at = torch.from_numpy(np.asarray(positions, dtype=np.int64)).to(dev)
        words = [w[at] for w in words]
    return [w.view(np.uint32) for w in to_host(words)]


def _sorted_runs(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(order, starts): the order that sorts (E, W) uint32 key rows
    ascending (unsigned, word 0 first: the device's key order) and the
    first sorted position of each distinct row. One np.lexsort on the
    columns gives np.unique(axis=0)'s rows several times faster than its
    sort of structured rows."""
    order = np.lexsort(keys.T[::-1])
    s = keys[order]
    new = np.ones(s.shape[0], dtype=bool)
    new[1:] = (s[1:] != s[:-1]).any(axis=1)
    return order, np.flatnonzero(new)


def heavy_precount(
    flat_codes: np.ndarray,
    flat_valid: np.ndarray,
    dest: np.ndarray,
    types: np.ndarray,
    assign: np.ndarray,
    k: int,
    num_shards: int,
    device="cuda",
) -> tuple[np.ndarray, list[tuple[np.ndarray, np.ndarray]]]:
    """Heavy buckets' k-mers -> pre-counted (key, count) entries.

    The reference's heavy-task conversion to a ScatteredKmerList
    (src/kmerops.cpp:363-417): k-mers of HEAVY buckets leave the supermer
    streams (the returned valid mask) and are counted on the host into
    per-owner-rank sorted (keys, counts) lists. Classification is per
    bucket and equal canonical k-mers share their bucket, so the entry key
    set is disjoint from everything the devices count: entries never touch
    the wire; they are filtered and appended (one-shot) or join the final
    merge as an extra sorted run (streaming).

    Returns (valid_without_heavy, [(keys (E, W) uint32 ascending in
    unsigned order, counts int64)] per rank).
    """
    heavy_pos = flat_valid.astype(bool) & (types[dest] == dispatch.HEAVY)
    new_valid = flat_valid & ~heavy_pos
    pos = np.flatnonzero(heavy_pos)
    words = host_canonical_words(flat_codes, k, device, positions=pos)
    keys = np.stack(words, axis=-1)
    owner = assign[dest[pos]]
    per_shard: list[tuple[np.ndarray, np.ndarray]] = []
    for s in range(num_shards):
        ks = keys[owner == s]
        if ks.shape[0] == 0:
            per_shard.append((np.zeros((0, keys.shape[1]), np.uint32),
                              np.zeros(0, np.int64)))
            continue
        order, starts = _sorted_runs(ks)
        cnts = np.diff(np.append(starts, ks.shape[0]))
        per_shard.append((ks[order[starts]].astype(np.uint32), cnts.astype(np.int64)))
    return new_valid, per_shard


def _sum_entry_lists(
    lists: list[tuple[np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray]:
    """Sum the counts of possibly repeating keys across entry lists (one per
    rank or batch) into one ascending (keys, counts)."""
    ks = [k for k, _ in lists if k.shape[0]]
    if not ks:
        w = lists[0][0].shape[1] if lists else 1
        return np.zeros((0, w), np.uint32), np.zeros(0, np.int64)
    allk = np.concatenate(ks)
    allc = np.concatenate([c for _, c in lists if c.shape[0]]).astype(np.int64)
    order, starts = _sorted_runs(allk)
    return allk[order[starts]].astype(np.uint32), np.add.reduceat(allc[order], starts)


def _allgather_entry_lists(
    per_shard: list[tuple[np.ndarray, np.ndarray]], group=None, device="cpu"
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Sum each rank's heavy entries across the ranks of `group`: every
    rank's (destination, key words, count) rows, int64, by one all-gather
    (parallel/pipeline._all_gather_rows), then one summed list per
    destination, on every rank."""
    w = per_shard[0][0].shape[1]
    rows = np.concatenate([
        np.concatenate([np.full((ks.shape[0], 1), s, np.int64),
                        ks.astype(np.int64), cs[:, None].astype(np.int64)], axis=1)
        for s, (ks, cs) in enumerate(per_shard)
    ])
    cdev = group_mod.collective_device(torch.device(device), group)
    every = sharded._all_gather_rows(torch.from_numpy(rows).to(cdev), group)
    out = []
    for s in range(len(per_shard)):
        lists = []
        for e in every:
            mine = e[e[:, 0] == s]
            lists.append((mine[:, 1:1 + w].astype(np.uint32), mine[:, 1 + w]))
        out.append(_sum_entry_lists(lists))
    return out


def _append_heavy_entries(
    kmerlist: KmerList, entries: tuple[np.ndarray, np.ndarray], cfg: KmerConfig
) -> KmerList:
    """Filter summed heavy entries by [L, U] and append them to a KmerList
    (the entry key set is disjoint from the device's)."""
    uk, cnts = entries
    keep = (cnts >= cfg.lower) & (cnts <= cfg.upper)
    if not keep.any():
        return kmerlist
    return KmerList(
        keys=np.concatenate([kmerlist.keys, uk[keep]]),
        counts=np.concatenate(
            [kmerlist.counts, cnts[keep].astype(kmerlist.counts.dtype)]),
        k=cfg.k,
    )


def wire_nbytes(streams: list[tuple[np.ndarray, ...]]) -> int:
    """Exchange bytes of a dispatch's streams: 2 bits/base + 4 B/supermer
    (+8 B/supermer of {rid0, pos0} headers for extension-mode streams)."""
    return sum(
        -(-int(s[0].shape[0]) // 4) + sum(int(a.nbytes) for a in s[1:])
        for s in streams
    )


def split_stream(
    c: np.ndarray, ln: np.ndarray, parts: int, *extras: np.ndarray
) -> list[tuple[np.ndarray, ...]]:
    """Split one (codes, lengths, *per-run extras) stream into `parts`
    contiguous sub-streams on supermer boundaries, balanced by bases."""
    if parts == 1:
        return [(c, ln, *extras)]
    bases_end = np.cumsum(ln.astype(np.int64))
    total = int(bases_end[-1]) if ln.size else 0
    # First supermer index of each part: balanced prefix targets.
    cuts = np.searchsorted(
        bases_end, np.arange(1, parts) * (total / parts), side="left"
    )
    bounds = np.concatenate([[0], cuts, [ln.size]])
    base_bounds = np.concatenate([[0], bases_end])[bounds]
    return [
        (
            c[base_bounds[i]: base_bounds[i + 1]],
            ln[bounds[i]: bounds[i + 1]],
            *(e[bounds[i]: bounds[i + 1]] for e in extras),
        )
        for i in range(parts)
    ]


# --------------------------------------------------------------------------
# The supermer step. Its stage spans (runtime/timer.stage) are what chip_smoke.py's
# phase 11(a) stage line and the CLI's multi-process line read.


def _plan(dest: torch.Tensor, valid: torch.Tensor, cfg: KmerConfig, assign,
          classify: bool, dev, group) -> tuple[np.ndarray, np.ndarray]:
    """(types, assign): the global bucket sizes, counted on the device
    (dispatch.bucket_sizes_device) and summed by one all-reduce on the
    collective device, the heavy buckets where `classify` and
    cfg.classifier ask for them, and the bucket -> rank assignment where
    `assign` is None (heavy buckets carry no dispatch load). Only the
    num_buckets sizes reach the host; every rank computes the same."""
    num_shards = dist.get_world_size(group)
    num_buckets = sharded._num_buckets(cfg, num_shards)
    with stage("sizes", dev):
        sizes = dispatch.bucket_sizes_device(dest, valid, num_buckets).to(torch.int64)
    with stage("sizes all_reduce", dev):
        sizes = sizes.to(group_mod.collective_device(dev, group))
        dist.all_reduce(sizes, op=dist.ReduceOp.SUM, group=group)
        sizes = sizes.cpu().numpy()
    types = np.zeros(num_buckets, np.int32)
    if classify and cfg.classifier == "heavy_hitter":
        types = dispatch.classify(sizes, cfg.heavy_ratio)
    if assign is None:
        dispatch_sizes = np.where(types == dispatch.HEAVY, 0, sizes)
        if cfg.dispatcher == "balanced":
            assign = dispatch.balanced_assignment(dispatch_sizes, num_shards)
        else:
            assign = dispatch.round_robin_assignment(num_buckets, num_shards)
    return types, assign


def heavy_precount_device(
    codes: torch.Tensor,
    valid: torch.Tensor,
    dest: torch.Tensor,
    types: np.ndarray,
    assign: torch.Tensor,
    k: int,
    num_shards: int,
) -> tuple[torch.Tensor, list[tuple[np.ndarray, np.ndarray]]]:
    """`heavy_precount` where the rank's codes lie: the heavy positions
    (valid, in a HEAVY bucket) keyed by the key build over that mask, the
    keys with their owner rank (assign[dest]) as a payload row sorted by
    one radix sort and counted by the fused count; only the distinct heavy
    keys, their counts and owners cross to the host, split there per owner.
    Returns (valid without the heavy positions, [(keys (E, W) uint32
    ascending in unsigned order, counts int64)] per rank), as
    heavy_precount."""
    heavy_types = torch.from_numpy(types == dispatch.HEAVY).to(dest.device)
    heavy = valid & heavy_types[dest.to(torch.int64)]
    pos = torch.nonzero(heavy).squeeze(1)
    words = [w[pos] for w in keybuild.canonical_keys_fused(codes, heavy, k)]
    owner = assign[dest[pos].to(torch.int64)]
    keys = np.zeros((0, len(words)), np.uint32)
    counts = owners = np.zeros(0, np.int64)
    if pos.numel():
        words_s, (owner_s,) = radix_sort.sort_words(words, [owner])
        cnt, head = fused_count.run_length_count_filter(words_s, 1, 2**31 - 1)
        idx = torch.nonzero(head).squeeze(1)
        keys, counts, owners = to_host([torch.stack([x[idx] for x in words_s], dim=-1),
                                        cnt[idx], owner_s[idx]])
        keys = keys.view(np.uint32)
    per_shard = [(keys[owners == s], counts[owners == s].astype(np.int64))
                 for s in range(num_shards)]
    return valid & ~heavy, per_shard


def _encode(flat_codes, flat_valid, shard_of, cfg: KmerConfig, num_shards: int,
            lengths, read_id_offset: int, ext: bool):
    """Per-destination-rank supermer streams of this rank's share: runs
    break where the destination RANK changes (shard_of = assign[dest]), as
    in the JAX package, so on one rank the streams are the reads."""
    if ext:
        return supermer_io.encode_supermer_streams_ext(
            flat_codes, flat_valid, shard_of, cfg.k, num_shards, lengths,
            read_id_offset)
    return supermer_io.encode_supermer_streams(
        flat_codes, flat_valid, shard_of, cfg.k, num_shards)


def _segments(streams, cfg: KmerConfig, dev, group, min_dims=(0, 1)):
    """The streams as (S, 1, width) int32 exchange segments on the device,
    one per destination rank: block_len/16 packed words, then lmax supermer
    lengths, then (extension mode) lmax rid0 and lmax pos0. block_len is a
    multiple of lcm(16, pad_multiple) with 16 spare slots and lmax at least
    1, both the maxima over every rank (one all-reduce MAX) and pinned from
    below by min_dims; segments start on word boundaries, so one flat
    unpack covers all S received ones. Returns (send, block_len, lmax)."""
    ext = len(streams[0]) == 4
    cmax = max(s[0].shape[0] for s in streams)
    smax = max(s[1].shape[0] for s in streams)
    cmax, smax = sharded._all_reduce_host(np.array([cmax, smax]), dist.ReduceOp.MAX,
                                          dev, group)
    gran = int(np.lcm(16, cfg.pad_multiple))
    block_len = -(-max(int(cmax) + 16, gran, min_dims[0]) // gran) * gran
    lmax = max(int(smax), 1, min_dims[1])
    nw = block_len // 16
    send = np.zeros((len(streams), 1, nw + lmax * (3 if ext else 1)), dtype=np.int32)
    buf = np.zeros(block_len, dtype=np.int8)
    for s, stream in enumerate(streams):
        c, ln = stream[:2]
        buf[: c.shape[0]] = c
        buf[c.shape[0]:] = 0
        send[s, 0, :nw] = supermer_io.pack_codes_2bit(buf).view(np.int32)
        send[s, 0, nw: nw + ln.shape[0]] = ln
        if ext:
            r0, p0 = stream[2:]
            send[s, 0, nw + lmax: nw + lmax + r0.shape[0]] = r0
            send[s, 0, nw + 2 * lmax: nw + 2 * lmax + p0.shape[0]] = p0.view(np.int32)
    return torch.from_numpy(send).to(dev), block_len, lmax


def _decode_received(recv: torch.Tensor, cfg: KmerConfig, block_len: int, lmax: int):
    """The S received segments -> (codes, valid, [rid, pos]) over
    S * block_len slots: one flat unpack (segments start on word
    boundaries), the validity of each segment from its supermer lengths
    (ops/wire.valid_from_lengths), and in extension mode each segment's
    (rid, pos) from its run headers (ops/wire.fill_run_meta)."""
    num_shards = recv.shape[0]
    nw = block_len // 16
    codes = wire.unpack_codes(recv[:, 0, :nw].reshape(-1), num_shards * block_len)
    lens = recv[:, 0, nw: nw + lmax]
    valid = torch.cat([wire.valid_from_lengths(lens[i], cfg.k, block_len)
                       for i in range(num_shards)])
    if recv.shape[2] == nw + lmax:
        return codes, valid, []
    meta = [wire.fill_run_meta(lens[i], recv[i, 0, nw + lmax: nw + 2 * lmax],
                               recv[i, 0, nw + 2 * lmax:], block_len)
            for i in range(num_shards)]
    return codes, valid, [torch.cat([m[0] for m in meta]), torch.cat([m[1] for m in meta])]


def _count_received(recv, cfg: KmerConfig, block_len: int, lmax: int):
    """Receive side: decode, key build, radix sort (rid and pos ride as
    payload rows in extension mode), fused count. Returns (sorted words,
    cnt, keep, sorted payloads)."""
    dev = recv.device
    with stage("receive decode + keybuild", dev):
        codes, valid, payloads = _decode_received(recv, cfg, block_len, lmax)
        marked = keybuild.canonical_keys_fused(codes, valid, cfg.k)
        del codes, valid
    with stage("radix sort", dev):
        words_s, pay_s = radix_sort.sort_words(marked, payloads)
        del marked, payloads
    with stage("fused count", dev):
        cnt, keep = sharded._count_merged(words_s, cfg)
    return words_s, cnt, keep, pay_s


@dataclasses.dataclass
class _Step:
    """One step's outputs on this rank."""

    words: list  # sorted key words on the device
    cnt: torch.Tensor
    keep: torch.Tensor
    payloads: list  # sorted (rid, pos) in extension mode, else empty
    heavy: list | None  # summed heavy entries per rank, or None
    assign: np.ndarray
    dims: tuple[int, int]  # (block_len, lmax)


def _device_send(codes: torch.Tensor, valid: torch.Tensor, shard_of: torch.Tensor,
                 read_lengths: torch.Tensor, cfg: KmerConfig, num_shards: int,
                 read_id_offset: int, ext: bool, dev, group, min_dims=(0, 1)):
    """The send tensor of `_segments(_encode(...))`, built on the rank's
    device: the run table (ops/supermer.run_table), the per-destination
    layout, the segment dims (the most of any rank by one all-reduce MAX,
    pinned from below by min_dims), in extension mode each run's headers
    from the read lengths, then the segment pack (ops/supermer.
    pack_segments). Returns (send, block_len, lmax)."""
    with stage("run table", dev):
        starts, kmers, run_dest = supermer_ops.run_table(valid, shard_of,
                                                         supermer_ops.max_kmers(cfg.k))
    with stage("layout", dev):
        layout = supermer_ops.segment_layout(starts, kmers, run_dest, cfg.k, num_shards)
        del starts, kmers, run_dest
    with stage("dims all_reduce", dev):
        cmax, smax = sharded._all_reduce_host(np.array([layout.cmax, layout.smax]),
                                              dist.ReduceOp.MAX, dev, group)
    block_len, lmax = supermer_ops.segment_dims(int(cmax), int(smax), cfg.pad_multiple,
                                                min_dims)
    headers = ()
    if ext:
        with stage("run headers", dev):
            headers = supermer_ops.run_headers(layout.src, read_lengths, read_id_offset)
    with stage("segment pack", dev):
        send = supermer_ops.pack_segments(codes, layout, block_len, lmax, headers)
    return send, block_len, lmax


def _supermer_step(codes, lengths, cfg: KmerConfig, group, dev, *, assign=None,
                   read_id_offset: int = 0, min_dims=(0, 1)) -> _Step:
    """One pass of the route on this rank's own reads (codes, lengths), read
    ids from read_id_offset, with the collectives every rank runs whether or
    not it holds reads. `assign` fixes the bucket -> rank assignment
    (streaming, after batch 0); extension mode has no classifier, as in the
    JAX package. The send side runs on the rank's device: the reads cross
    once as the 2-bit wire (pipeline.wire_batch; the rank's own block, so
    no agreed dims) and only the bucket sizes and, with a heavy bucket, the
    distinct heavy keys come back to the host."""
    ext = cfg.extension
    num_shards = dist.get_world_size(group)
    # The pack's parts are stages of their own: "feed" (wire and decode),
    # "plan" (scan, sizes, plan, heavy pre-count), "encode" (the send side),
    # each split further into the spans inside it.
    with stage("pack", dev):
        with stage("feed", dev):
            lens = np.asarray(lengths).astype(np.int32)
            with stage("wire feed", dev):  # pipeline.stage_wire's spans, then H2D
                packed, lens_d, n = wire_batch(codes, lens, cfg, dev)
            with stage("wire decode", dev):
                codes_d, valid = wire.decode_block(packed, lens_d, cfg.k, n)
                del packed
        with stage("plan", dev):
            with stage("scan", dev):
                dest = minimizer.kmer_destinations(codes_d, cfg.k, cfg.m,
                                                   sharded._num_buckets(cfg, num_shards))
            types, assign = _plan(dest, valid, cfg, assign, not ext, dev, group)
            assign_d = torch.from_numpy(np.asarray(assign, dtype=np.int32)).to(dev)
            heavy = None
            if (types == dispatch.HEAVY).any():
                with stage("heavy pre-count", dev):
                    valid, per_shard = heavy_precount_device(
                        codes_d, valid, dest, types, assign_d, cfg.k, num_shards)
                    heavy = _allgather_entry_lists(per_shard, group, dev)
        with stage("encode", dev):
            with stage("destination ranks", dev):
                shard_of = assign_d[dest.to(torch.int64)]
                del dest
            send, block_len, lmax = _device_send(codes_d, valid, shard_of, lens_d, cfg,
                                                 num_shards, read_id_offset, ext, dev,
                                                 group, min_dims)
            del codes_d, valid, shard_of, lens_d
    with stage("step", dev):
        with stage("exchange", dev):
            recv, _, _ = exchange.all_to_all_exchange(
                send, [send.shape[2]] * num_shards, group)
            del send
        words, cnt, keep, pay = _count_received(recv, cfg, block_len, lmax)
    return _Step(words, cnt, keep, pay, heavy, assign, (block_len, lmax))


def _step_ext_rows(step: _Step):
    """An extension-mode step's kept rows and occurrences, an ascending
    ExtPartial on the device (parallel/pipeline._ext_rows)."""
    return sharded._ext_rows(step.words, step.cnt, step.keep, *step.payloads, False)


def supermer_ext_partial(codes, lengths, cfg: KmerConfig, group, device,
                         read_id_offset: int = 0, min_dims=(0, 1)):
    """Extension mode on the global reads: the rank's share through one
    step, then every rank's rows in rank order as one ExtPartial
    (parallel/pipeline._gather_ext)."""
    dev = group_mod.rank_device(device)
    mine, lens, first = sharded._rank_share(codes, lengths, group)
    step = _supermer_step(mine, lens, cfg, group, dev,
                          read_id_offset=read_id_offset + first, min_dims=min_dims)
    return sharded._gather_ext(_step_ext_rows(step), group, dev)


def _supermer_one_shot(codes, lengths, cfg: KmerConfig, group, device,
                       read_id_offset: int = 0, min_dims=(0, 1)):
    """The one-shot entries on the global reads: the rank's share through
    one step, then every rank's list in rank order (the heavy entries after
    it, as one ascending list) and its histogram, on every rank."""
    if cfg.extension:
        kmerlist = sharded._ext_list(supermer_ext_partial(
            codes, lengths, cfg, group, device, read_id_offset, min_dims), cfg.k)
        return kmerlist, host_histogram(kmerlist.counts, cfg.upper)
    dev = group_mod.rank_device(device)
    mine, lens, first = sharded._rank_share(codes, lengths, group)
    step = _supermer_step(mine, lens, cfg, group, dev,
                          read_id_offset=read_id_offset + first, min_dims=min_dims)
    kmerlist = sharded._gather_list(
        sharded._rank_list(step.words, step.cnt, step.keep, cfg, False,
                           sharded._bounds(cfg)[1]), group, dev)
    if step.heavy is not None:
        kmerlist = _append_heavy_entries(kmerlist, _sum_entry_lists(step.heavy), cfg)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def count_reads_supermer_exchange(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
    read_id_offset: int = 0,
):
    """Supermer routing with the exchange across the ranks of `group`: each
    rank encodes its share of the global reads into per-destination
    segments and one all_to_all swaps them. In extension mode the segments
    carry the reference's {len, pos, rid} run headers
    (include/kmer.hpp:348-360) and the owner derives every k-mer's
    occurrence after the exchange; read ids count from read_id_offset.
    Every rank returns the whole (KmerList[Ext], histogram)."""
    return _supermer_one_shot(codes, lengths, cfg, group, device, read_id_offset)


def count_reads_supermer(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
):
    """Supermer routing entry: destination scan -> classification and
    dispatch -> supermer streams -> exchange -> local sort and count, across
    the ranks of `group`. The JAX package feeds each device its streams
    directly here; a rank feeds only its own device, so this is the
    exchange driver (count_reads_supermer_exchange), with the same result.
    Extension mode goes to count_reads_supermer_ext."""
    if cfg.routing != "supermer":
        raise ValueError(f"count_reads_supermer needs routing='supermer', got "
                         f"{cfg.routing!r}")
    if cfg.extension:
        return count_reads_supermer_ext(codes, lengths, cfg, group, device)
    return _supermer_one_shot(codes, lengths, cfg, group, device)


def count_reads_supermer_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    group=None,
    device="cuda",
    read_id_offset: int = 0,
    min_dims: tuple[int, int] = (0, 1),
):
    """Extension-mode supermer routing: every k-mer's (read id, position)
    occurrences, through the run-format wire (+8 B/supermer of {rid0, pos0}
    headers). min_dims = (min_block_len, min_lmax) pins the segments' shape
    from below (the streaming caller's parallel/pipeline.ext_stream_dims).
    No classifier in extension mode: pre-counted entries carry no
    occurrences."""
    if not (cfg.extension and cfg.routing == "supermer"):
        raise ValueError("count_reads_supermer_ext needs extension=True and "
                         "routing='supermer'")
    return _supermer_one_shot(codes, lengths, cfg, group, device, read_id_offset,
                              min_dims)


def _heavy_run(lists: list[tuple[np.ndarray, np.ndarray]]):
    """A rank's heavy entries of every batch, summed, as one partial list of
    the final merge: W int32 key word arrays, then the int32 counts."""
    uk, cnts = _sum_entry_lists(lists)
    return ([np.ascontiguousarray(uk[:, i]).view(np.int32) for i in range(uk.shape[1])]
            + [cnts.astype(np.int32)])


def count_reads_supermer_streaming(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    batch_bases: int = 1 << 26,
    group=None,
    device="cuda",
    async_depth=None,
):
    """Bounded-memory supermer routing across the ranks of `group`: batches
    of batch_bases (the same batches on every rank, cut from the global
    lengths) go through the route with an UNFILTERED count; each rank keeps
    its compacted partial (key, count) lists on the host and merges them at
    the end (parallel/pipeline._merge_partials: merge by run bounds, the
    weighted run-length sum, the [L, U] filter), the reference's
    fixed-size supermer rounds (src/kmerops.cpp:587-643). Keys never change
    owner across batches: the bucket -> rank assignment is fixed on batch
    0, from batch 0's global sizes.

    Heavy buckets are classified and pre-counted per batch; a rank's summed
    entries join its final merge as one extra sorted run, so classification
    that differs between batches stays exact. async_depth is accepted for
    parity with the JAX signature and changes nothing: each batch settles
    before the next. Extension mode goes to
    parallel/pipeline.count_reads_sharded_ext_streaming, as in the JAX
    package."""
    if cfg.routing != "supermer":
        raise ValueError(f"count_reads_supermer_streaming needs routing='supermer', "
                         f"got {cfg.routing!r}")
    if cfg.extension:
        return sharded.count_reads_sharded_ext_streaming(
            codes, lengths, cfg, batch_bases, group, device)
    if async_depth is not None and async_depth < 1:
        raise ValueError(f"async_depth must be at least 1, got {async_depth}")
    dev = group_mod.rank_device(device)
    kmerlist = _supermer_streaming(sharded._share_batches(codes, lengths, batch_bases, group),
                                   cfg, group, dev)
    return sharded._every_rank(kmerlist, cfg, group, dev)


def _supermer_streaming(batches, cfg: KmerConfig, group, dev) -> KmerList:
    """The streaming driver on the rank's batches, (codes, lengths, first
    read) of its own reads in each, as many on every rank
    (parallel/pipeline._share_batches, _own_batches). Returns the rank's
    share of the filtered list, its heavy entries merged in."""
    rank = dist.get_rank(group)
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    assign = None
    dims = (0, 1)
    parts, heavy = [], []
    for b_codes, b_lengths, _ in batches:
        step = _supermer_step(b_codes, b_lengths, cfg_pre, group, dev, assign=assign,
                              min_dims=dims)
        assign = step.assign
        dims = tuple(max(a, b) for a, b in zip(dims, step.dims))
        if step.heavy is not None and step.heavy[rank][0].shape[0]:
            heavy.append(step.heavy[rank])
        with stage("result", dev):
            idx = torch.nonzero(step.keep).squeeze(1)
            parts.append(to_host([w[idx] for w in step.words] + [step.cnt[idx]]))
        del step, idx
    if assign is None:  # no reads: no rank saw a batch
        return sharded._empty_list(cfg)
    if heavy:
        parts.append(_heavy_run(heavy))
    words, total, keep = sharded._merge_partials(parts, cfg, dev)
    return sharded._rank_list(words, total, keep, cfg, False, cfg.upper)


# --------------------------------------------------------------------------
# The multi-process entries: each process counts its own records of a FASTA
# file and keeps its own share of the result (hysortk_tpu's
# count_fasta_multihost_supermer, count_fasta_multihost_supermer_streaming,
# _multihost_supermer_ext_streaming).


def count_fasta_multihost_supermer(fasta_path: str, cfg: KmerConfig, group=None,
                                   device="cuda"):
    """Multi-process supermer routing: this process's records of the FASTA
    (parallel/multihost.read_my_shard) -> supermer dispatch -> the exchange
    -> local count. The wire between ranks is the reference's supermer
    format (~2 bits/base + 4 B/supermer, src/kmerops.cpp:1096-1148).
    Extension mode adds the {len, pos, rid} run headers, read ids counted
    from the index of the process's first record (the reference's
    MPI_Exscan of read counts, src/kmerops.cpp:66).

    Returns (this rank's KmerList[Ext], the global histogram)."""
    from . import multihost

    codes, lengths, rid_offset = multihost.read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    step = _supermer_step(codes, lengths, cfg, group, dev, read_id_offset=rid_offset)
    if cfg.extension:
        kmerlist = sharded._ext_list(_step_ext_rows(step), cfg.k)
    else:
        kmerlist = sharded._rank_list(step.words, step.cnt, step.keep, cfg, False,
                                      sharded._bounds(cfg)[1])
        if step.heavy is not None:  # the rank's own entries, after its list
            kmerlist = _append_heavy_entries(kmerlist, step.heavy[dist.get_rank(group)],
                                             cfg)
    return kmerlist, sharded._global_histogram(kmerlist.counts, cfg.upper, dev, group)

def count_fasta_multihost_supermer_streaming(fasta_path: str, cfg: KmerConfig,
                                             batch_bases: int = 1 << 26, group=None,
                                             device="cuda"):
    """Bounded-memory multi-process supermer counting: each process streams
    its own records through the exchange in batches of batch_bases (the
    reference's fixed-size supermer rounds across ranks,
    src/kmerops.cpp:587-643). Unfiltered partial lists stay on the rank
    (the batch-0 assignment fixes who owns a key), heavy buckets pre-count
    per batch and join the rank's final merge as one extra run, [L, U]
    applies to the merged totals. Extension mode goes to
    _multihost_supermer_ext_streaming.

    Returns (this rank's KmerList[Ext], the global histogram)."""
    from . import multihost

    if cfg.routing != "supermer":
        raise ValueError(f"count_fasta_multihost_supermer_streaming needs "
                         f"routing='supermer', got {cfg.routing!r}")
    if cfg.extension:
        return _multihost_supermer_ext_streaming(fasta_path, cfg, batch_bases, group,
                                                 device)
    codes, lengths, _ = multihost.read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    batches = sharded._own_batches(codes, lengths, batch_bases, dev, group)
    kmerlist = _supermer_streaming(batches, cfg, group, dev)
    return kmerlist, sharded._global_histogram(kmerlist.counts, cfg.upper, dev, group)

def _multihost_supermer_ext_streaming(fasta_path: str, cfg: KmerConfig,
                                      batch_bases: int, group=None, device="cuda"):
    """Bounded-memory extension-mode supermer routing across processes: each
    batch of the process's own reads ships supermer segments with their
    {len, pos, rid} run headers and counts UNFILTERED on the owner; the
    rank's per-batch occurrence partials stay on its device and merge there
    once under the global [L, U] (runtime/scheduler.ExtPartialStore). The
    assignment is fixed on batch 0, so a
    key keeps its owner across batches; read ids count from the process's
    first record and each batch advances them by its reads. No classifier,
    as in the one-shot extension mode.

    Returns (this rank's KmerListExt, the global histogram)."""
    from . import multihost

    codes, lengths, first = multihost.read_my_records(fasta_path, group)
    dev = group_mod.rank_device(device)
    cfg_pre = dataclasses.replace(cfg, unfiltered=True)
    assign = None
    dims = (0, 1)
    store = ExtPartialStore(cfg, dev)
    for b_codes, b_lengths, rid in sharded._own_batches(codes, lengths, batch_bases, dev,
                                                        group, first):
        step = _supermer_step(b_codes, b_lengths, cfg_pre, group, dev, assign=assign,
                              read_id_offset=rid, min_dims=dims)
        assign = step.assign
        dims = tuple(max(a, b) for a, b in zip(dims, step.dims))
        store.add(_step_ext_rows(step))
        del step
    with stage("merge", dev):
        merged, _ = store.result()
    return merged, sharded._global_histogram(merged.counts, cfg.upper, dev, group)
