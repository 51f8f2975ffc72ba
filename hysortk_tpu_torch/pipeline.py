"""Single-device end-to-end k-mer counting pipeline in PyTorch.

The port of hysortk_tpu/pipeline.py's single-device path. The device
computation mirrors the reference's three phases (kmer_count,
src/hysortk.cpp:36-95):

  prepare  canonical keys              ops/keybuild.canonical_keys_fused
  sort     multiword key sort          ops/radix_sort.sort_words
  count    run length + [L,U] filter   ops/fused_count.run_length_count_filter

On a CUDA device each step is a hand-written kernel; on the CPU each is its
plain PyTorch version. The device is always explicit: asking for CUDA where
there is none raises, and nothing moves to the CPU by itself.

With HYSORTK_FUSED_SORT set (non-empty) in the environment the keys-only
paths take ops/fused_sort.sort_codes_fused for prepare + sort, the key build
fused into the sort's first pass, as the JAX package does under the same
variable. Extension mode ((ReadId, PosInRead) payloads riding the sort,
`count_flat_ext`, `count_reads_ext`) keeps the unfused pair.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .config import KmerConfig
from .ops import fused_count
from .ops import fused_sort
from .ops import keybuild
from .ops import kmer as kmer_ops
from .ops import radix_sort
from .ops import wire


@dataclasses.dataclass
class KmerList:
    """Filtered {kmer, count} result on host.

    keys:   (M, W) uint32 packed canonical keys
    counts: (M,) int32 frequencies, all within [lower, upper]
    Laid out as hysortk_tpu.pipeline.KmerList (reference KmerListS,
    include/kmer.hpp:348-360), so the two compare with np.array_equal.
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, int]:
        return dict(zip(self.decoded().tolist(), self.counts.tolist()))


@dataclasses.dataclass
class KmerListExt:
    """Extension-mode result: per-kmer occurrence payloads.

    pos[j]/rid[j] are the PosInRead / global ReadId arrays of all counts[j]
    occurrences of keys[j] (the reference's EXTENSION=1 KmerListEntryS,
    include/kmer.hpp:346-400, populated at src/kmerops.cpp:1430-1438). Laid
    out as hysortk_tpu.pipeline.KmerListExt. The order of a k-mer's
    occurrences is not part of the result: compare by as_dict().
    """

    keys: np.ndarray
    counts: np.ndarray
    k: int
    pos: list[np.ndarray] = dataclasses.field(default_factory=list)
    rid: list[np.ndarray] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def decoded(self) -> np.ndarray:
        return kmer_ops.decode_keys(self.keys, self.k)

    def as_dict(self) -> dict[bytes, tuple[int, set]]:
        """kmer -> (count, {(rid, pos), ...}) for order-free comparison."""
        out = {}
        for km, c, p, r in zip(
            self.decoded().tolist(), self.counts.tolist(), self.pos, self.rid
        ):
            out[km] = (int(c), set(zip(r.tolist(), p.tolist())))
        return out


def resolve_device(device) -> torch.device:
    """torch.device of `device`; raises where CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _count_core(
    codes: torch.Tensor, valid: torch.Tensor, k: int, lower: int, upper: int
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """codes (N,) int8, valid (N,) bool -> sorted key words, counts, keep."""
    if os.environ.get("HYSORTK_FUSED_SORT"):  # read at call time
        words_s = fused_sort.sort_codes_fused(codes, valid, k)
    else:
        marked = keybuild.canonical_keys_fused(codes, valid, k)
        words_s, _ = radix_sort.sort_words(marked)
    cnt, keep = fused_count.run_length_count_filter(words_s, lower, upper)
    return words_s, cnt, keep


def compact_keys(
    words: list[torch.Tensor], cnt: torch.Tensor, keep: torch.Tensor, k: int
) -> KmerList:
    """Gather the kept rows on the device, then copy only those to the host."""
    idx = torch.nonzero(keep).squeeze(1)
    keys = torch.stack([w[idx] for w in words], dim=-1)
    return KmerList(
        keys=keys.cpu().numpy().view(np.uint32),
        counts=cnt[idx].cpu().numpy(),
        k=k,
    )


def pull_prefix(tensors, n: int) -> list[np.ndarray]:
    """The first n elements of each device tensor, as host arrays: only the
    prefix crosses to the host, not the padded tail."""
    return [t[:n].cpu().numpy() for t in tensors]


def narrow_counts(cnt: torch.Tensor, upper: int) -> torch.Tensor:
    """Cast FILTERED device counts to the narrowest dtype `upper` fits
    before the host copy: uint8 for U <= 255, uint16 for U <= 65535 (the
    reference's own count bound, compiletime.h:21), else unchanged. Every
    kept count is <= upper by the frequency filter, so the cast is exact;
    a caller widens back to int32 on the host."""
    if upper <= 0xFF:
        return cnt.to(torch.uint8)
    if upper <= 0xFFFF:
        return cnt.to(torch.uint16)
    return cnt


def _count_device_packed(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int,
    lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Wire-fed single-device step: (n/16,) packed words + (R,) read lengths
    -> decode on the device -> sorted key words, counts, keep. The bounds
    are arguments: streaming pre-counts pass (1, 2**31 - 1)."""
    codes, valid = wire.decode_block(packed, lengths, k, n)
    return _count_core(codes, valid, k, lower, upper)


def _count_device_packed_compact(
    packed: torch.Tensor, lengths: torch.Tensor, k: int, n: int,
    lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, int]:
    """Wire-fed step + on-device compaction: the kept (key, count) rows as
    an ascending prefix [0, n_kept) of (n,) tensors whose tail is the
    all-ones sentinel (counts 0), i.e. one sorted sentinel-padded run.
    Returns (words, counts, n_kept).

    The JAX package folds dropped slots to the sentinel and sorts once more;
    the rows are already in key order here, so a mask gather keeps that
    order and gives the same prefix."""
    words_s, cnt, keep = _count_device_packed(packed, lengths, k, n, lower, upper)
    idx = torch.nonzero(keep).squeeze(1)
    n_kept = int(idx.shape[0])
    words = []
    for w in words_s:
        out = torch.full_like(w, -1)
        out[:n_kept] = w[idx]
        words.append(out)
    counts = torch.zeros_like(cnt)
    counts[:n_kept] = cnt[idx]
    return words, counts, n_kept


def host_histogram(counts: np.ndarray, upper: int) -> np.ndarray:
    """hist[c] = number of kept kmers with frequency c (c in [0, upper])."""
    return np.bincount(
        np.asarray(counts, dtype=np.int64), minlength=upper + 1
    ).astype(np.int32)[: upper + 1]


def count_flat(
    codes: np.ndarray, valid: np.ndarray, cfg: KmerConfig, device="cuda"
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers of a flat batch. Returns (list, histogram)."""
    dev = resolve_device(device)
    words, cnt, keep = _count_core(
        torch.as_tensor(np.asarray(codes, dtype=np.int8)).to(dev),
        torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev),
        cfg.k, cfg.lower, cfg.upper,
    )
    kmerlist = compact_keys(words, cnt, keep, cfg.k)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


def device_batch(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host reads -> (codes int8 (n,), valid bool (n,)) on the device.

    Pads to cfg.pad_multiple (at least 16 spare slots), packs 2 bits/base on
    the host (io/supermer.pack_codes_2bit), copies ~2 bits/base + 4 B/read
    to the device and decodes there (ops/wire.decode_block)."""
    from .io import supermer as supermer_io

    dev = resolve_device(device)
    total = int(codes.size)
    pad = cfg.pad_multiple
    n = -(-(total + 16) // pad) * pad
    buf = np.zeros(n, dtype=np.int8)
    buf[:total] = codes
    packed = supermer_io.pack_codes_2bit(buf)
    return wire.decode_block(
        torch.from_numpy(packed.view(np.int32)).to(dev),
        torch.from_numpy(np.asarray(lengths).astype(np.int32)).to(dev),
        cfg.k,
        n,
    )


def count_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    cfg: KmerConfig,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Full single-device pipeline from host reads, fed over the 2-bit
    packed wire (`device_batch`).

    `cfg.device_compact` selects nothing here: the JAX count_reads uses it
    to compact on the device before the host copy, and `compact_keys`
    already gathers the kept rows on the device in every configuration, so
    the result is the same KmerList either way."""
    codes_d, valid_d = device_batch(codes, lengths, cfg, device)
    words, cnt, keep = _count_core(
        codes_d, valid_d, cfg.k, cfg.lower, cfg.upper
    )
    kmerlist = compact_keys(words, cnt, keep, cfg.k)
    return kmerlist, host_histogram(kmerlist.counts, cfg.upper)


# --------------------------------------------------------------------------
# Extension mode: (ReadId, PosInRead) payloads ride the sort.

# Unfiltered bounds (cfg.unfiltered, and streaming's per-batch passes).
UNFILTERED = (1, 2**31 - 1)


def _count_device_ext(
    codes: torch.Tensor, valid: torch.Tensor, rid: torch.Tensor,
    pos: torch.Tensor, k: int, lower: int, upper: int,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extension-mode device pipeline: rid and pos (int32 bit patterns) ride
    the sort as payload rows (the reference instead widens KmerSeedStruct,
    include/kmer.hpp:402-430). Returns (sorted words, cnt, keep, sorted rid,
    sorted pos). The sort is stable, so a k-mer's occurrences come out in
    ascending flat position."""
    marked = keybuild.canonical_keys_fused(codes, valid, k)
    words_s, (rid_s, pos_s) = radix_sort.sort_words(marked, [rid, pos])
    cnt, keep = fused_count.run_length_count_filter(words_s, lower, upper)
    return words_s, cnt, keep, rid_s, pos_s


def _count_device_ext_packed(
    packed: torch.Tensor, lengths: torch.Tensor, rid_base: int, k: int,
    n: int, lower: int, upper: int,
):
    """Wire-fed extension step: (rid, pos) are derived on the device from
    the read lengths (ops/wire.rid_pos_from_lengths), so the feed is the
    packed wire of the non-extension step plus one scalar."""
    codes, valid, rid, pos = wire.decode_block_ext(packed, lengths, k, n, rid_base)
    return _count_device_ext(codes, valid, rid, pos, k, lower, upper)


def split_occurrences(
    starts: np.ndarray, counts: np.ndarray, *arrays: np.ndarray
) -> list[list[np.ndarray]]:
    """Slice per-kmer occurrence runs [start, start+count) out of flat
    payload streams as views (no copies), over pre-tolist'ed bounds: plain
    int slicing is several times faster than np.split or numpy-scalar
    indices, which matters at 10^6+ distinct k-mers."""
    s_list = starts.tolist()
    e_list = (starts + counts).tolist()
    return [
        [a[s:e] for s, e in zip(s_list, e_list)] for a in arrays
    ]


def kept_occurrences(cnt, keep, rid_s, pos_s):
    """The kept runs of the extension step's sorted outputs, gathered on the
    device: (starts, counts int64, rid, pos), the occurrences of the kept
    runs laid end to end in run order."""
    starts = torch.nonzero(keep).squeeze(1)
    counts = cnt[starts].to(torch.int64)
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if counts.shape[0] else 0
    # Occurrence j of the kept runs, laid end to end, sits at sorted slot
    # starts[run] + (j - first j of the run).
    slot = torch.arange(total, device=keep.device) + torch.repeat_interleave(
        starts - (ends - counts), counts, output_size=total
    )
    return starts, counts, rid_s[slot], pos_s[slot]


def assemble_ext_result(words, cnt, keep, rid_s, pos_s, cfg: KmerConfig) -> KmerListExt:
    """Assembly of the extension step's device outputs: the kept keys and
    counts, and the sorted payload streams cut into per-kmer occurrence
    lists. The occurrences of the kept runs are gathered on the device and
    only those cross to the host (the JAX package copies both whole streams
    and slices them there); the ragged lists are host views of them."""
    starts, counts, rid, pos = kept_occurrences(cnt, keep, rid_s, pos_s)
    counts_np = counts.cpu().numpy()
    out_starts = np.zeros(counts_np.size, dtype=np.int64)
    np.cumsum(counts_np[:-1], out=out_starts[1:])
    pos_runs, rid_runs = split_occurrences(
        out_starts, counts_np, pos.cpu().numpy().view(np.uint32), rid.cpu().numpy(),
    )
    keys = torch.stack([w[starts] for w in words], dim=-1)
    return KmerListExt(
        keys=keys.cpu().numpy().view(np.uint32),
        counts=counts_np.astype(np.int32),
        k=cfg.k,
        pos=pos_runs,
        rid=rid_runs,
    )


def count_flat_ext(
    codes: np.ndarray, valid: np.ndarray, rid: np.ndarray, pos: np.ndarray,
    cfg: KmerConfig, device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Extension-mode counting of a flat batch with its per-position read id
    and position in read. Returns (list with occurrences, histogram)."""
    dev = resolve_device(device)
    lower, upper = UNFILTERED if cfg.unfiltered else (cfg.lower, cfg.upper)
    outs = _count_device_ext(
        torch.as_tensor(np.asarray(codes, dtype=np.int8)).to(dev),
        torch.as_tensor(np.asarray(valid, dtype=bool)).to(dev),
        torch.as_tensor(np.asarray(rid).astype(np.int32)).to(dev),
        torch.as_tensor(np.asarray(pos).astype(np.uint32).view(np.int32)).to(dev),
        cfg.k, lower, upper,
    )
    result = assemble_ext_result(*outs, cfg)
    return result, host_histogram(result.counts, cfg.upper)


def count_reads_ext(
    codes: np.ndarray, lengths: np.ndarray, cfg: KmerConfig,
    read_id_offset: int = 0, device="cuda",
) -> tuple[KmerListExt, np.ndarray]:
    """Extension-mode single-device pipeline from host reads; read ids
    count from read_id_offset."""
    from .io import fasta as fasta_io

    flat, valid, rid, pos = fasta_io.flatten_for_device_ext(
        codes, lengths, cfg.k, cfg.pad_multiple, read_id_offset
    )
    return count_flat_ext(flat, valid, rid, pos, cfg, device=device)


def merge_ext_partials(
    partials: list[KmerListExt], lower: int, upper: int, k: int, words: int
) -> KmerListExt:
    """Merge unfiltered per-batch extension partials into one filtered
    result, on the host.

    Each partial holds distinct keys with their occurrence runs from one
    bounded device batch; equal keys across batches are summed and their
    occurrence lists concatenated (order-free semantics, matching the
    reference's EXTENSION count_sorted_kmers accumulation,
    src/kmerops.cpp:1430-1438). The [L, U] filter applies to the merged
    totals only, exactly the reference's bounded-round behaviour, where
    nothing in the exchange loop is EXT-conditional (kmerops.cpp:906-1007).
    """
    nonempty = [p for p in partials if len(p)]
    if not nonempty:
        return KmerListExt(
            keys=np.zeros((0, words), np.uint32),
            counts=np.zeros(0, np.int32),
            k=k,
        )
    all_keys = np.concatenate([p.keys for p in nonempty], axis=0)
    all_cnts = np.concatenate([p.counts for p in nonempty]).astype(np.int64)
    occ_pos = [a for p in nonempty for a in p.pos]
    occ_rid = [a for p in nonempty for a in p.rid]

    order = np.lexsort(
        tuple(all_keys[:, w] for w in range(all_keys.shape[1] - 1, -1, -1))
    )
    keys_s = all_keys[order]
    head = np.ones(keys_s.shape[0], dtype=bool)
    head[1:] = (keys_s[1:] != keys_s[:-1]).any(axis=1)
    group_starts = np.flatnonzero(head)
    # Integer segment sums (np.bincount weights would accumulate in f64,
    # exact only below 2^53).
    totals = np.add.reduceat(all_cnts[order], group_starts)
    keep = (totals >= lower) & (totals <= upper)

    # Vectorized occurrence assembly: one flat concatenate, one ragged
    # gather that lays every entry's occurrence run out in group order,
    # then kept groups are contiguous slice views: no per-group Python
    # concatenates.
    lens = np.fromiter(
        (a.size for a in occ_pos), dtype=np.int64, count=len(occ_pos)
    )
    entry_starts = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=entry_starts[1:])
    flat_pos = np.concatenate(occ_pos)
    flat_rid = np.concatenate(occ_rid)
    l_ord = lens[order]
    total_occ = int(l_ord.sum())
    out_starts = np.zeros(l_ord.size, dtype=np.int64)
    np.cumsum(l_ord[:-1], out=out_starts[1:])
    gather_idx = (
        np.arange(total_occ, dtype=np.int64)
        - np.repeat(out_starts, l_ord)
        + np.repeat(entry_starts[order], l_ord)
    )
    pos_sorted = flat_pos[gather_idx]
    rid_sorted = flat_rid[gather_idx]
    group_occ = np.add.reduceat(l_ord, group_starts)
    occ_out_starts = np.zeros(group_occ.size, dtype=np.int64)
    np.cumsum(group_occ[:-1], out=occ_out_starts[1:])
    kept = np.flatnonzero(keep)
    pos_out, rid_out = split_occurrences(
        occ_out_starts[kept], group_occ[kept], pos_sorted, rid_sorted
    )
    return KmerListExt(
        keys=keys_s[head][keep],
        counts=totals[keep].astype(np.int32),
        k=k,
        pos=pos_out,
        rid=rid_out,
    )
