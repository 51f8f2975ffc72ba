"""Supermer wire format: minimizer-run compression of the k-mer stream.

The port of hysortk_tpu/io/supermer.py (host numpy, no device work), the
host-side analogue of the reference's SupermerEncoder + 2-bit repacking
(src/kmerops.cpp:1096-1148, include/supermer.hpp). A supermer is a maximal
run of consecutive k-mers (within one read) sharing a destination; shipping
the run's L bases instead of its L-k+1 separate keys compresses the wire by
~(k-m)/2x. `pack_codes_2bit` is the wire of every sharded path; the
encoders are the reference that the supermer route's send side on the
device (ops/supermer, parallel/supermer_route.py) is held to.

The run boundaries (destination change / read boundary / 250-base cap,
MAX_SUPERMER_LEN at reference supermer.hpp:20), the run gather and the
2-bit pack run in the port's host library (io/native.py); each has a numpy
plain version here (`run_boundaries_plain`: mask arithmetic;
`gather_runs_plain`: one vectorized index; `pack_codes_2bit_plain`: a
byte-wise pack) with the same results. `encode_supermers`' payload packing
is numpy bit-shift reductions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_SUPERMER_LEN = 250  # bases; reference include/supermer.hpp:20


@dataclasses.dataclass
class SupermerBatch:
    """One destination bucket's supermers, wire-ready.

    lengths: (S,) uint32 — supermer lengths in bases (each >= k)
    payload: (sum ceil(len/4),) uint8 — per-supermer 2-bit packed bases,
             4 bases/byte, big-endian within the byte (base j at shift
             6-2*(j%4)), each supermer starting on a fresh byte — the
             reference's exact packing (dnaseq.hpp:33-172).
    """

    lengths: np.ndarray
    payload: np.ndarray

    def num_kmers(self, k: int) -> int:
        if self.lengths.size == 0:
            return 0
        return int((self.lengths.astype(np.int64) - k + 1).sum())

    def nbytes(self) -> int:
        return int(self.lengths.nbytes + self.payload.nbytes)


def run_boundaries(
    valid: np.ndarray, dest: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Supermer run decomposition of the flat k-mer stream.

    A run is a maximal stretch of consecutive valid k-mers sharing a
    destination, capped at MAX_SUPERMER_LEN bases (the reference's
    SupermerEncoder boundary rule, src/kmerops.cpp:1096-1148). Returns
    (run_start_flat, run_bases, run_dest), all int64; dest is only read
    where valid.
    """
    max_kmers = MAX_SUPERMER_LEN - k + 1
    from . import native

    if native.available():
        starts, kmers, run_dest = native.run_boundaries(valid, dest, max_kmers)
    else:
        starts, kmers, run_dest = run_boundaries_plain(valid, dest, max_kmers)
    return starts, kmers + k - 1, run_dest.astype(np.int64)


def run_boundaries_plain(
    valid: np.ndarray, dest: np.ndarray, max_kmers: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of `native.run_boundaries`: (run_start_flat,
    run_kmers int64, run_dest int32), a run cut every max_kmers k-mers."""
    idx = np.flatnonzero(valid.astype(bool))
    if idx.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int32)

    d = dest[idx].astype(np.int64)
    # A new run starts at the first valid k-mer, at a non-adjacent flat
    # position (read boundary or gap) and at a destination change.
    gap = np.empty(idx.size, dtype=bool)
    gap[0] = True
    gap[1:] = (idx[1:] != idx[:-1] + 1) | (d[1:] != d[:-1])
    # The 250-base cap within runs: a run of R k-mers spans R + k - 1 bases.
    ar = np.arange(idx.size)
    pos_in_run = ar - np.maximum.accumulate(np.where(gap, ar, 0))
    del ar
    gap |= (pos_in_run % max_kmers == 0) & (pos_in_run > 0)
    del pos_in_run

    starts = np.flatnonzero(gap)
    run_kmers = np.diff(np.concatenate([starts, [idx.size]]))
    return idx[starts], run_kmers.astype(np.int64), d[starts].astype(np.int32)


def encode_supermers(
    codes: np.ndarray,
    valid: np.ndarray,
    dest: np.ndarray,
    k: int,
    num_buckets: int,
) -> list[SupermerBatch]:
    """Split the flat stream into per-destination supermers.

    codes/valid/dest are the flat arrays (dest only meaningful where valid).
    Returns one SupermerBatch per destination bucket.
    """
    run_start_flat, run_bases, run_dest = run_boundaries(valid, dest, k)
    if run_start_flat.size == 0:
        return [
            SupermerBatch(np.zeros(0, np.uint32), np.zeros(0, np.uint8))
            for _ in range(num_buckets)
        ]
    batches = []
    for b in range(num_buckets):
        sel = np.flatnonzero(run_dest == b)
        batches.append(_pack_runs(codes, run_start_flat[sel], run_bases[sel]))
    return batches


def encode_supermer_streams(
    codes: np.ndarray,
    valid: np.ndarray,
    dest: np.ndarray,
    k: int,
    num_buckets: int,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-destination supermer run streams for the device wire.

    Same run decomposition as encode_supermers, but each destination's
    payload stays the flat concatenation of its supermers' base codes (the
    2-bit packing happens once at the wire, pack_codes_2bit), split by a
    lengths array: the shape ops/wire.decode_block consumes, where every
    supermer plays the role of a short read. Returns [(codes int8, lengths
    uint32)] per destination. Wire density = lengths bytes + bases/4, the
    reference's supermer exchange format (src/kmerops.cpp:1096-1148).
    """
    run_start_flat, run_bases, run_dest = run_boundaries(valid, dest, k)
    out = []
    for b in range(num_buckets):
        sel = np.flatnonzero(run_dest == b)
        st = run_start_flat[sel]
        ln = run_bases[sel]
        out.append((_gather_stream(codes, st, ln), ln.astype(np.uint32)))
    return out


def _gather_stream(
    codes: np.ndarray, starts: np.ndarray, bases: np.ndarray
) -> np.ndarray:
    """Concatenate codes[start : start+bases) per run."""
    total = int(bases.sum())
    if total == 0:
        return np.zeros(0, np.int8)
    off = np.concatenate([[0], np.cumsum(bases.astype(np.int64))[:-1]])
    from . import native

    gather = native.gather_runs if native.available() else gather_runs_plain
    return gather(codes.astype(np.int8, copy=False), starts.astype(np.int64),
                  bases.astype(np.int64), off, total)


def gather_runs_plain(
    codes: np.ndarray,
    starts: np.ndarray,
    bases: np.ndarray,
    out_off: np.ndarray,
    total: int,
) -> np.ndarray:
    """The plain version of `native.gather_runs`: one vectorized index. It
    holds int64 index arrays over every gathered base; each goes as soon as
    it is used."""
    sup = np.repeat(np.arange(bases.size, dtype=np.int64), bases)
    idx = np.arange(total, dtype=np.int64)
    idx -= out_off[sup]
    idx += starts[sup]
    del sup
    return codes[idx].astype(np.int8)


def _pack_runs(
    codes: np.ndarray, starts: np.ndarray, lengths: np.ndarray
) -> SupermerBatch:
    """Pack runs codes[starts[s] : starts[s]+lengths[s]] 4 bases/byte,
    each run starting on a fresh byte (one flat gather per byte lane, no
    per-run Python loop)."""
    lengths = lengths.astype(np.uint32)
    if lengths.size == 0:
        return SupermerBatch(lengths, np.zeros(0, np.uint8))
    nbytes = (lengths.astype(np.int64) + 3) // 4
    out_off = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    total = int(nbytes.sum())
    sup = np.repeat(np.arange(lengths.size, dtype=np.int64), nbytes)
    byte_in_sup = np.arange(total, dtype=np.int64) - out_off[sup]
    base0 = starts.astype(np.int64)[sup] + byte_in_sup * 4
    lb = lengths.astype(np.int64)[sup]
    vals = np.zeros(total, dtype=np.uint8)
    limit = max(int(codes.size) - 1, 0)
    for j in range(4):
        in_range = byte_in_sup * 4 + j < lb
        idx = np.minimum(base0 + j, limit)
        v = np.where(in_range, codes[idx].astype(np.uint8), 0)
        vals = (vals << 2) | v
    return SupermerBatch(lengths, vals)


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Flat base codes -> uint32 wire words, 16 bases/word big-endian.

    The host side of the device decode in ops/wire.py: word w holds bases
    16w..16w+15, base b at shift 30 - 2*(b%16). ~2 bits/base on the wire
    (vs 8 for int8 codes), matching the reference's 2-bit supermer payload
    density (src/kmerops.cpp:1096-1148). A length that is not a multiple of
    16 (the last word zero-filled) takes the plain version."""
    from . import native

    if codes.size % 16 == 0 and native.available():
        return native.pack_2bit(codes)
    return pack_codes_2bit_plain(codes)


def pack_codes_2bit_into(codes: np.ndarray, out: np.ndarray) -> np.ndarray:
    """`pack_codes_2bit` of codes zero-padded to out's length x 16, written
    into `out` ((W,) uint32 or int32, W >= ceil(len(codes) / 16)): the
    codes are read in place and no padded copy of them is made."""
    from . import native

    if native.available():
        return native.pack_2bit(codes, out)
    words = out.view(np.uint32)
    packed = pack_codes_2bit_plain(codes)
    if packed.size > words.size:
        raise ValueError(f"pack: {codes.size} codes do not fit {words.size} words")
    words[: packed.size] = packed
    words[packed.size:] = 0
    return out


def pack_codes_2bit_plain(codes: np.ndarray) -> np.ndarray:
    """The plain version of `native.pack_2bit`, any length: four codes to a
    byte (base j of the four at shift 6 - 2j), then each four bytes read as
    one big-endian uint32."""
    n = int(codes.size)
    c = np.zeros(n + (-n % 16), dtype=np.uint8)
    c[:n] = codes
    c &= 3
    q = c.reshape(-1, 4)
    packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return packed.view(">u4").astype(np.uint32)


def decode_supermers(
    batch: SupermerBatch, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """SupermerBatch -> flat (codes, valid) ready for the device pipeline.

    Each supermer is decoded back to its base codes; every window of k bases
    inside one supermer is a valid k-mer (the receive-side parse the
    reference does in GatheredSupermer::receive_from_buffer_stage2,
    src/kmerops.cpp:484-521).
    """
    if batch.lengths.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, bool)
    lengths = batch.lengths.astype(np.int64)
    nbytes = (lengths + 3) // 4
    byte_off = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    base_off = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    total_bases = int(lengths.sum())

    # Unpack every payload byte to 4 codes at once, then one vectorized
    # gather maps each output base to its (supermer, offset) source.
    b = batch.payload
    all4 = np.stack(
        [(b >> 6) & 3, (b >> 4) & 3, (b >> 2) & 3, b & 3], axis=1
    ).reshape(-1)
    sup = np.repeat(np.arange(lengths.size, dtype=np.int64), lengths)
    base_in_sup = np.arange(total_bases, dtype=np.int64) - base_off[sup]
    codes = all4[byte_off[sup] * 4 + base_in_sup].astype(np.uint8)
    valid = base_in_sup <= lengths[sup] - k
    return codes, valid


def supermer_stats(batches: list[SupermerBatch], k: int, words: int) -> dict:
    """Wire-size accounting: supermer bytes vs raw packed-key bytes."""
    total_kmers = sum(b.num_kmers(k) for b in batches)
    wire = sum(b.nbytes() for b in batches)
    raw = total_kmers * words * 4
    return {
        "supermers": int(sum(b.lengths.size for b in batches)),
        "kmers": int(total_kmers),
        "wire_bytes": int(wire),
        "raw_key_bytes": int(raw),
        "compression": (raw / wire) if wire else float("inf"),
    }


def encode_supermer_streams_ext(
    codes: np.ndarray,
    valid: np.ndarray,
    dest: np.ndarray,
    k: int,
    num_buckets: int,
    read_lengths: np.ndarray,
    read_id_offset: int = 0,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Extension-mode variant of encode_supermer_streams: each destination
    also carries per-supermer (rid0, pos0), the read id and in-read position
    of the run's first base, the reference's EXT supermer header ({len,
    pos, rid}, include/kmer.hpp:348-360): +8 B/supermer on the wire; the
    per-k-mer (rid, pos) follow on the device (ops/wire.fill_run_meta).
    Returns [(codes int8, lengths uint32, rid0 int32, pos0 uint32)] per
    destination.
    """
    run_start_flat, run_bases, run_dest = run_boundaries(valid, dest, k)
    read_starts = np.concatenate(
        [[0], np.cumsum(read_lengths.astype(np.int64))]
    )
    if run_start_flat.size:
        rid_all = (
            np.searchsorted(read_starts, run_start_flat, side="right") - 1
        )
        pos_all = run_start_flat - read_starts[rid_all]
    else:
        rid_all = pos_all = np.zeros(0, np.int64)
    out = []
    for b in range(num_buckets):
        sel = np.flatnonzero(run_dest == b)
        st = run_start_flat[sel]
        ln = run_bases[sel]
        out.append((
            _gather_stream(codes, st, ln),
            ln.astype(np.uint32),
            (rid_all[sel] + read_id_offset).astype(np.int32),
            pos_all[sel].astype(np.uint32),
        ))
    return out
