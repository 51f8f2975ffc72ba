"""Host-side FASTA input: index, partition, parse, 2-bit pack, flatten.

The jax-free host code of hysortk_tpu/io/fasta.py, carried over unchanged:
the single-device flattener, the extension-mode one
(`flatten_for_device_ext`, with each slot's read id and position), and the
multi-process read-id helpers (`read_displacements`, `getreadowner`).

TPU-native redesign of the reference's FastaIndex + DnaBuffer input stage
(reference: src/fastaindex.cpp, src/dnabuffer.cpp, src/dnaseq.cpp):

  * `.fai` samtools index parsing (reference fastaindex.cpp:20-28) and
    generation when absent (the reference hard-requires a pre-built .fai).
  * Base-balanced greedy partitioning of records across shards/hosts
    (reference getpartition, fastaindex.cpp:52-100).
  * Each shard reads only its own byte range and parses it vectorized with
    numpy (the reference strips newlines per record in a scalar loop,
    fastaindex.cpp:248-293; here it is mask arithmetic over the raw bytes).
  * Bases are 2-bit coded A/a=0 C/c=1 G/g=2 T/t=3, N and anything else -> 0
    (=A), identical to reference DnaSeq::codetab (include/dnaseq.hpp:130-140).

The device-facing product is a *flat* representation: one concatenated code
stream for all reads plus a boolean "a k-mer window may start here" mask —
no ragged/padded 2-D read matrix ever reaches the device.

The byte->code hot loop runs in the port's host library
(csrc/host_io.cpp via io/native.py); its numpy plain version,
`strip_and_pack_plain`, is the semantics oracle of the tests and the route
for files with `\r` line ends.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

# 256-entry ASCII -> 2-bit code LUT (semantics of reference dnaseq.hpp codetab).
CODE_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    CODE_LUT[ord(_ch)] = _code
    CODE_LUT[ord(_ch.lower())] = _code


@dataclasses.dataclass(frozen=True)
class FaiRecord:
    """One `.fai` line: samtools faidx format (reference fastaindex.cpp:20-28)."""

    name: str
    length: int      # bases
    offset: int      # byte offset of first base in the FASTA
    linebases: int   # bases per line
    linewidth: int   # bytes per line (incl. newline)


def parse_fai(path: str) -> list[FaiRecord]:
    records = []
    with open(path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            name, length, offset, linebases, linewidth = line.split()[:5]
            records.append(
                FaiRecord(name, int(length), int(offset), int(linebases), int(linewidth))
            )
    return records


def generate_fai(fasta_path: str, fai_path: Optional[str] = None) -> list[FaiRecord]:
    """Build the .fai index by scanning the FASTA (vectorized)."""
    with open(fasta_path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size == 0:
        return []
    nl = np.flatnonzero(data == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    line_ends = np.concatenate([nl, [data.size]])  # exclusive of newline
    # Drop the phantom line after a trailing newline.
    keep = line_starts < data.size
    line_starts, line_ends = line_starts[keep], line_ends[keep]
    is_header = data[line_starts] == ord(">")

    records: list[FaiRecord] = []
    header_idx = np.flatnonzero(is_header)
    n_lines = line_starts.size
    for hi_pos, hi in enumerate(header_idx):
        next_h = header_idx[hi_pos + 1] if hi_pos + 1 < header_idx.size else n_lines
        name = bytes(data[line_starts[hi] + 1 : line_ends[hi]]).split()[0].decode()
        seq_lines = np.arange(hi + 1, next_h)
        if seq_lines.size == 0:
            records.append(FaiRecord(name, 0, int(line_ends[hi]) + 1, 0, 0))
            continue
        lens = (line_ends[seq_lines] - line_starts[seq_lines]).astype(np.int64)
        # Strip trailing \r if present (CRLF files).
        cr = data[np.minimum(line_ends[seq_lines] - 1, data.size - 1)] == ord("\r")
        lens = lens - cr.astype(np.int64)
        total = int(lens.sum())
        linebases = int(lens[0]) if seq_lines.size > 1 else total
        linewidth = (
            int(line_starts[seq_lines[1]] - line_starts[seq_lines[0]])
            if seq_lines.size > 1
            else total + 1
        )
        records.append(
            FaiRecord(name, total, int(line_starts[seq_lines[0]]), max(linebases, 1), max(linewidth, 1))
        )
    if fai_path:
        with open(fai_path, "w") as f:
            for r in records:
                f.write(f"{r.name}\t{r.length}\t{r.offset}\t{r.linebases}\t{r.linewidth}\n")
    return records


def load_or_build_fai(fasta_path: str) -> list[FaiRecord]:
    fai_path = fasta_path + ".fai"
    if os.path.exists(fai_path):
        return parse_fai(fai_path)
    try:
        return generate_fai(fasta_path, fai_path)
    except OSError:
        return generate_fai(fasta_path, None)


def partition_records(
    records: Sequence[FaiRecord], num_shards: int
) -> list[list[int]]:
    """Contiguous partition of record indices balancing total bases.

    Same objective as the reference's greedy getpartition
    (fastaindex.cpp:52-100): contiguous ranges, each shard's base total as
    close as possible to the mean.
    """
    total = sum(r.length for r in records)
    target = total / max(num_shards, 1)
    parts: list[list[int]] = [[] for _ in range(num_shards)]
    shard, acc = 0, 0
    for i, rec in enumerate(records):
        remaining_recs = len(records) - i
        remaining_shards = num_shards - shard
        # Never starve trailing shards of records.
        must_advance = remaining_recs <= remaining_shards - 1
        if shard < num_shards - 1 and (
            must_advance or (acc > 0 and acc + rec.length / 2 > target)
        ):
            shard += 1
            acc = 0
        parts[shard].append(i)
        acc += rec.length
    return parts


def read_displacements(parts: Sequence[Sequence[int]]) -> np.ndarray:
    """Per-shard read displacements for a partition_records() result:
    displs[s] = global id of shard s's first read; displs[n_shards] = total
    reads. The analogue of the reference's readdispls vector
    (fastaindex.hpp:23, built in fastaindex.cpp:102-130) — valid because
    partition_records assigns CONTIGUOUS ranges."""
    displs = np.zeros(len(parts) + 1, dtype=np.int64)
    for s, idxs in enumerate(parts):
        displs[s + 1] = displs[s] + len(idxs)
    return displs


def getreadowner(displs: np.ndarray, read_id) -> np.ndarray:
    """Owner shard of global read id(s): the rank r with
    displs[r] <= read_id < displs[r+1]. Mirrors FastaIndex::getreadowner
    (reference fastaindex.cpp:30-50, upper_bound on readdispls); vectorized
    so downstream consumers (ELBA-style overlappers) can map whole id
    arrays at once."""
    ids = np.asarray(read_id, dtype=np.int64)
    if np.any(ids < 0) or np.any(ids >= displs[-1]):
        raise IndexError(
            f"read id out of range [0, {int(displs[-1])})"
        )
    owner = np.searchsorted(displs, ids, side="right") - 1
    return owner if ids.shape else int(owner)


def read_record_bytes(
    fasta_path: str, records: Sequence[FaiRecord]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One contiguous byte range covering the (non-empty) records, like the
    reference's per-rank seek+read (fastaindex.cpp:248-252), with each
    record's place in it: (raw uint8, raw_off, seq_len, line_bases,
    line_width), the arguments of `strip_and_pack_plain` and
    `native.strip_and_pack`."""
    lo = min(r.offset for r in records)
    last = max(records, key=lambda r: r.offset)
    n_lines_last = (last.length + last.linebases - 1) // max(last.linebases, 1)
    hi = last.offset + last.length + n_lines_last * max(
        last.linewidth - last.linebases, 1
    )
    with open(fasta_path, "rb") as f:
        f.seek(lo)
        raw = np.frombuffer(f.read(hi - lo), dtype=np.uint8)
    fields = np.array(
        [(r.offset - lo, r.length, r.linebases, r.linewidth) for r in records],
        dtype=np.int64,
    ).reshape(-1, 4)
    return raw, *(np.ascontiguousarray(col) for col in fields.T)


def strip_and_pack_plain(
    raw: np.ndarray,
    raw_off: np.ndarray,
    seq_len: np.ndarray,
    line_bases: np.ndarray,
    line_width: np.ndarray,
) -> np.ndarray:
    """The plain version of `native.strip_and_pack`: each record's span with
    its `\n` and `\r` bytes masked out, coded through CODE_LUT."""
    codes = np.empty(int(np.sum(seq_len)), dtype=np.uint8)
    out_pos = 0
    for off, length, lb, lw in zip(raw_off.tolist(), seq_len.tolist(),
                                   line_bases.tolist(), line_width.tolist()):
        n_lines = (length + lb - 1) // max(lb, 1)
        span = raw[off : off + length + n_lines * max(lw - lb, 0)]
        seq = span[(span != ord("\n")) & (span != ord("\r"))][:length]
        codes[out_pos : out_pos + seq.size] = CODE_LUT[seq]
        out_pos += seq.size
    if out_pos != codes.size:
        raise ValueError(f"parsed {out_pos} bases, expected {codes.size}")
    return codes


def read_records(
    fasta_path: str, records: Sequence[FaiRecord]
) -> tuple[np.ndarray, np.ndarray]:
    """Read+pack the given records. Returns (codes uint8 flat, lengths int64).

    Reads one contiguous byte range covering the records, then strips
    newlines and maps ASCII->code in the host library; a range holding a
    `\r` (CRLF lines) takes the numpy plain version, whose mask drops it.
    """
    if not records:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    raw, raw_off, lengths, line_bases, line_width = read_record_bytes(
        fasta_path, records)
    from . import native

    if native.available() and not np.any(raw == ord("\r")):
        return native.strip_and_pack(raw, raw_off, lengths, line_bases,
                                     line_width), lengths
    return strip_and_pack_plain(raw, raw_off, lengths, line_bases, line_width), lengths


def reads_to_codes(reads: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """In-memory reads (ASCII strings) -> (codes flat, lengths). Test helper."""
    lengths = np.array([len(r) for r in reads], dtype=np.int64)
    if lengths.sum() == 0:
        return np.zeros(0, dtype=np.uint8), lengths
    raw = np.frombuffer("".join(reads).encode(), dtype=np.uint8)
    return CODE_LUT[raw], lengths


def flatten_for_device(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int,
    pad_multiple: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """Build the device input: (codes int8 padded, kmer-start validity mask).

    valid[i] is True iff a k-mer starting at flat position i lies entirely
    inside one read. Padding (to pad_multiple, and at least 16 extra so the
    sliding packers never wrap into meaningful data) is always invalid.
    """
    n = int(codes.size)
    padded = -(-(n + 16) // pad_multiple) * pad_multiple
    out_codes = np.zeros(padded, dtype=np.int8)
    out_codes[:n] = codes
    valid = np.zeros(padded, dtype=bool)
    if lengths.size:
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pos_in_read = np.arange(n, dtype=np.int64) - np.repeat(offsets, lengths)
        read_len = np.repeat(lengths, lengths)
        valid[:n] = pos_in_read <= read_len - k
    return out_codes, valid


def flatten_for_device_ext(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int,
    pad_multiple: int = 1024,
    read_id_offset: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extension-mode device input: (codes, valid, rid, pos).

    rid[i] = global read id owning flat position i (offset by read_id_offset,
    the analogue of the reference's MPI_Exscan read-id base,
    src/kmerops.cpp:66); pos[i] = position within the read. Only meaningful at
    valid k-mer starts.
    """
    out_codes, valid = flatten_for_device(codes, lengths, k, pad_multiple)
    n = int(codes.size)
    rid = np.zeros(out_codes.shape[0], dtype=np.int32)
    pos = np.zeros(out_codes.shape[0], dtype=np.uint32)
    if lengths.size:
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        rid[:n] = np.repeat(
            np.arange(lengths.size, dtype=np.int64) + read_id_offset, lengths
        ).astype(np.int32)
        pos[:n] = (np.arange(n, dtype=np.int64) - np.repeat(offsets, lengths)).astype(
            np.uint32
        )
    return out_codes, valid, rid, pos
