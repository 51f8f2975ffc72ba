"""Host-side FASTA input: index, partition, parse, 2-bit pack, flatten.

The jax-free host code of hysortk_tpu/io/fasta.py, carried over unchanged for
one process: the single-device flattener and the extension-mode one
(`flatten_for_device_ext`, with each slot's read id and position). The
multi-host read-id helpers (`read_displacements`, `getreadowner`) are not
part of it yet.

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

When available, the native C++ parser (native/host_io.cpp via ctypes) is used
for the byte->code conversion hot loop; the numpy path is the always-correct
fallback and the semantics oracle for tests.
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


def read_records(
    fasta_path: str, records: Sequence[FaiRecord]
) -> tuple[np.ndarray, np.ndarray]:
    """Read+pack the given records. Returns (codes uint8 flat, lengths int64).

    Reads one contiguous byte range covering the records (like the reference's
    per-rank seek+read, fastaindex.cpp:248-252), then strips newlines and maps
    ASCII->code fully vectorized.
    """
    if not records:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    lo = min(r.offset for r in records)
    last = max(records, key=lambda r: r.offset)
    n_lines_last = (last.length + last.linebases - 1) // max(last.linebases, 1)
    hi = last.offset + last.length + n_lines_last * max(
        last.linewidth - last.linebases, 1
    )
    with open(fasta_path, "rb") as f:
        f.seek(lo)
        chunk = np.frombuffer(f.read(hi - lo), dtype=np.uint8)

    lengths = np.array([r.length for r in records], dtype=np.int64)
    total = int(lengths.sum())

    # Fast path: native OpenMP strip+pack (no \r handling -> numpy fallback).
    from . import native

    if native.available() and not np.any(chunk == ord("\r")):
        raw_off = np.array([r.offset - lo for r in records], dtype=np.int64)
        line_bases = np.array([r.linebases for r in records], dtype=np.int64)
        line_width = np.array([r.linewidth for r in records], dtype=np.int64)
        out = native.strip_and_pack(chunk, raw_off, lengths, line_bases, line_width)
        if out is not None:
            return out, lengths

    codes = np.empty(total, dtype=np.uint8)
    out_pos = 0
    for r in records:
        n_lines = (r.length + r.linebases - 1) // max(r.linebases, 1)
        span = r.length + n_lines * max(r.linewidth - r.linebases, 0)
        raw = chunk[r.offset - lo : r.offset - lo + span]
        seq = raw[(raw != ord("\n")) & (raw != ord("\r"))][: r.length]
        codes[out_pos : out_pos + seq.size] = CODE_LUT[seq]
        out_pos += seq.size
    assert out_pos == total, f"parsed {out_pos} bases, expected {total}"
    return codes, lengths


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
