"""Host-side FASTA input: index, partition, parse, 2-bit pack, flatten.

The jax-free host code of hysortk_tpu/io/fasta.py: the single-device
flattener, the extension-mode one (`flatten_for_device_ext`, with each
slot's read id and position) and the multi-process read-id helpers
(`read_displacements`, `getreadowner`) carried over unchanged; the index
rebuilt by columns, with the same file and the same partition.

TPU-native redesign of the reference's FastaIndex + DnaBuffer input stage
(reference: src/fastaindex.cpp, src/dnabuffer.cpp, src/dnaseq.cpp):

  * `.fai` samtools index parsing (reference fastaindex.cpp:20-28) and
    generation when absent (the reference hard-requires a pre-built .fai),
    both by columns (`FaiIndex`: one array per column, the names in one
    blob), with no Python loop over records; the file is byte for byte
    the JAX package's.
  * Base-balanced greedy partitioning of records across shards/hosts
    (reference getpartition, fastaindex.cpp:52-100), as record bounds by
    one search a shard (`partition_bounds`).
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
import math
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


# ASCII whitespace as bytes.split() sees it: space, \t, \n, \r, \v, \f.
_SPACE = np.zeros(256, dtype=bool)
_SPACE[[0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C]] = True
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def segment_positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Positions starts[j] .. starts[j] + lens[j] - 1 of every segment j,
    end to end (one int64 array, no loop over segments): a running sum of
    steps of 1, with each segment's first step a jump to its start."""
    lens = np.asarray(lens, dtype=np.int64)
    keep = lens > 0
    starts, lens = np.asarray(starts, dtype=np.int64)[keep], lens[keep]
    if lens.size == 0:
        return np.zeros(0, dtype=np.int64)
    step = np.ones(int(lens.sum()), dtype=np.int64)
    first = np.cumsum(lens) - lens
    step[first] = starts - np.concatenate([[1], starts[:-1] + lens[:-1]]) + 1
    return np.cumsum(step, out=step)


@dataclasses.dataclass(frozen=True, eq=False)
class FaiIndex:
    """A `.fai` index by columns: one int64 array per numeric column and the
    record names end to end in one UTF-8 blob (name i is
    `names_blob[name_offsets[i]:name_offsets[i + 1]]`).

    `index[i]` and `records()` build FaiRecords on demand; `index[a:b]` is
    the index of records a..b-1, its arrays views of this one's. The main
    path (index, partition, read) asks for no record object."""

    names_blob: bytes
    name_offsets: np.ndarray  # (n + 1,) int64
    length: np.ndarray
    offset: np.ndarray
    linebases: np.ndarray
    linewidth: np.ndarray

    def __len__(self) -> int:
        return int(self.length.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                raise ValueError("an index slice takes contiguous records")
            hi = max(hi, lo)
            return FaiIndex(self.names_blob, self.name_offsets[lo:hi + 1],
                            self.length[lo:hi], self.offset[lo:hi],
                            self.linebases[lo:hi], self.linewidth[lo:hi])
        i = range(len(self))[i]
        return FaiRecord(self.name(i), int(self.length[i]), int(self.offset[i]),
                         int(self.linebases[i]), int(self.linewidth[i]))

    def __eq__(self, other) -> bool:
        """Equal to an index of the same records, or to a sequence of the
        FaiRecords it holds (the JAX package's form)."""
        if isinstance(other, FaiIndex):
            return self.names == other.names and all(
                np.array_equal(getattr(self, c), getattr(other, c))
                for c in ("length", "offset", "linebases", "linewidth"))
        if isinstance(other, Sequence) and not isinstance(other, (str, bytes)):
            return len(self) == len(other) and self.records() == list(other)
        return NotImplemented

    __hash__ = None

    def name(self, i: int) -> str:
        return self.names_blob[self.name_offsets[i]:self.name_offsets[i + 1]].decode()

    @property
    def names(self) -> list[str]:
        return [self.name(i) for i in range(len(self))]

    def records(self) -> list[FaiRecord]:
        return [self[i] for i in range(len(self))]

    @classmethod
    def from_records(cls, records: Sequence[FaiRecord]) -> "FaiIndex":
        names = [r.name.encode() for r in records]
        name_offsets = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in names], out=name_offsets[1:])
        cols = np.array([(r.length, r.offset, r.linebases, r.linewidth)
                         for r in records], dtype=np.int64).reshape(-1, 4)
        return cls(b"".join(names), name_offsets,
                   *(np.ascontiguousarray(c) for c in cols.T))

    def to_bytes(self) -> bytes:
        """The `.fai` text, `name\\tlength\\toffset\\tlinebases\\tlinewidth\\n`
        a record, built by columns: names by one ragged gather, each number
        by its decimal digits."""
        n = len(self)
        if n == 0:
            return b""
        cols = [np.asarray(c, dtype=np.int64) for c in
                (self.length, self.offset, self.linebases, self.linewidth)]
        if any(int(c.min()) < 0 for c in cols):
            raise ValueError("a .fai column holds a negative number")
        ndig = [np.maximum(np.searchsorted(_POW10, c, side="right"), 1) for c in cols]
        name_off = self.name_offsets - self.name_offsets[0]
        name_len = np.diff(name_off)
        line_len = name_len + sum(ndig) + 5
        out = np.empty(int(line_len.sum()), dtype=np.uint8)
        at = np.cumsum(line_len) - line_len
        blob = np.frombuffer(self.names_blob, dtype=np.uint8)[self.name_offsets[0]:]
        out[segment_positions(at, name_len)] = blob[
            segment_positions(name_off[:-1], name_len)]
        at = at + name_len
        for col, nd in zip(cols, ndig):
            out[at] = ord("\t")
            at = at + 1
            for d in range(int(nd.max())):
                rows = np.flatnonzero(nd > d)
                digit = col[rows] // _POW10[nd[rows] - 1 - d] % 10
                out[at[rows] + d] = digit + ord("0")
            at = at + nd
        out[at] = ord("\n")
        return out.tobytes()


def _empty_index() -> FaiIndex:
    z = np.zeros(0, dtype=np.int64)
    return FaiIndex(b"", np.zeros(1, dtype=np.int64), z, z.copy(), z.copy(), z.copy())


def _parse_fai_plain(path: str) -> FaiIndex:
    """parse_fai line by line: the JAX package's loop, for the files that
    are not tab-separated columns throughout."""
    records = []
    with open(path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            name, length, offset, linebases, linewidth = line.split()[:5]
            records.append(
                FaiRecord(name, int(length), int(offset), int(linebases), int(linewidth))
            )
    return FaiIndex.from_records(records)


def parse_fai(path: str) -> FaiIndex:
    """Read a `.fai` index by columns: one read of the file, the positions
    of its tabs and newlines, each line's fields between them. A file that
    is not such columns throughout (blank lines, spaces, \r, non-ASCII or
    control bytes, fields with a sign or beyond 18 digits, lines that differ
    in their field count) takes the JAX package's line loop, which skips
    blank lines; both ignore the fields past the fifth (a FASTQ index has
    six)."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size == 0:
        return _empty_index()
    tabs = np.flatnonzero(data == ord("\t"))
    ends = np.flatnonzero(data == ord("\n"))
    # Below 0x21 only the tabs and newlines, nothing above 0x7e.
    if (np.count_nonzero(data < 0x21) != tabs.size + ends.size
            or int(data.max()) > 0x7E):
        return _parse_fai_plain(path)
    if data[-1] != ord("\n"):
        ends = np.append(ends, data.size)
    n = ends.size
    if tabs.size < 4 * n or tabs.size % n:
        return _parse_fai_plain(path)
    # Field f of line i is [bound[i, f] + 1, bound[i, f + 1]); every field
    # non-empty holds every line's tabs inside it, in order.
    bound = np.empty((n, tabs.size // n + 2), dtype=np.int64)
    bound[0, 0] = -1
    bound[1:, 0] = ends[:-1]
    bound[:, 1:-1] = tabs.reshape(n, -1)
    bound[:, -1] = ends
    if (np.diff(bound, axis=1) < 2).any():
        return _parse_fai_plain(path)
    cols = []
    bad = np.zeros(n, dtype=bool)
    for f in range(1, 5):
        # Horner's rule over a w-byte window ending at the field's end: the
        # bytes before the field count 0, so the value starts at its first
        # digit.
        stop, width = bound[:, f + 1], bound[:, f + 1] - bound[:, f] - 1
        w = int(width.max())
        if w > 18:
            return _parse_fai_plain(path)
        value = np.zeros(n, dtype=np.int64)
        for j in range(w):
            inside = width >= w - j
            digit = data[np.maximum(stop - (w - j), 0)] - np.uint8(ord("0"))
            bad |= inside & (digit > 9)  # below '0' wraps above 9
            digit *= inside
            value *= 10
            value += digit
        cols.append(value)
    if bad.any():
        return _parse_fai_plain(path)
    name_lo = bound[:, 0] + 1
    name_len = bound[:, 1] - name_lo
    name_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(name_len, out=name_offsets[1:])
    names = data[segment_positions(name_lo, name_len)].tobytes()
    return FaiIndex(names, name_offsets, *cols)


def generate_fai(fasta_path: str, fai_path: Optional[str] = None) -> FaiIndex:
    """Build the .fai index by one scan of the FASTA (the host library's
    `native.fai_build`; its plain version is `fai_columns_plain`), and
    write it to fai_path where one is given. A header without a name raises
    IndexError. An empty FASTA gives an empty index and writes no file."""
    with open(fasta_path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size == 0:
        return _empty_index()
    from . import native

    if native.available():
        cols, name_lo, name_hi, text = native.fai_build(data)
    else:
        (cols, name_lo, name_hi), text = fai_columns_plain(data), None
    missing = name_hi <= name_lo
    if missing.any():
        raise IndexError(f"the header line of record {int(np.argmax(missing))} "
                         "has no name")
    name_len = name_hi - name_lo
    name_offsets = np.zeros(name_len.size + 1, dtype=np.int64)
    np.cumsum(name_len, out=name_offsets[1:])
    names = data[segment_positions(name_lo, name_len)].tobytes()
    names.decode()  # UTF-8, as FaiRecord.name holds it
    index = FaiIndex(names, name_offsets, *cols)
    if fai_path:
        with open(fai_path, "wb") as f:
            f.write(index.to_bytes() if text is None else text)
    return index


def fai_columns_plain(
    data: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of `native.fai_build`, by array arithmetic: line
    bounds from the newline positions, header lines, each record's columns
    from its sequence lines by prefix sums, its name by one search over the
    header bytes. Returns ((4, n) columns, name_lo, name_hi)."""
    nl = np.flatnonzero(data == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    line_ends = np.concatenate([nl, [data.size]])  # exclusive of newline
    # Drop the phantom line after a trailing newline.
    if line_starts[-1] >= data.size:
        line_starts, line_ends = line_starts[:-1], line_ends[:-1]
    n_lines = line_starts.size
    heads = np.flatnonzero(data[line_starts] == ord(">"))
    if heads.size == 0:
        none = np.zeros(0, dtype=np.int64)
        return np.zeros((4, 0), dtype=np.int64), none, none.copy()
    first = heads + 1                          # each record's first sequence line
    n_seq = np.append(heads[1:], n_lines) - first
    # Line lengths without a trailing \r (CRLF files); a sequence line never
    # starts the file, so its end - 1 is inside it or its line break.
    cr = data[np.maximum(line_ends - 1, 0)] == ord("\r")
    lens = line_ends - line_starts - cr
    csum = np.zeros(n_lines + 1, dtype=np.int64)
    np.cumsum(lens, out=csum[1:])
    total = csum[first + n_seq] - csum[first]
    at = np.minimum(first, n_lines - 1)
    nxt = np.minimum(first + 1, n_lines - 1)
    multi = n_seq > 1
    has = n_seq > 0
    cols = np.stack([
        np.where(has, total, 0),
        np.where(has, line_starts[at], line_ends[heads] + 1),
        np.where(has, np.maximum(np.where(multi, lens[at], total), 1), 0),
        np.where(has, np.maximum(
            np.where(multi, line_starts[nxt] - line_starts[at], total + 1), 1), 0),
    ]).astype(np.int64)

    # Names: the first whitespace-separated field of each header's text.
    h_start = line_starts[heads] + 1
    h_end = line_ends[heads]
    pos = segment_positions(h_start, h_end - h_start)
    space = _SPACE[data[pos]]
    # Each ends in pos.size, so that every search lands inside.
    solid = np.append(np.flatnonzero(~space), pos.size)
    gaps = np.append(np.flatnonzero(space), pos.size)
    seg = np.cumsum(h_end - h_start) - (h_end - h_start)
    a = np.minimum(solid[np.searchsorted(solid, seg)], seg + h_end - h_start)
    b = np.minimum(gaps[np.searchsorted(gaps, a)], seg + h_end - h_start)
    return cols, h_start + a - seg, h_start + b - seg


def load_or_build_fai(fasta_path: str) -> FaiIndex:
    fai_path = fasta_path + ".fai"
    if os.path.exists(fai_path):
        return parse_fai(fai_path)
    try:
        return generate_fai(fasta_path, fai_path)
    except OSError:
        return generate_fai(fasta_path, None)


def _as_index(records) -> FaiIndex:
    return records if isinstance(records, FaiIndex) else FaiIndex.from_records(records)


def partition_bounds(records, num_shards: int) -> np.ndarray:
    """Contiguous partition of the records balancing total bases, as its
    num_shards + 1 record bounds (shard s holds records bounds[s] ..
    bounds[s + 1] - 1; bounds[s] is also the global index of its first
    read, the reference's readdispls).

    The greedy of the reference's getpartition (fastaindex.cpp:52-100), as
    the JAX package's loop over records runs it, by one search a shard: a
    shard ends before the first record i (after its own first) at which
    acc + length[i] / 2 > total / num_shards, acc being the shard's bases
    so far and above 0 (so zero-length records stay with the shard), or
    sooner where only as many records are left as the shards after it need
    one each. The comparison is exact for totals below 2^51 bases."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    lengths = np.asarray(_as_index(records).length, dtype=np.int64)
    n = lengths.size
    csum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=csum[1:])
    # acc + length[i] / 2 > target  <=>  2 csum[i] + length[i] > 2 target +
    # 2 csum[p] over integers, p the shard's first record.
    twice = 2 * csum[:-1] + lengths
    twice_target = math.floor(2 * (int(csum[-1]) / num_shards))
    bounds = np.full(num_shards + 1, n, dtype=np.int64)
    bounds[0] = 0
    p, check = 0, 0
    for s in range(num_shards - 1):
        by_bases = max(
            int(np.searchsorted(twice, twice_target + 2 * int(csum[p]), side="right")),
            int(np.searchsorted(csum[:-1], csum[p], side="right")))
        must = max(n - num_shards + s + 1, check)
        cut = min(by_bases, must)
        if cut >= n:
            break
        bounds[s + 1] = cut
        p, check = cut, cut + 1
    return bounds


def partition_records(records, num_shards: int) -> list[list[int]]:
    """partition_bounds as lists of record indices, one a shard: the JAX
    package's form."""
    b = partition_bounds(records, num_shards).tolist()
    return [list(range(lo, hi)) for lo, hi in zip(b[:-1], b[1:])]


def read_displacements(parts: Sequence[Sequence[int]]) -> np.ndarray:
    """Per-shard read displacements for a partition_records() result:
    displs[s] = global id of shard s's first read; displs[n_shards] = total
    reads. The analogue of the reference's readdispls vector
    (fastaindex.hpp:23, built in fastaindex.cpp:102-130) — valid because
    partition_records assigns CONTIGUOUS ranges (partition_bounds gives the
    same array directly)."""
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
    fasta_path: str, records
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One contiguous byte range covering the records (a FaiIndex, or a
    slice of one), like the reference's per-rank seek+read
    (fastaindex.cpp:248-252), with each record's place in it: (raw uint8,
    raw_off, seq_len, line_bases, line_width), the arguments of
    `strip_and_pack_plain` and `native.strip_and_pack`."""
    index = _as_index(records)
    lo = int(index.offset.min())
    last = int(np.argmax(index.offset))
    length, linebases, linewidth = (int(c[last]) for c in
                                    (index.length, index.linebases, index.linewidth))
    n_lines_last = (length + linebases - 1) // max(linebases, 1)
    hi = int(index.offset[last]) + length + n_lines_last * max(linewidth - linebases, 1)
    with open(fasta_path, "rb") as f:
        f.seek(lo)
        raw = np.frombuffer(f.read(hi - lo), dtype=np.uint8)
    return (raw, index.offset - lo, *(np.ascontiguousarray(c, dtype=np.int64) for c in
                                      (index.length, index.linebases, index.linewidth)))


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


def read_records(fasta_path: str, records) -> tuple[np.ndarray, np.ndarray]:
    """Read+pack the given records (a FaiIndex, or a slice of one). Returns
    (codes uint8 flat, lengths int64).

    Reads one contiguous byte range covering the records, then strips
    newlines and maps ASCII->code in the host library; a range holding a
    `\r` (CRLF lines) takes the numpy plain version, whose mask drops it.
    """
    if len(records) == 0:
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
