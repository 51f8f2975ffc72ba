"""ctypes bindings for the port's host library (csrc/host_io.cpp).

The C++ loops of the host hot paths: the FASTA index scan, strip and code
of FASTA records, the
2-bit wire pack, key decode, output formatting, the supermer encoder's
run decomposition and run gather (io/supermer.py), and the one-shot
result's host pages faulted in by background workers (`prefault_start`
and the calls after it; runtime/prefault.py drives them). The library is the
port's own, built at first use by `_build.host_library_path` (std::thread,
no OpenMP); a failed build raises. Every call first hands the library
`torch.get_num_threads()` as its worker count, so ranks that share a host's
cores (spawned ranks run one thread each) split them.

Each function has a numpy plain version beside its caller
(`fasta.fai_columns_plain`, `fasta.strip_and_pack_plain`, `supermer.pack_codes_2bit_plain`,
`kmer.decode_keys_plain`, `writer.format_output_plain`,
`supermer.run_boundaries_plain`, `supermer.gather_runs_plain`) with the
same results; the page calls and `valid_kmers` have none. The callers take
the native route while `available()` is true, which it always is; tests
patch it to take the plain versions.

`calls` counts each function's calls into the library; `reset_calls`
clears it before a run whose use of the library is to be shown.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from .. import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_path: str | None = None

calls = {
    "fai_build": 0, "strip_and_pack": 0, "pack_2bit": 0, "decode_keys": 0,
    "format_output": 0, "run_boundaries": 0, "gather_runs": 0,
    "valid_kmers": 0, "prefault_start": 0,
}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def library_path() -> str:
    """Path of the loaded library (building and loading it first)."""
    _load()
    return _path


def _load() -> ctypes.CDLL:
    global _lib, _path
    with _lock:
        if _lib is None:
            path = _build.host_library_path()
            _lib = _bind(ctypes.CDLL(path))
            _path = path
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.hk_set_threads.argtypes = [i32]
    lib.hk_set_threads.restype = None
    lib.hk_fai_build.argtypes = [u8p, i64, i64, i64p, i64p, i64p, u8p, i64p]
    lib.hk_fai_build.restype = i64
    lib.hk_strip_and_pack.argtypes = [u8p, i64p, i64p, i64p, i64p, i64p, i64, u8p]
    lib.hk_strip_and_pack.restype = None
    lib.hk_decode_keys.argtypes = [u32p, i64, i32, i32, u8p]
    lib.hk_decode_keys.restype = None
    lib.hk_pack_2bit.argtypes = [u8p, i64, u32p, i64]
    lib.hk_pack_2bit.restype = None
    lib.hk_format_output.argtypes = [u32p, i32p, i64, i32, i32, u8p]
    lib.hk_format_output.restype = i64
    lib.hk_run_boundaries.argtypes = [u8p, i32p, i64, i64, i64p, i64p, i32p]
    lib.hk_run_boundaries.restype = i64
    lib.hk_gather_runs.argtypes = [i8p, i64p, i64p, i64p, i64, i8p]
    lib.hk_gather_runs.restype = None
    vp = ctypes.c_void_p
    lib.hk_valid_kmers.argtypes = [i64p, i64, i32]
    lib.hk_valid_kmers.restype = i64
    lib.hk_unmap.argtypes = [vp, i64]
    lib.hk_unmap.restype = i32
    lib.hk_prefault_start.argtypes = [i64, i64, i64, i64, i32, i64]
    lib.hk_prefault_start.restype = vp
    lib.hk_prefault_base.argtypes = [vp, i32]
    lib.hk_prefault_base.restype = vp
    lib.hk_prefault_stop.argtypes = [vp, i64, i64p]
    lib.hk_prefault_stop.restype = None
    lib.hk_prefault_finish.argtypes = [vp]
    lib.hk_prefault_finish.restype = None
    return lib


def _enter(name: str) -> ctypes.CDLL:
    """The library, its worker count set to torch's thread count, with the
    call counted."""
    lib = _load()
    lib.hk_set_threads(torch.get_num_threads())
    calls[name] += 1
    return lib


def available() -> bool:
    """Whether callers take the native routes: always (the library is built
    at first use, and a failed build raises). The seam tests patch to take
    the numpy plain versions instead."""
    return True


def fai_build(
    data: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A FASTA's .fai index by one scan of its bytes: ((4, n) int64 columns
    length, offset, linebases, linewidth; name_lo, name_hi, each record's
    name as the byte range [name_lo, name_hi) of data, empty where the
    header has none; the .fai file's bytes as uint8). Two calls: the first
    counts the records, the second fills."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lib = _enter("fai_build")
    text_len = np.zeros(1, dtype=np.int64)
    none = np.zeros(0, dtype=np.int64)
    n = lib.hk_fai_build(data, data.size, 0, none, none, none,
                         np.zeros(0, dtype=np.uint8), text_len)
    cols = np.empty((4, n), dtype=np.int64)
    name_lo = np.empty(n, dtype=np.int64)
    name_hi = np.empty(n, dtype=np.int64)
    text = np.empty(data.size + 85 * n, dtype=np.uint8)
    lib.hk_fai_build(data, data.size, n, cols, name_lo, name_hi, text, text_len)
    return cols, name_lo, name_hi, text[: int(text_len[0])]


def strip_and_pack(
    raw: np.ndarray,
    raw_off: np.ndarray,
    seq_len: np.ndarray,
    line_bases: np.ndarray,
    line_width: np.ndarray,
) -> np.ndarray:
    """FASTA records' bases as 2-bit codes (uint8), line breaks stripped;
    record r starts at raw[raw_off[r]] and has seq_len[r] bases in lines of
    line_bases[r] bases every line_width[r] bytes."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    raw_off = np.ascontiguousarray(raw_off, dtype=np.int64)
    seq_len = np.ascontiguousarray(seq_len, dtype=np.int64)
    line_bases = np.ascontiguousarray(line_bases, dtype=np.int64)
    line_width = np.ascontiguousarray(line_width, dtype=np.int64)
    n = seq_len.size
    if not raw_off.size == line_bases.size == line_width.size == n:
        raise ValueError("strip_and_pack: per-record arrays differ in length")
    if n:
        # The byte after each record's last base, by the loop's own geometry
        # (an empty record reads nothing, wherever it points).
        lb = np.where(line_bases > 0, line_bases, seq_len)
        lw = np.where(line_width > 0, line_width, lb + 1)
        full_lines = np.maximum(-(-seq_len // np.maximum(lb, 1)) - 1, 0)
        end = np.where(seq_len > 0, raw_off + full_lines * (lw - lb) + seq_len, 0)
        if (seq_len < 0).any() or (raw_off < 0).any() or int(end.max()) > raw.size:
            raise ValueError("strip_and_pack: a record reaches past the raw bytes")
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(seq_len[:-1], out=out_off[1:])
    out = np.empty(int(seq_len.sum()), dtype=np.uint8)
    _enter("strip_and_pack").hk_strip_and_pack(
        raw, raw_off, seq_len, line_bases, line_width, out_off, n, out,
    )
    return out


def pack_2bit(codes: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """16 base codes per uint32 wire word. Without `out`, len(codes) % 16
    == 0 and the words are returned; with `out` (uint32 or int32, C
    contiguous, at least ceil(len(codes) / 16) words), the codes are packed
    into it and every word past them is zero-filled, a partial last word
    included. int8 and uint8 codes are read in place, never copied."""
    if codes.dtype in (np.int8, np.uint8) and codes.flags.c_contiguous:
        codes = codes.reshape(-1).view(np.uint8)
    else:
        codes = np.ascontiguousarray(codes, dtype=np.uint8).reshape(-1)
    if out is None:
        if codes.size % 16:
            raise ValueError(f"pack_2bit: {codes.size} codes, not a multiple of 16")
        out = np.empty(codes.size // 16, dtype=np.uint32)
    elif (out.dtype not in (np.uint32, np.int32) or out.ndim != 1
          or not out.flags.c_contiguous or out.size * 16 < codes.size):
        raise ValueError(f"pack_2bit: {codes.size} codes do not fit the output buffer")
    words = out.view(np.uint32)
    _enter("pack_2bit").hk_pack_2bit(codes, codes.size, words, words.size)
    return out


def decode_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, W) uint32 packed keys -> (N,) length-k ASCII bytes."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, w = keys.shape
    if not 0 < k <= 16 * w:
        raise ValueError(f"decode_keys: k={k} does not fit {w} words")
    out = np.empty(n * k, dtype=np.uint8)
    _enter("decode_keys").hk_decode_keys(keys, n, w, k, out)
    return out.view(f"S{k}")


def format_output_into(
    keys: np.ndarray, counts: np.ndarray, k: int, out: np.ndarray
) -> int:
    """Render `kmer\\tcount\\n` rows into a caller-provided uint8 buffer
    (capacity >= n*(k+12)); returns the byte count. The writer hands
    `memoryview(out)[:nbytes]` straight to file.write: no zeroing and no
    bytes copy."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    n, w = keys.shape
    if not 0 < k <= 16 * w or counts.shape != (n,):
        raise ValueError("format_output: keys, counts and k do not agree")
    if out.dtype != np.uint8 or not out.flags.c_contiguous or out.size < n * (k + 12):
        raise ValueError("format_output: the buffer is too small")
    return int(_enter("format_output").hk_format_output(keys, counts, n, w, k, out))


def format_output(keys: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    out = np.empty(keys.shape[0] * (k + 12), dtype=np.uint8)
    return out[: format_output_into(keys, counts, k, out)].tobytes()


def run_boundaries(
    valid: np.ndarray, dest: np.ndarray, max_kmers: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Supermer run decomposition in one sequential pass (numpy's takes
    about eight full-array passes). Returns (run_start_flat, run_kmers,
    run_dest)."""
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    dest_i32 = np.ascontiguousarray(dest, dtype=np.int32)
    n = valid_u8.size
    if dest_i32.size < n or max_kmers < 1:
        raise ValueError("run_boundaries: dest shorter than valid, or max_kmers < 1")
    cap = max(int(np.count_nonzero(valid_u8)), 1)
    out_start = np.empty(cap, dtype=np.int64)
    out_kmers = np.empty(cap, dtype=np.int64)
    out_dest = np.empty(cap, dtype=np.int32)
    runs = _enter("run_boundaries").hk_run_boundaries(
        valid_u8, dest_i32, n, int(max_kmers), out_start, out_kmers, out_dest,
    )
    return out_start[:runs], out_kmers[:runs], out_dest[:runs]


def gather_runs(
    codes: np.ndarray,
    starts: np.ndarray,
    bases: np.ndarray,
    out_off: np.ndarray,
    total: int,
) -> np.ndarray:
    """codes[starts[r] : starts[r] + bases[r]] at out[out_off[r]:] for every
    run r (int8, `total` long)."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    bases = np.ascontiguousarray(bases, dtype=np.int64)
    out_off = np.ascontiguousarray(out_off, dtype=np.int64)
    if not starts.size == bases.size == out_off.size:
        raise ValueError("gather_runs: per-run arrays differ in length")
    if starts.size and (
        (bases < 0).any() or (starts < 0).any() or (out_off < 0).any()
        or int((starts + bases).max()) > codes.size
        or int((out_off + bases).max()) > total
    ):
        raise ValueError("gather_runs: a run reaches past its buffer")
    out = np.empty(total, dtype=np.int8)
    _enter("gather_runs").hk_gather_runs(codes, starts, bases, out_off, starts.size, out)
    return out


def valid_kmers(lengths: np.ndarray, k: int) -> int:
    """The valid k-mer starts of reads of these lengths: the sum of
    max(length - k + 1, 0), in one pass on the library's workers."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64).reshape(-1)
    return int(_enter("valid_kmers").hk_valid_kmers(lengths, lengths.size, int(k)))


# madvise's advice that faults a range in writable (Linux 5.14 and later);
# the library writes a byte a page where the kernel does not know it.
MADV_POPULATE_WRITE = 23


@dataclasses.dataclass
class Stopped:
    """What `prefault_stop` reports, per array (keys, counts): the bytes
    faulted in (a prefix), released past the kept rows, and kept mapped;
    whether madvise faulted them (else a byte a page was written)."""

    faulted: tuple[int, int]
    released: tuple[int, int]
    kept: tuple[int, int]
    populate: bool


def prefault_start(rows: int, row_bytes: tuple[int, int], chunk_rows: int,
                   advice: int = MADV_POPULATE_WRITE, fault_rows: int | None = None
                   ) -> int | None:
    """Maps two arrays of `rows` rows of row_bytes[0] and row_bytes[1]
    bytes (MAP_NORESERVE: only touched pages take memory) and starts
    max(1, torch threads - 1) workers that fault in their first fault_rows
    rows (all by default), chunk_rows rows a chunk in ascending order across
    both, by madvise(advice) (a negative advice, or one the kernel refuses
    as unknown, writes a byte a page). Returns at once: the job's handle,
    or None where a mapping was refused or rows < 1. Each handle is
    stopped (`prefault_stop`) and finished (`prefault_finish`) once."""
    job = _enter("prefault_start").hk_prefault_start(
        int(rows), int(row_bytes[0]), int(row_bytes[1]), int(chunk_rows), int(advice),
        int(rows if fault_rows is None else fault_rows))
    return job or None


def prefault_base(job: int, array: int) -> int:
    """The address of array 0 (keys) or 1 (counts) of a job."""
    return _load().hk_prefault_base(job, array)


def prefault_stop(job: int, keep_rows: int) -> Stopped:
    """Stops the job's workers (each ends the chunk it holds) and keeps the
    pages of each array's first keep_rows rows mapped, which the caller
    then owns (`unmap_entry`); a thread of the library releases the
    faulted pages past them and unmaps the rest."""
    out = np.zeros(7, dtype=np.int64)
    _load().hk_prefault_stop(job, int(keep_rows), out)
    v = out.tolist()
    return Stopped((v[0], v[1]), (v[2], v[3]), (v[4], v[5]), bool(v[6]))


def prefault_finish(job: int) -> None:
    """Joins the job's release thread (stopping it with no rows kept where
    it was not stopped) and frees the job."""
    _load().hk_prefault_finish(job)


def unmap_entry():
    """hk_unmap itself, (addr, nbytes) -> errno, which unmaps pages a job
    kept; for a finalizer that may run after this module's globals are
    gone."""
    return _load().hk_unmap
