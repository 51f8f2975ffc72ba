"""The one-shot result's host pages, faulted in while the card counts.

A copy-out into fresh host arrays pays the first touch of every page of the
result. `pipeline.count_reads` knows a bound on the result before the card
is done: a kept k-mer occurs at least `lower` times, so the kept rows are at
most n_valid // lower (`rows_bound`). Right after the device core is queued
it reserves that many rows of keys and counts (`reserve`: one anonymous
mapping an array, MAP_NORESERVE, so only touched pages take memory), and
the host library's workers fault them in, in ascending row order across
both arrays, while the host waits for the kept count (the compaction's host
read; ctypes lets go of the GIL there). Then:

  stop(m)    the kept rows m are known: the workers end ("prefault stop");
             a thread of the library releases the pages faulted past row m
             (MADV_DONTNEED) and unmaps each mapping's tail, while the
             copy-out runs
  arrays()   the first m rows as C-contiguous int32 arrays, each owning its
             pages (unmapped once its last view is dropped), for the
             copy-out to fill (pipeline.to_host's `out`)
  close()    the release thread is joined by the next `reserve` (or
             `reap`), not by this call

A refused mapping leaves a reservation that holds no pages: `arrays` gives
None and the copy-out takes fresh arrays, as every other caller of
`pipeline.kept_result` does.

`counters`, per process (`reset_counters` clears them): result_bytes, the
keys and counts of the results of reservations, refused ones included;
prefaulted_bytes, the bytes the workers faulted in; covered_bytes, those
inside a result (covered_bytes / result_bytes is the hit share);
released_bytes, those past a result, released; fallbacks, the mappings
refused.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..io import native
from .timer import stage

counters = {"result_bytes": 0, "prefaulted_bytes": 0, "covered_bytes": 0,
            "released_bytes": 0, "fallbacks": 0}

# About this many bytes of keys and counts together a chunk of the faulting.
CHUNK_BYTES = 2 << 20

# Stopped jobs whose release thread is joined by the next reserve().
_releasing: list[int] = []


def reset_counters() -> None:
    for name in counters:
        counters[name] = 0


def rows_bound(lengths: np.ndarray, k: int, lower: int) -> int:
    """The most kept rows reads of these lengths can give: every kept k-mer
    occurs at least `lower` times among the n_valid valid k-mer starts."""
    n_valid = native.valid_kmers(lengths, k)
    return min(n_valid, n_valid // max(lower, 1))


def reap() -> None:
    """Joins the release threads of the reservations closed so far."""
    while True:
        try:
            job = _releasing.pop()
        except IndexError:
            return
        native.prefault_finish(job)


def reserve(rows: int, words: int) -> "Reservation | None":
    """A reservation of `rows` rows of `words` key words and a count, its
    pages being faulted in; None where rows < 1. The release threads of
    the reservations closed before are joined first."""
    reap()
    if rows < 1:
        return None
    return Reservation(rows, words)


class _Pages:
    """The kept head of one mapping, unmapped when the array on it goes."""

    __slots__ = ("addr", "nbytes", "_unmap")

    def __init__(self, addr: int, nbytes: int):
        # The library's own entry, which outlives the modules at exit.
        self.addr, self.nbytes, self._unmap = addr, nbytes, native.unmap_entry()

    def __del__(self):
        self._unmap(self.addr, self.nbytes)


def _owning_array(addr: int, kept: int, shape: tuple[int, ...]) -> np.ndarray:
    """An int32 array of `shape` on the kept pages at addr, which it owns."""
    buf = (ctypes.c_char * (int(np.prod(shape)) * 4)).from_address(addr)
    buf.pages = _Pages(addr, kept)
    return np.frombuffer(buf, dtype=np.int32).reshape(shape)


class Reservation:
    """Two mappings of `rows` rows (keys (rows, words) int32, counts (rows,)
    int32) being faulted in by madvise(advice), or a byte a page where the
    kernel does not know the advice; `job` is None where a mapping was
    refused."""

    def __init__(self, rows: int, words: int, advice: int = native.MADV_POPULATE_WRITE):
        self.rows, self.words = rows, words
        self.row_bytes = (4 * words, 4)
        self.m: int | None = None
        self.stopped: native.Stopped | None = None
        self._handed = False
        self.job = native.prefault_start(
            rows, self.row_bytes, max(1, CHUNK_BYTES // sum(self.row_bytes)), advice)
        if self.job is None:
            counters["fallbacks"] += 1
            self.bases = (0, 0)
        else:
            self.bases = (native.prefault_base(self.job, 0), native.prefault_base(self.job, 1))

    def stop(self, m: int) -> None:
        """The kept rows are m: the faulting ends, the pages of the first m
        rows are kept (all of them released where m exceeds the rows, which
        the bound rules out), the rest released, and the counters count."""
        m = int(m)
        self.m = m
        counters["result_bytes"] += m * sum(self.row_bytes)
        if self.job is None:
            return
        with stage("prefault stop"):
            st = native.prefault_stop(self.job, m if m <= self.rows else 0)
        self.stopped = st
        counters["prefaulted_bytes"] += sum(st.faulted)
        counters["released_bytes"] += sum(st.released)
        if m <= self.rows:
            counters["covered_bytes"] += sum(
                min(f, m * b) for f, b in zip(st.faulted, self.row_bytes))

    def arrays(self) -> list[np.ndarray] | None:
        """keys (m, words) and counts (m,), int32 and C-contiguous, on the
        kept pages (once: the arrays own them); None where the reservation
        holds no pages for them."""
        if self.m is None or self._handed:
            raise RuntimeError("arrays() comes once, after stop()")
        self._handed = True
        if self.job is None or self.m > self.rows:
            return None
        shapes = ((self.m, self.words), (self.m,))
        if self.m == 0:
            return [np.empty(s, dtype=np.int32) for s in shapes]
        return [_owning_array(base, kept, s)
                for base, kept, s in zip(self.bases, self.stopped.kept, shapes)]

    def close(self) -> None:
        """Ends the reservation: a stopped job's release thread is joined by
        the next `reserve`; one not stopped is stopped with no rows kept
        and finished here."""
        job, self.job = self.job, None
        if job is None:
            return
        if self.stopped is None:
            native.prefault_finish(job)
        else:
            _releasing.append(job)
