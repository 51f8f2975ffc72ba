"""The one-shot result's host pages faulted in while the card counts
(runtime/prefault, the host library's hk_prefault_* and hk_valid_kmers), on
the CPU: the bound on the kept rows; a reservation's faulting started and
stopped at once, stopped after the whole bound is faulted, and stopped with
none, all or part of the rows kept, past what was faulted too; the arrays it
hands out (C-contiguous int32 of the kept rows, owning their pages, which
are unmapped when they go); the counters; results that share no memory
with each other, a second call's result or the copy-out ring; a refused
mapping, which falls back to fresh arrays; the byte-a-page faulting where
madvise's populate is missing; and `kept_result` filling the pages, its
"prefault stop" span inside "compaction". The tests marked `cuda` run
`count_reads` on the card, which reserves the pages itself."""

import ctypes
import gc
import mmap
import time

import numpy as np
import pytest
import torch

from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.io import native
from hysortk_tpu_torch.runtime import prefault, timer

PAGE = mmap.PAGESIZE
_libc = ctypes.CDLL(None, use_errno=True)


def _resident(addr, nbytes):
    """The bytes of [addr, addr + nbytes) resident in memory (mincore)."""
    pages = -(-nbytes // PAGE)
    vec = (ctypes.c_ubyte * max(pages, 1))()
    assert _libc.mincore(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), vec) == 0
    return sum(v & 1 for v in vec[:pages]) * PAGE


@pytest.fixture(autouse=True)
def _counters():
    prefault.reap()
    prefault.reset_counters()
    yield
    prefault.reap()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _page_ceil(n):
    return -(-n // PAGE) * PAGE


def _valid(lengths, k):
    return int(np.maximum(np.asarray(lengths, np.int64) - k + 1, 0).sum())


@pytest.mark.parametrize("lengths, k, lower", [
    ([], 31, 2),                          # no reads
    ([10, 30, 5], 31, 1),                 # no read holds a k-mer
    ([31], 31, 1),                        # one k-mer, lower 1
    ([150] * 1000, 31, 1),                # lower 1: every valid start
    ([150] * 1000, 31, 2),
    ([10, 20000, 15000, 31, 32], 31, 15),
    (list(range(0, 300_000)), 21, 7),     # many reads: the library's chunks
])
def test_rows_bound(lengths, k, lower):
    n_valid = _valid(lengths, k)
    assert native.valid_kmers(np.asarray(lengths, np.int64), k) == n_valid
    assert prefault.rows_bound(np.asarray(lengths, np.int32), k, lower) == \
        min(n_valid, n_valid // lower)
    if n_valid == 0:
        assert prefault.reserve(prefault.rows_bound(np.asarray(lengths), k, lower), 2) is None


def _wait_resident(res, timeout=20.0):
    """Waits until every page of both mappings is resident."""
    sizes = [_page_ceil(res.rows * b) for b in res.row_bytes]
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if all(_resident(a, s) == s for a, s in zip(res.bases, sizes)):
            return sizes
        time.sleep(0.01)
    raise AssertionError("the reservation was not faulted in")


def _check_stop(res, m):
    """What stop(m) reported and counted, and the arrays it hands out."""
    st = res.stopped
    rb = res.row_bytes
    mapped = [_page_ceil(res.rows * b) for b in rb]
    for a in range(2):
        assert 0 <= st.faulted[a] <= mapped[a] and st.faulted[a] % PAGE == 0
        assert st.kept[a] == min(_page_ceil(m * rb[a]), mapped[a])
        assert st.released[a] == max(st.faulted[a] - st.kept[a], 0)
    covered = sum(min(f, m * b) for f, b in zip(st.faulted, rb))
    assert prefault.counters == {
        "result_bytes": m * sum(rb), "prefaulted_bytes": sum(st.faulted),
        "covered_bytes": covered, "released_bytes": sum(st.released), "fallbacks": 0}
    assert covered <= min(sum(st.faulted), m * sum(rb))
    keys, counts = res.arrays()
    assert keys.shape == (m, res.words) and counts.shape == (m,)
    for arr in (keys, counts):
        assert arr.dtype == np.int32 and arr.flags.c_contiguous and arr.flags.writeable
    if m:
        assert keys.ctypes.data == res.bases[0] and counts.ctypes.data == res.bases[1]
    with pytest.raises(RuntimeError):
        res.arrays()
    return keys, counts


@pytest.mark.parametrize("advice", [native.MADV_POPULATE_WRITE, -1, 0x7FFF0001])
@pytest.mark.parametrize("part", [0, 0.37, 1])
def test_stop_after_the_bound_is_faulted(advice, part):
    """Every page of the bound faulted in (by madvise's populate; by a byte
    a page where it is missing: a negative advice, or one the kernel does
    not know), then the kept rows: none, some, all. The pages past them are
    released, the kept ones hold what is written."""
    rows, words = 300_001, 2
    res = prefault.Reservation(rows, words, advice)
    sizes = _wait_resident(res)
    m = int(rows * part)
    res.stop(m)
    assert res.stopped.faulted == tuple(sizes)
    assert res.stopped.populate == (advice == native.MADV_POPULATE_WRITE)
    assert prefault.counters["covered_bytes"] == m * sum(res.row_bytes)
    keys, counts = _check_stop(res, m)
    keys[:] = np.arange(m * words, dtype=np.int32).reshape(m, words)
    counts[:] = 7
    res.close()
    prefault.reap()
    assert np.array_equal(keys.reshape(-1), np.arange(m * words)) and (counts == 7).all()
    if m:
        assert _resident(res.bases[0], res.stopped.kept[0]) == res.stopped.kept[0]


@pytest.mark.parametrize("m", [0, 1, 5_000, 1 << 22])
def test_start_then_stop_at_once(m):
    """Stopped as soon as it starts: whatever was faulted is a prefix of
    each mapping, and the kept rows, none to all of the bound, are whole;
    their pages not faulted yet are faulted by the writes that fill them."""
    res = prefault.reserve(1 << 22, 2)
    res.stop(m)
    keys, counts = _check_stop(res, m)
    keys[:] = 3
    counts[:] = np.arange(m, dtype=np.int32)
    res.close()
    assert (keys == 3).all() and np.array_equal(counts, np.arange(m))


def test_part_faulted_then_more_rows_kept():
    """Only the first rows faulted (the workers' limit), then more rows kept
    than were faulted: the covered bytes are the faulted ones, nothing is
    released, and the arrays are whole."""
    rows, m, limit = 200_000, 150_000, 40_000
    job = native.prefault_start(rows, (8, 4), 10_000, native.MADV_POPULATE_WRITE, limit)
    bases = [native.prefault_base(job, a) for a in (0, 1)]
    faulted = tuple(limit * rb // PAGE * PAGE for rb in (8, 4))
    end = time.monotonic() + 20
    while any(_resident(b, f) != f for b, f in zip(bases, faulted)):
        assert time.monotonic() < end
        time.sleep(0.01)
    st = native.prefault_stop(job, m)
    assert st.faulted == faulted and st.populate
    assert st.released == (0, 0) and st.kept == (_page_ceil(m * 8), _page_ceil(m * 4))
    native.prefault_finish(job)
    # The kept heads are the caller's to unmap.
    unmap = native.unmap_entry()
    assert [unmap(b, k) for b, k in zip(bases, st.kept)] == [0, 0]


def test_arrays_own_their_pages(monkeypatch):
    """A result's arrays own their kept pages: nothing is unmapped while a
    view of them lives, and each head is unmapped once, whole, when the
    last goes; a reservation never stopped is unmapped whole by close()."""
    unmapped = []
    real = native.unmap_entry()
    monkeypatch.setattr(native, "unmap_entry",
                        lambda: lambda a, n: unmapped.append((a, n)) or real(a, n))
    res = prefault.reserve(100_000, 3)
    res.stop(12_345)
    keys, counts = res.arrays()
    res.close()
    view = keys[10:20]
    del keys, counts
    gc.collect()
    assert unmapped == [(res.bases[1], res.stopped.kept[1])]
    del view
    gc.collect()
    assert sorted(unmapped) == sorted(zip(res.bases, res.stopped.kept))
    other = prefault.reserve(10_000, 2)
    other.close()
    assert other.stopped is None and other.job is None


def test_reservations_from_many_threads():
    """Sixteen threads, more than the cores, each reserving, stopping,
    filling and closing in turn while the others do, with a short switch
    interval: every result holds its own thread's rows, and every release
    thread is joined by a later reserve or by reap."""
    import sys
    import threading

    def worker(t, out):
        for i in range(6):
            res = prefault.reserve(20_000 + 1000 * t, 1)
            m = 500 * (t + 1) + i
            res.stop(m)
            keys, counts = res.arrays()
            res.close()
            keys[:, 0] = t
            counts[:] = i
            out.append((t, i, keys, counts))

    results: list = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t, results)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    prefault.reap()
    assert len(results) == 16 * 6 and not prefault._releasing
    for t, i, keys, counts in results:
        assert keys.shape == (500 * (t + 1) + i, 1) and (keys == t).all() and (counts == i).all()


def _kept_case(seed, n=3000, words=2):
    rng = np.random.default_rng(seed)
    w = [torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32))
         for _ in range(words)]
    cnt = torch.from_numpy(rng.integers(1, 60, n).astype(np.int32))
    keep = torch.from_numpy(rng.random(n) < 0.4)
    return w, cnt, keep


CFG = config.KmerConfig(k=31, m=17, lower=2, upper=50)


@pytest.mark.parametrize("histogram", [True, False])
def test_kept_result_fills_the_reservation(histogram):
    """kept_result into a reservation equals kept_result with fresh
    arrays, byte for byte; its keys and counts are the reservation's pages,
    the histogram a fresh array."""
    words, cnt, keep = _kept_case(1)
    want, want_hist = pipeline.kept_result(words, cnt, keep, CFG, 50, histogram)
    res = prefault.reserve(3000, 2)
    got, hist = pipeline.kept_result(words, cnt, keep, CFG, 50, histogram, pages=res)
    assert got.keys.dtype == np.uint32 and got.counts.dtype == np.int32
    assert np.array_equal(got.keys, want.keys) and np.array_equal(got.counts, want.counts)
    assert (hist is None) == (not histogram)
    if histogram:
        assert hist.dtype == np.int32 and np.array_equal(hist, want_hist)
    assert got.keys.ctypes.data == res.bases[0] and got.counts.ctypes.data == res.bases[1]
    assert res.job is None  # closed
    assert prefault.counters["result_bytes"] == len(want) * 12


def test_results_share_no_memory():
    """Two results, each in its own reservation, and one in fresh arrays:
    no array shares memory with another's or with the copy-out ring's
    blocks, and a result's keys and counts are apart."""
    words, cnt, keep = _kept_case(2)
    first = pipeline.kept_result(words, cnt, keep, CFG, 50, pages=prefault.reserve(3000, 2))
    second = pipeline.kept_result(words, cnt, keep, CFG, 50, pages=prefault.reserve(3000, 2))
    fresh = pipeline.kept_result(words, cnt, keep, CFG, 50)
    arrays = [a for r in (first, second, fresh) for a in (r[0].keys, r[0].counts, r[1])]
    assert all(not np.shares_memory(a, b) for i, a in enumerate(arrays) for b in arrays[i + 1:])
    ring = pipeline.CopyRing(256)
    res = prefault.reserve(3000, 2)
    res.stop(1000)
    out = res.arrays()
    got = ring.copy_out([words[0][:2000].reshape(1000, 2), cnt[:1000]], [None, None], out)
    res.close()
    assert got[0] is out[0] and ring.blocks
    assert not any(np.shares_memory(a, b.numpy()) for a in got for b in ring.blocks)


@pytest.mark.parametrize("refusal", ["injected", "address space"])
def test_refused_mapping_falls_back(refusal, monkeypatch):
    """A mapping refused (injected; or past the address space) leaves a
    reservation without pages: kept_result takes fresh arrays, with the
    same result, and the refusal is counted."""
    if refusal == "injected":
        monkeypatch.setattr(native, "prefault_start", lambda *a, **kw: None)
        res = prefault.reserve(3000, 2)
    else:
        assert native.prefault_start(1 << 55, (8, 4), 1024) is None
        res = prefault.reserve(1 << 55, 2)
    assert res.job is None and prefault.counters["fallbacks"] == 1
    words, cnt, keep = _kept_case(3)
    want, want_hist = pipeline.kept_result(words, cnt, keep, CFG, 50)
    got, hist = pipeline.kept_result(words, cnt, keep, CFG, 50, pages=res)
    assert np.array_equal(got.keys, want.keys) and np.array_equal(got.counts, want.counts)
    assert np.array_equal(hist, want_hist)
    assert prefault.counters == {"result_bytes": len(want) * 12, "prefaulted_bytes": 0,
                                 "covered_bytes": 0, "released_bytes": 0, "fallbacks": 1}


def test_prefault_stop_nests_inside_compaction():
    """Under record_stages the reservation's stop is a span of its own,
    a profiler range inside "compaction"."""
    words, cnt, keep = _kept_case(4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.record_stages() as seconds:
            pipeline.kept_result(words, cnt, keep, CFG, 50, pages=prefault.reserve(3000, 2))
    assert "prefault stop" in seconds and seconds["prefault stop"] >= 0
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
              if e.is_user_annotation}
    outer, inner = ranges["compaction"], ranges["prefault stop"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]


def test_count_reads_reserves_only_on_a_card(monkeypatch):
    """On the CPU count_reads reserves nothing (the behaviour needs a card
    running the device core), and its result is as before."""
    monkeypatch.setattr(prefault, "reserve", pytest.fail)
    rng = np.random.default_rng(6)
    lengths = rng.integers(30, 200, 50)
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    cfg = config.KmerConfig(k=31, m=17, lower=1, upper=50)
    got, hist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert len(got) and prefault.counters["result_bytes"] == 0


# ---------------------------------------------------------------------------
# On the card


def _phase2_reads(seed, bases=1 << 26):
    """Phase 2's size: 2^26 bases of 150-base reads with every read twice,
    so about half the k-mers pass lower = 2."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 4, bases // 2, dtype=np.uint8)
    codes = np.concatenate([half, half])
    lengths = np.full(codes.size // 150, 150, np.int64)
    return codes[: int(lengths.sum())], lengths


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [None, 0.1])
def test_count_reads_into_the_reservation_on_the_card(cuda, limit, monkeypatch):
    """count_reads on the card reserves the result's pages and fills them:
    the same keys, counts and histogram, byte for byte, as kept_result with
    fresh arrays after the same device core; also where the workers fault
    only a tenth of the bound, so the kept rows exceed what was faulted.
    The counters agree, and "prefault stop" nests inside "compaction"."""
    codes, lengths = _phase2_reads(7)
    cfg = config.KmerConfig(k=31, m=17, lower=2, upper=40)
    bound = prefault.rows_bound(lengths, cfg.k, cfg.lower)
    if limit is not None:
        real = native.prefault_start
        monkeypatch.setattr(native, "prefault_start", lambda rows, rb, chunk, advice: real(
            rows, rb, chunk, advice, int(rows * limit)))
    pipeline.count_reads(codes, lengths, cfg, device=cuda)  # kernels built
    prefault.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.record_stages() as seconds:
            got, hist = pipeline.count_reads(codes, lengths, cfg, device=cuda)
    codes_d, valid_d = pipeline.device_batch(codes, lengths, cfg, cuda)
    words, cnt, keep = pipeline._count_core(codes_d, valid_d, cfg.k, cfg.lower, cfg.upper)
    want, want_hist = pipeline.kept_result(words, cnt, keep, cfg, cfg.upper)
    assert got.keys.tobytes() == want.keys.tobytes()
    assert got.counts.tobytes() == want.counts.tobytes() and hist.tobytes() == want_hist.tobytes()
    c = prefault.counters
    m = len(want)
    assert 0 < m <= bound and c["result_bytes"] == m * 12 and c["fallbacks"] == 0
    assert c["covered_bytes"] <= min(c["prefaulted_bytes"], c["result_bytes"])
    if limit is not None:
        assert c["prefaulted_bytes"] <= int(bound * limit) * 12 + prefault.CHUNK_BYTES + 2 * PAGE
        assert c["covered_bytes"] < c["result_bytes"] and c["released_bytes"] == 0
    assert "prefault stop" in seconds
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
              if e.is_user_annotation}
    outer, inner = ranges["compaction"], ranges["prefault stop"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    blocks = [b.numpy() for b in pipeline.RING.blocks]
    again, _ = pipeline.count_reads(codes, lengths, cfg, device=cuda)
    for a in (got.keys, got.counts, again.keys, again.counts):
        assert not any(np.shares_memory(a, b) for b in blocks)
    assert not any(np.shares_memory(a, b) for a in (got.keys, got.counts)
                   for b in (again.keys, again.counts))
