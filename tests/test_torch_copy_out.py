"""The port's copy-out of device results to the host (pipeline.to_host,
pipeline.CopyRing, pipeline.copy_plan), on the CPU: the plan that cuts a
result into pieces of a pinned block, checked piece by piece; the ring's
pass over a result on CPU tensors (ordinary memory stands in for the
pinned blocks), exactly equal to the CPU route, at sizes around a block's
and across several blocks, with narrowed counts widened on the host and
(m, W) key rows; its results C-contiguous arrays that own their memory,
never views of the ring's reused blocks, and the blocks it asks for within
its cap; the CPU route, which asks for no staging at all. The tests marked
`cuda` run the same on the card, where the blocks are pinned."""

import numpy as np
import pytest
import torch

from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.runtime import scheduler

CHUNK = 256  # bytes a block in the CPU cases: a handful of elements


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_plan(sizes, chunk, plan):
    """Every element of every array in exactly one piece, in array order;
    each piece fits a block, and only an array's last piece is short."""
    covered = [0] * len(sizes)
    for i, lo, hi in plan:
        itemsize = sizes[i][1]
        assert lo == covered[i] and hi > lo and (hi - lo) * itemsize <= chunk
        assert hi == sizes[i][0] or (hi - lo) == chunk // itemsize
        covered[i] = hi
    assert covered == [n for n, _ in sizes]


# Element counts at a block of CHUNK bytes of int32: none, one, one under,
# at and one over a block, several blocks.
PER_BLOCK = CHUNK // 4
COUNTS = [0, 1, PER_BLOCK - 1, PER_BLOCK, PER_BLOCK + 1, 5 * PER_BLOCK + 3]


@pytest.mark.parametrize("numel", COUNTS)
@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_plan_cuts_one_array(numel, itemsize):
    plan = pipeline.copy_plan([(numel, itemsize)], CHUNK)
    _check_plan([(numel, itemsize)], CHUNK, plan)
    assert len(plan) == -(-numel * itemsize // CHUNK)


def test_plan_takes_arrays_in_order():
    """Each array takes its own pieces, a large one several; an empty one
    none; an element larger than a block is refused."""
    sizes = [(3, 4), (0, 4), (10, 1), (PER_BLOCK * 2 + 1, 4), (1, 2), (7, 8)]
    plan = pipeline.copy_plan(sizes, CHUNK)
    _check_plan(sizes, CHUNK, plan)
    assert [p[0] for p in plan] == [0, 2, 3, 3, 3, 4, 5]
    with pytest.raises(ValueError):
        pipeline.copy_plan([(1, 2 * CHUNK)], CHUNK)
    assert pipeline.copy_plan([], CHUNK) == [] == pipeline.copy_plan([(0, 4)], CHUNK)


def _tensor(rng, shape, dtype):
    info = np.iinfo(pipeline.numpy_dtype(dtype))
    a = rng.integers(info.min, int(info.max) + 1, shape, dtype=np.int64)
    return torch.from_numpy(a.astype(pipeline.numpy_dtype(dtype)))


# (shape of one element row, device dtype, host dtype): int32, narrowed
# counts widened on the host, (m, W) key rows.
KINDS = [((), torch.int32, None), ((), torch.uint8, torch.int32),
         ((), torch.uint16, torch.int32), ((1,), torch.int32, None),
         ((2,), torch.int32, None), ((3,), torch.int32, None)]


def _recorded_staging(monkeypatch):
    sizes = []
    real = pipeline.host_staging

    def record(shape, dtype, dev):
        t = real(shape, dtype, dev)
        sizes.append(t.numel() * t.element_size())
        return t
    monkeypatch.setattr(pipeline, "host_staging", record)
    return sizes


def _check_result(got, tensors, dtypes, ring):
    for g, t, d in zip(got, tensors, dtypes):
        want = t.cpu().to(d or t.dtype).numpy()
        assert isinstance(g, np.ndarray) and g.dtype == want.dtype
        assert g.shape == tuple(t.shape) and np.array_equal(g, want)
        assert g.flags.c_contiguous and g.flags.writeable
        assert g.flags.owndata
        for block in ring.blocks:
            assert not np.shares_memory(g, block.numpy())


@pytest.mark.parametrize("numel", COUNTS)
@pytest.mark.parametrize("kind", range(len(KINDS)))
def test_ring_crosses_one_array(numel, kind, monkeypatch):
    row, dtype, host = KINDS[kind]
    rng = np.random.default_rng(numel * 10 + kind)
    staged = _recorded_staging(monkeypatch)
    ring = pipeline.CopyRing(CHUNK)
    t = _tensor(rng, (numel, *row), dtype)
    got = ring.copy_out([t], [host])
    _check_result(got, [t], [host], ring)
    assert all(s == CHUNK for s in staged) and sum(staged) <= ring.cap
    assert ring.nbytes == sum(staged)


def test_ring_crosses_a_result_in_one_pass(monkeypatch):
    """Keys, narrowed counts and two occurrence arrays through one plan
    (copy_plan called once), larger than the ring; the blocks are reused,
    never more than the cap; a second result shares no memory with the
    first."""
    rng = np.random.default_rng(7)
    staged = _recorded_staging(monkeypatch)
    ring = pipeline.CopyRing(CHUNK)
    plans = []
    real_plan = pipeline.copy_plan
    monkeypatch.setattr(pipeline, "copy_plan",
                        lambda *a: plans.append(real_plan(*a)) or plans[-1])
    tensors = [_tensor(rng, (41, 3), torch.int32), _tensor(rng, (41,), torch.uint16),
               _tensor(rng, (200,), torch.int32), _tensor(rng, (200,), torch.int32),
               _tensor(rng, (0,), torch.int32)]
    dtypes = [None, torch.int32, None, None, None]
    first = ring.copy_out(tensors, dtypes)
    assert len(plans) == 1 and len(plans[0]) > 8
    _check_result(first, tensors, dtypes, ring)
    second = ring.copy_out(tensors, dtypes)
    _check_result(second, tensors, dtypes, ring)
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    assert len(staged) == 2 and ring.nbytes == 2 * CHUNK == ring.cap


def test_cpu_route_asks_for_no_staging(monkeypatch):
    """On the CPU device to_host turns each tensor into an array as it is
    (widened where asked), with no staging; a dtype a tensor is refused."""
    monkeypatch.setattr(pipeline, "host_staging", pytest.fail)
    rng = np.random.default_rng(3)
    tensors = [_tensor(rng, (9, 2), torch.int32), _tensor(rng, (9,), torch.uint8)]
    keys, counts = pipeline.to_host(tensors, [None, torch.int32])
    assert np.array_equal(keys, tensors[0].numpy()) and keys.flags.c_contiguous
    assert counts.dtype == np.int32 and np.array_equal(counts, tensors[1].numpy())
    assert pipeline.to_host([]) == []
    with pytest.raises(ValueError):
        pipeline.to_host(tensors, [None])
    with pytest.raises(ValueError):
        pipeline.CopyRing(0)


def test_results_leave_through_the_copy_out(monkeypatch):
    """kept_result (keys, counts and histogram), pull_prefix,
    ExtPartial.to_host and ExtPartial.to_host_with_hist each make one call
    of to_host for their whole result."""
    calls = []
    real = pipeline.to_host
    monkeypatch.setattr(pipeline, "to_host",
                        lambda ts, ds=None: calls.append(len(ts)) or real(ts, ds))
    rng = np.random.default_rng(5)
    words = [_tensor(rng, (30,), torch.int32) for _ in range(2)]
    cnt = torch.from_numpy(rng.integers(1, 40, 30).astype(np.int32))
    keep = torch.arange(30) % 3 == 0
    kl, hist = pipeline.kept_result(words, cnt, keep, config.KmerConfig(k=31, upper=50), 50)
    assert kl.counts.dtype == np.int32 and kl.keys.dtype == np.uint32
    assert np.array_equal(kl.counts, cnt.numpy()[::3])
    assert hist.dtype == np.int32 and np.array_equal(
        hist, pipeline.host_histogram(cnt.numpy()[::3], 50))
    pipeline.pull_prefix(words + [cnt], torch.tensor(7))
    part = pipeline.ExtPartial(torch.stack(words, -1), torch.ones(30, dtype=torch.int32),
                               words[0].clone(), words[1].clone())
    got = part.to_host(31)
    assert np.array_equal(got.occ_pos, words[1].numpy().view(np.uint32))
    again, ones = part.to_host_with_hist(31, torch.tensor([0, 30], dtype=torch.int64))
    assert np.array_equal(again.occ_rid, got.occ_rid) and ones.tolist() == [0, 30]
    assert calls == [3, 3, 4, 5]


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.cuda
@pytest.mark.parametrize("kind", range(len(KINDS)))
def test_ring_on_the_card_equals_the_cpu_route(cuda, kind):
    row, dtype, host = KINDS[kind]
    rng = np.random.default_rng(kind)
    ring = pipeline.CopyRing(1 << 12)
    for numel in (0, 1, 1023, 1024, 1025, 5000):
        t = _tensor(rng, (numel, *row), dtype)
        got = ring.copy_out([t.to(cuda)], [host])
        _check_result(got, [t], [host], ring)
        assert np.array_equal(got[0], pipeline.to_host([t], [host])[0])
    assert all(b.is_pinned() for b in ring.blocks)


@pytest.mark.cuda
def test_result_larger_than_the_cap_stays_within_it(cuda, monkeypatch):
    """A result of ~5x the process ring's cap crosses while host_staging
    hands out no more than the cap, in blocks of COPY_CHUNK_BYTES; two
    results one after the other share no memory."""
    staged = _recorded_staging(monkeypatch)
    monkeypatch.setattr(pipeline, "RING", pipeline.CopyRing())
    n = 5 * pipeline.RING.cap // 4 + 12345
    gen = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randint(-2**31, 2**31, (n,), generator=gen, device=cuda, dtype=torch.int64)
    tensors = [big.to(torch.int32), (big % 251).to(torch.uint8)]
    first = pipeline.to_host(tensors, [None, torch.int32])
    second = pipeline.to_host(tensors, [None, torch.int32])
    _check_result(first, tensors, [None, torch.int32], pipeline.RING)
    _check_result(second, tensors, [None, torch.int32], pipeline.RING)
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    assert staged and sum(staged) <= pipeline.RING.cap == pipeline.RING.nbytes
    assert set(staged) == {pipeline.COPY_CHUNK_BYTES}


@pytest.mark.cuda
def test_entries_cross_in_one_copy_out_a_result(cuda, monkeypatch):
    """On the card count_reads and count_reads_ext return their list and
    their histogram (binned on the card in the compaction) in one copy-out,
    equal to the CPU device's."""
    from hysortk_tpu_torch import config
    from hysortk_tpu_torch.io import fasta as fasta_io

    rng = np.random.default_rng(11)
    reads = ["".join(rng.choice(list("ACGT"), int(rng.integers(40, 160))))
             for _ in range(300)]
    codes, lengths = fasta_io.reads_to_codes(reads + reads[:50])
    cfg = config.KmerConfig(k=31, m=17, lower=1, upper=40)
    ring = pipeline.CopyRing()
    calls = []
    monkeypatch.setattr(pipeline, "RING", ring)
    real = ring.copy_out
    monkeypatch.setattr(ring, "copy_out",
                        lambda ts, ds, *out: calls.append(len(ts)) or real(ts, ds, *out))
    for count in (pipeline.count_reads, pipeline.count_reads_ext):
        calls.clear()
        got, hist = count(codes, lengths, cfg, device=cuda)
        want, want_hist = count(codes, lengths, cfg, device="cpu")
        assert np.array_equal(got.keys, want.keys) and np.array_equal(hist, want_hist)
        assert calls == [3 if count is pipeline.count_reads else 5]
    calls.clear()
    ext = config.KmerConfig(k=31, m=17, lower=1, upper=40, extension=True)
    got, _ = scheduler.count_reads_streaming_ext(codes, lengths, ext, 4000, device=cuda)
    assert got.as_dict() == pipeline.count_reads_ext(codes, lengths, ext, device="cpu")[0].as_dict()
    assert calls == [5]
