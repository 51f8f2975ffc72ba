"""The port's run merge (hysortk_tpu_torch.ops.merge.merge_sorted_runs)
against the JAX package's bitonic merge network (ops/merge._merge_network_xla)
and its Pallas merge_runs in interpret mode. Key rows compare exactly; the
JAX merges are unstable, so payloads compare as per-key sums. Against a
stable numpy sort of the concatenation the port compares exactly, payloads
included. The hard cases of hysortk_tpu_torch.testing.merge_cases run here
at a tile of 64 slots and on the card at the kernel's tiles. Integer work:
no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import merge as jmerge
from hysortk_tpu.ops import pallas_sort
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import merge as merge_ops

FULL = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _interpret():
    prev = pallas_sort._INTERPRET
    pallas_sort.set_interpret(True)
    yield
    pallas_sort.set_interpret(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runs(seed, n_words, s, run_len):
    """S sorted runs of run_len slots as (n_words + 1, S * run_len) uint32:
    keys drawn from a shared pool (so keys repeat within and across runs,
    half of them with the top bit set), sentinel tails of different lengths
    (one run all sentinel when S > 2), and a payload row of small weights
    (0 at sentinel slots)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (run_len // 2, n_words), dtype=np.uint64)
    pool = pool.astype(np.uint32)
    rows = np.full((n_words + 1, s, run_len), FULL, dtype=np.uint32)
    rows[n_words] = 0
    for r in range(s):
        m = int(rng.integers(run_len // 2, run_len + 1)) if r != 1 else run_len
        if s > 2 and r == s - 1:
            m = 0
        keys = pool[rng.integers(0, pool.shape[0], m)]
        order = np.lexsort(tuple(keys[:, w] for w in range(n_words - 1, -1, -1)))
        rows[:n_words, r, :m] = keys[order].T
        rows[n_words, r, :m] = rng.integers(1, 9, m)
    return np.ascontiguousarray(rows.reshape(n_words + 1, s * run_len))


def _to_torch(rows, device="cpu"):
    return [torch.from_numpy(r.view(np.int32)).to(device) for r in rows]


def _stable_sort(rows, n_words):
    order = np.lexsort(tuple(rows[w] for w in range(n_words - 1, -1, -1)))
    return rows[:, order]


def _key_sums(rows, n_words):
    """{key tuple: sums of the payload rows} of merged rows."""
    sums = {}
    for col in zip(*[r.tolist() for r in rows]):
        key, pays = col[:n_words], col[n_words:]
        old = sums.get(key, (0,) * len(pays))
        sums[key] = tuple(a + b for a, b in zip(old, pays))
    return sums


def _merged_np(rows, n_words, run_len, device="cpu"):
    out = merge_ops.merge_sorted_runs(_to_torch(rows, device), n_words, run_len)
    return np.stack([o.cpu().numpy().view(np.uint32) for o in out])


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_merge_matches_jax_network(n_words, s):
    run_len = 256
    rows = _runs(n_words * 10 + s, n_words, s, run_len)
    got = _merged_np(rows, n_words, run_len)
    network = jax.jit(jmerge._merge_network_xla, static_argnums=(1, 2))
    want = network([jnp.asarray(r) for r in rows], n_words, run_len)
    want = np.stack([np.asarray(w) for w in want])
    assert np.array_equal(got[:n_words], want[:n_words])
    assert _key_sums(got, n_words) == _key_sums(want, n_words)
    assert np.array_equal(got, _stable_sort(rows, n_words))


@pytest.mark.parametrize("n_words,s", [(1, 8), (2, 4), (4, 2)])
def test_merge_matches_pallas_merge_runs(n_words, s):
    run_len = 2048  # one 16 x 128 member block per run
    rows = _runs(n_words * 100 + s, n_words, s, run_len)
    got = _merged_np(rows, n_words, run_len)
    want = pallas_sort.merge_runs(
        [jnp.asarray(r) for r in rows], n_words, run_len, block_rows=16,
        formulation="member",
    )
    want = np.stack([np.asarray(w) for w in want])
    assert np.array_equal(got[:n_words], want[:n_words])
    assert _key_sums(got, n_words) == _key_sums(want, n_words)


def test_single_run_returns_input_and_bad_shapes_refused():
    rows = _to_torch(_runs(1, 2, 2, 64))
    out = merge_ops.merge_sorted_runs(rows, 2, 128)
    assert all(o is r for o, r in zip(out, rows))
    with pytest.raises(AssertionError):
        merge_ops.merge_sorted_runs(rows, 2, 96)  # run length not a power of two
    with pytest.raises(AssertionError):
        merge_ops.merge_sorted_runs([r[:96] for r in rows], 2, 32)  # 3 runs
    with pytest.raises(ValueError):
        merge_ops.merge_sorted_runs([r.to(torch.int64) for r in rows], 2, 64)
    with pytest.raises(ValueError):
        merge_ops.merge_sorted_runs(rows, 4, 64)  # more key words than rows


def test_merge_is_stable_across_runs():
    """Equal keys keep run order, and the order within their run."""
    key = np.array([5, 5, 7, FULL, 5, 7, 7, FULL], dtype=np.uint32)
    pay = np.arange(8, dtype=np.uint32)
    got = _merged_np(np.stack([key, pay]), 1, 4)
    assert got[0].tolist() == [5, 5, 5, 7, 7, 7, FULL, FULL]
    assert got[1].tolist() == [0, 1, 4, 2, 5, 6, 3, 7]


CPU_TILE = 64
HARD_CASES = testing.merge_cases(CPU_TILE)


@pytest.mark.parametrize("case", HARD_CASES, ids=[c[0] for c in HARD_CASES])
def test_merge_hard_cases_match_jax_network(case):
    """Run counts of one pass and more, runs of one slot to two tiles, equal
    keys across tile edges, disjoint runs, top-bit keys, sentinel runs: the
    port equals a numpy stable sort exactly and the JAX network in its keys
    and per-key payload sums."""
    name, kind, n_words, n_pay, s, run_len = case
    rows = testing.merge_case_rows(kind, n_words, n_pay, s, run_len, 13)
    got = _merged_np(rows, n_words, run_len)
    assert np.array_equal(got, rows[:, testing.stable_order(rows[:n_words])])
    want = jmerge._merge_network_xla([jnp.asarray(r) for r in rows], n_words, run_len)
    want = np.stack([np.asarray(w) for w in want])
    assert np.array_equal(got[:n_words], want[:n_words])
    if n_pay:
        assert _key_sums(got, n_words) == _key_sums(want, n_words)


@pytest.mark.parametrize("s,fan_in,passes", [
    (2, 16, 1), (16, 16, 1), (17, 16, 2), (32, 16, 2), (64, 16, 2),
    (2**15, 16, 4), (2**15, 32, 3), (1, 16, 0),
])
def test_merge_plan_passes_and_tiles(s, fan_in, passes):
    """ceil(log_fan_in(S)) passes; each pass's groups and tiles cover every
    slot once; runs of unequal length (and empty ones) are planned alike."""
    rng = np.random.default_rng(s + fan_in)
    for lens in (np.full(s, 64), rng.integers(0, 700, s)):
        bounds = np.concatenate([[0], np.cumsum(lens)])
        plan = merge_ops.merge_plan(bounds, 256, fan_in)
        assert len(plan) == passes
        n_runs = s
        for p in plan:
            assert p.n_runs == n_runs and p.n_groups == -(-n_runs // fan_in)
            first = np.arange(0, n_runs, fan_in)
            sizes = p.bounds[np.minimum(first + fan_in, n_runs)] - p.bounds[first]
            assert np.array_equal(np.diff(p.group_tiles), -(-sizes // 256))
            assert p.bounds[0] == 0 and p.bounds[-1] == bounds[-1]
            n_runs = p.n_groups
        assert n_runs == 1
    with pytest.raises(ValueError):
        merge_ops.merge_plan([0, 5, 3], 256)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", testing.merge_cases(),
                         ids=[c[0] for c in testing.merge_cases()])
def test_merge_kernel_hard_cases_on_cuda(cuda, case, offset):
    """The hard cases at the kernel's own tiles and fan-in; offset 1 hands
    it rows that are views one word into their buffers."""
    name, kind, n_words, n_pay, s, run_len = case
    rows = []
    for r in _to_torch(testing.merge_case_rows(kind, n_words, n_pay, s, run_len, 13)):
        buf = torch.empty(r.shape[0] + offset, dtype=torch.int32, device=cuda)
        buf[offset:] = r
        rows.append(buf[offset:])
    got = merge_ops.merge_sorted_runs(rows, n_words, run_len)
    want = merge_ops.merge_sorted_runs_plain(rows, n_words, run_len)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("run_len", [1, 64, 1024, 4096])
@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("n_words", [1, 2, 4, 6])
def test_merge_kernel_matches_plain_on_cuda(cuda, n_words, s, run_len):
    from hysortk_tpu_torch import _build

    rows = _runs(n_words + s + run_len, n_words, s, max(run_len, 2))
    if run_len == 1:  # any S slots are S sorted runs of one
        rows = np.ascontiguousarray(rows[:, :s])
    tensors = _to_torch(rows, cuda)
    before = _build.launches["merge_runs"]
    got = merge_ops.merge_sorted_runs(tensors, n_words, run_len)
    assert _build.launches["merge_runs"] == before + 1
    want = merge_ops.merge_sorted_runs_plain(tensors, n_words, run_len)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(t.cpu(), r) for t, r in zip(tensors, _to_torch(rows)))
