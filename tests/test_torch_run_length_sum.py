"""The port's weighted run-length sum
(hysortk_tpu_torch.ops.run_length_sum / ops.count.run_length_sum) against
the JAX package's Pallas kernel in interpret mode (block_rows=2, 256-slot
blocks) and its XLA run_length_sum. Exact equality. The hard cases of
hysortk_tpu_torch.testing.sum_cases run here at a tile of 256 slots (the JAX
kernel's block in interpret mode) and on the card at the CUDA kernel's
tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import count as jcount
from hysortk_tpu.ops import pallas_count, pallas_sort
from hysortk_tpu.ops import sort as jsort
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import count as count_ops
from hysortk_tpu_torch.ops import run_length_sum as sum_ops

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


def _sorted_runs(rng, run_lengths, n_words, n_sentinel):
    """Sorted keys with the given run lengths (distinct keys, many with the
    top bit set), then a sentinel tail. Returns (n_words, n) uint32."""
    n_runs = len(run_lengths)
    keys = rng.integers(0, 2**32, (n_runs * 2, n_words), dtype=np.uint64).astype(np.uint32)
    keys = np.unique(keys, axis=0)  # lexicographically sorted rows
    keys = keys[np.sort(rng.choice(keys.shape[0], n_runs, replace=False))]
    body = np.repeat(keys, run_lengths, axis=0).T
    tail = np.full((n_words, n_sentinel), FULL, dtype=np.uint32)
    return np.ascontiguousarray(np.concatenate([body, tail], axis=1))


CASES = {
    # a 600-slot run spans three 256-slot blocks
    "run_spans_blocks": (lambda rng: [5, 600] + list(rng.integers(1, 9, 40)), 37),
    "no_sentinel": (lambda rng: list(rng.integers(1, 12, 150)), 0),
    "one_heavy_run": (lambda rng: [1500], 100),
    "all_singletons": (lambda rng: [1] * 700, 68),
    "random_top_bit": (lambda rng: list(rng.integers(1, 10, 300)), 251),
}


def _case(name, n_words):
    """(words (n_words, n) uint32, weights (n,) int32 up to 65535; sentinel
    slots carry weights too, which must count 0)."""
    rng = np.random.default_rng(len(name) * 11 + n_words)
    make_runs, n_sentinel = CASES[name]
    words = _sorted_runs(rng, make_runs(rng), n_words, n_sentinel)
    weights = rng.integers(1, 65536, words.shape[1]).astype(np.int32)
    return words, weights


def _to_torch(words, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)
            for w in words]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_sum_matches_jax_kernel_and_xla(name, n_words):
    words, weights = _case(name, n_words)
    head, total = sum_ops.run_length_sum_fused(
        _to_torch(words), torch.from_numpy(weights)
    )
    jwords = [jnp.asarray(w) for w in words]
    phead, ptotal = pallas_count.run_length_sum_fused(
        jwords, jnp.asarray(weights.astype(np.uint32)), block_rows=2
    )
    xhead, xtotal = jcount.run_length_sum(
        jsort.sentinel_valid(jwords), jwords, jnp.asarray(weights)
    )
    assert head.dtype == torch.bool and total.dtype == torch.int32
    assert np.array_equal(head.numpy(), np.asarray(phead))
    assert np.array_equal(total.numpy(), np.asarray(ptotal))
    assert np.array_equal(head.numpy(), np.asarray(xhead))
    assert np.array_equal(total.numpy(), np.asarray(xtotal))
    valid = ~np.all(words == FULL, axis=0)
    assert int(total.sum()) == int(weights[valid].sum())
    if name == "one_heavy_run":
        assert total.numpy()[0] == weights[:1500].sum() and head.sum() == 1


CPU_TILE = 256  # block_rows=2 of the JAX kernel
HARD_CASES = testing.sum_cases(CPU_TILE)


@pytest.mark.parametrize("case", HARD_CASES, ids=[c[0] for c in HARD_CASES])
def test_sum_hard_cases_match_jax_kernel_and_xla(case):
    """Runs against tile edges, walks over many tiles without a boundary,
    totals that wrap across tiles, signed and zero weights, weights on
    sentinel slots: wrapper == JAX kernel == XLA == the runs' own sums."""
    name, runs, n_sentinel, n_words, kind = case
    words = testing.count_case_words(runs, n_sentinel, n_words, 13)
    weights = testing.sum_case_weights(kind, runs, n_sentinel, 13)
    n = words.shape[1]
    assert n == sum(runs) + n_sentinel == weights.shape[0]
    head, total = sum_ops.run_length_sum_fused(
        _to_torch(words), torch.from_numpy(weights)
    )
    jwords = [jnp.asarray(w) for w in words]
    phead, ptotal = pallas_count.run_length_sum_fused(
        jwords, jnp.asarray(weights.view(np.uint32)), block_rows=CPU_TILE // 128
    )
    xhead, xtotal = jcount.run_length_sum(
        jsort.sentinel_valid(jwords), jwords, jnp.asarray(weights)
    )
    assert np.array_equal(head.numpy(), np.asarray(phead))
    assert np.array_equal(total.numpy(), np.asarray(ptotal))
    assert np.array_equal(head.numpy(), np.asarray(xhead))
    assert np.array_equal(total.numpy(), np.asarray(xtotal))
    # Independent of all three: heads at the runs' first slots, each with
    # its run's weights summed in int64 and cut to int32.
    starts = np.cumsum([0] + list(runs[:-1])).astype(np.int64) if runs else []
    assert np.array_equal(np.nonzero(head.numpy())[0], starts)
    want = np.zeros(n, dtype=np.int32)
    want[starts] = testing.run_sums(runs, weights)
    assert np.array_equal(total.numpy(), want)
    if kind == "wrap":
        wide = np.add.reduceat(weights[:sum(runs)].astype(np.int64), starts)
        assert (np.abs(wide) >= 2**32).sum() >= 2  # two runs wrap
    if kind == "signed":
        assert total.numpy()[0] < 0 and (weights[:sum(runs)] < 0).any()


def test_run_length_sum_matches_jax_with_explicit_valid():
    """The plain run_length_sum takes an explicit validity mask, as the JAX
    one does; with weights == valid it reduces to run_length_count."""
    words, weights = _case("random_top_bit", 2)
    n = words.shape[1]
    valid = np.ones(n, bool)
    valid[n - 251:] = False
    twords = _to_torch(words)
    head, total = count_ops.run_length_sum(
        torch.from_numpy(valid), twords, torch.from_numpy(weights)
    )
    jwords = [jnp.asarray(w) for w in words]
    jhead, jtotal = jcount.run_length_sum(
        jnp.asarray(valid), jwords, jnp.asarray(weights)
    )
    assert np.array_equal(head.numpy(), np.asarray(jhead))
    assert np.array_equal(total.numpy(), np.asarray(jtotal))
    chead, cnt = count_ops.run_length_count(torch.from_numpy(valid), twords)
    ohead, ones = count_ops.run_length_sum(
        torch.from_numpy(valid), twords, torch.from_numpy(valid.astype(np.int32))
    )
    assert torch.equal(chead, ohead) and torch.equal(cnt, ones)


def test_sums_wrap_in_int32():
    """Totals are int32 and wrap: three weights of 2^30 sum to -2^30."""
    words = np.array([[3, 3, 3, 9]], dtype=np.uint32)
    weights = np.array([2**30, 2**30, 2**30, 7], dtype=np.int32)
    head, total = sum_ops.run_length_sum_fused(
        _to_torch(words), torch.from_numpy(weights)
    )
    assert head.tolist() == [True, False, False, True]
    assert total.tolist() == [3 * 2**30 - 2**32, 0, 0, 7]


def test_bad_inputs_refused():
    words, weights = _case("no_sentinel", 2)
    t = _to_torch(words)
    with pytest.raises(ValueError):
        sum_ops.run_length_sum_fused(t, torch.from_numpy(weights[:-1].copy()))
    with pytest.raises(ValueError):
        sum_ops.run_length_sum_fused(t, torch.from_numpy(weights).to(torch.int64))
    with pytest.raises(ValueError):
        sum_ops.run_length_sum_fused([], torch.from_numpy(weights))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_words", [1, 2, 4, 6])
def test_sum_kernel_matches_plain_on_cuda(cuda, name, n_words):
    from hysortk_tpu_torch import _build

    words, weights = _case(name, n_words)
    twords = _to_torch(words, cuda)
    tweights = torch.from_numpy(weights).to(cuda)
    before = _build.launches["run_length_sum"]
    got = sum_ops.run_length_sum_fused(twords, tweights)
    assert _build.launches["run_length_sum"] == before + 1
    want = sum_ops.run_length_sum_fused_plain(twords, tweights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", testing.sum_cases(),
                         ids=[c[0] for c in testing.sum_cases()])
def test_sum_kernel_hard_cases_on_cuda(cuda, case, offset):
    """The hard cases at the kernel's own tile; offset 1 hands it rows that
    are views one word into their buffers (4-byte alignment only). One
    launch a call."""
    from hysortk_tpu_torch import _build

    name, runs, n_sentinel, n_words, kind = case
    rows = list(testing.count_case_words(runs, n_sentinel, n_words, 13))
    rows.append(testing.sum_case_weights(kind, runs, n_sentinel, 13).view(np.uint32))
    views = []
    for r in _to_torch(rows, cuda):
        buf = torch.empty(r.shape[0] + offset, dtype=torch.int32, device=cuda)
        buf[offset:] = r
        views.append(buf[offset:])
    words, weights = views[:-1], views[-1]
    before = _build.launches["run_length_sum"]
    got = sum_ops.run_length_sum_fused(words, weights)
    assert _build.launches["run_length_sum"] == before + 1
    want = sum_ops.run_length_sum_fused_plain(words, weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
