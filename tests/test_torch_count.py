"""The port's fused run-length count + filter
(hysortk_tpu_torch.ops.fused_count / ops.count) against the JAX package's
Pallas kernel in interpret mode (block_rows=2, 256-slot blocks) and its XLA
run_length_count. Exact equality. The hard cases of
hysortk_tpu_torch.testing.count_cases run here at a tile of 256 slots (the
JAX kernel's block in interpret mode) and on the card at the CUDA kernel's
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
from hysortk_tpu_torch.ops import fused_count
from hysortk_tpu_torch.ops import sort as sort_ops

FULL = np.uint32(0xFFFFFFFF)
LOWER, UPPER = 3, 7


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
    # runs of exactly L and U, and one either side of each
    "at_lower_and_upper": (
        lambda rng: [LOWER, UPPER, LOWER - 1, UPPER + 1] * 30 + [1, 2], 64),
    "random_top_bit": (lambda rng: list(rng.integers(1, 10, 300)), 251),
}


def _case(name, n_words):
    rng = np.random.default_rng(len(name) * 7 + n_words)
    make_runs, n_sentinel = CASES[name]
    return _sorted_runs(rng, make_runs(rng), n_words, n_sentinel)


def _to_torch(words):
    return [torch.from_numpy(np.ascontiguousarray(w).view(np.int32)) for w in words]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_count_matches_jax_kernel_and_xla(name, n_words):
    words = _case(name, n_words)
    cnt, keep = fused_count.run_length_count_filter(_to_torch(words), LOWER, UPPER)
    jwords = [jnp.asarray(w) for w in words]
    pcnt, pkeep = pallas_count.run_length_count_filter(
        jwords, LOWER, UPPER, block_rows=2
    )
    head, xcnt = jcount.run_length_count(jsort.sentinel_valid(jwords), jwords)
    xkeep = jcount.frequency_filter(head, xcnt, LOWER, UPPER)
    assert cnt.dtype == torch.int32 and keep.dtype == torch.bool
    assert np.array_equal(cnt.numpy(), np.asarray(pcnt))
    assert np.array_equal(keep.numpy(), np.asarray(pkeep))
    assert np.array_equal(cnt.numpy(), np.asarray(xcnt))
    assert np.array_equal(keep.numpy(), np.asarray(xkeep))
    if name == "at_lower_and_upper":
        assert set(cnt.numpy()[keep.numpy()].tolist()) == {LOWER, UPPER}
    if name == "one_heavy_run":
        assert cnt.numpy()[0] == 1500


CPU_TILE = 256  # block_rows=2 of the JAX kernel
HARD_CASES = testing.count_cases(CPU_TILE)


@pytest.mark.parametrize("case", HARD_CASES, ids=[c[0] for c in HARD_CASES])
def test_count_hard_cases_match_jax_kernel(case):
    """Runs against tile edges, tiles without a boundary, sentinel tails on
    and beside a tile edge, ragged sizes: wrapper == JAX kernel == XLA."""
    name, runs, n_sentinel, n_words, lower, upper = case
    words = testing.count_case_words(runs, n_sentinel, n_words, 11)
    n = words.shape[1]
    assert n == sum(runs) + n_sentinel
    cnt, keep = fused_count.run_length_count_filter(_to_torch(words), lower, upper)
    jwords = [jnp.asarray(w) for w in words]
    pcnt, pkeep = pallas_count.run_length_count_filter(
        jwords, lower, upper, block_rows=CPU_TILE // 128
    )
    assert np.array_equal(cnt.numpy(), np.asarray(pcnt))
    assert np.array_equal(keep.numpy(), np.asarray(pkeep))
    # Independent of both: the heads are the runs' first slots, in order.
    starts = np.cumsum([0] + list(runs[:-1])).astype(np.int64) if runs else []
    assert np.array_equal(np.nonzero(cnt.numpy())[0], starts)
    assert np.array_equal(cnt.numpy()[starts], np.asarray(runs, dtype=np.int32))
    kept = [lower <= r <= upper for r in runs]
    assert np.array_equal(keep.numpy()[starts], np.asarray(kept, dtype=bool))
    assert int(keep.sum()) == sum(kept)


def test_run_length_count_matches_jax_with_interior_invalid():
    """The plain run_length_count takes an explicit validity mask, as the
    JAX one does; heads and counts agree on validity-first sorted input."""
    words = _case("random_top_bit", 2)
    n = words.shape[1]
    valid = np.ones(n, bool)
    valid[n - 251 :] = False
    head, cnt = count_ops.run_length_count(torch.from_numpy(valid), _to_torch(words))
    jhead, jcnt = jcount.run_length_count(
        jnp.asarray(valid), [jnp.asarray(w) for w in words]
    )
    assert np.array_equal(head.numpy(), np.asarray(jhead))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    keep = count_ops.frequency_filter(head, cnt, LOWER, UPPER)
    jkeep = jcount.frequency_filter(jhead, jcnt, LOWER, UPPER)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(
        sort_ops.sentinel_valid(_to_torch(words)).numpy(), valid
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_words", [1, 2, 4, 6])
def test_count_kernel_matches_plain_on_cuda(cuda, name, n_words):
    from hysortk_tpu_torch import _build

    words = [w.to(cuda) for w in _to_torch(_case(name, n_words))]
    before = _build.launches["fused_count"]
    got = fused_count.run_length_count_filter(words, LOWER, UPPER)
    assert _build.launches["fused_count"] == before + 1
    want = fused_count.run_length_count_filter_plain(words, LOWER, UPPER)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", testing.count_cases(),
                         ids=[c[0] for c in testing.count_cases()])
def test_count_kernel_hard_cases_on_cuda(cuda, case, offset):
    """The hard cases at the kernel's own tile; offset 1 hands it rows that
    are views one word into their buffers (4-byte alignment only)."""
    name, runs, n_sentinel, n_words, lower, upper = case
    words = []
    for w in _to_torch(testing.count_case_words(runs, n_sentinel, n_words, 11)):
        buf = torch.empty(w.shape[0] + offset, dtype=torch.int32, device=cuda)
        buf[offset:] = w
        words.append(buf[offset:])
    got = fused_count.run_length_count_filter(words, lower, upper)
    want = fused_count.run_length_count_filter_plain(words, lower, upper)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
