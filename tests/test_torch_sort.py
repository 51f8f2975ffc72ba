"""The port's multiword sort (hysortk_tpu_torch.ops.radix_sort / ops.sort)
against the JAX package's member-tile Pallas sort in interpret mode and its
XLA sort. Keys-only sorts are fully determined, so sorted words compare
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import pallas_sort
from hysortk_tpu.ops import sort as jsort
from hysortk_tpu_torch.ops import radix_sort
from hysortk_tpu_torch.ops import sort as sort_ops

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


def _hard_keys(rng, n, n_words):
    """(n_words, n) uint32 words: full-range values (top bit set in about
    half), a pool of exact duplicates, word-0 ties that differ only in the
    last word, and a sentinel tail."""
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    dup = rng.integers(0, n, n // 4)
    words[:, dup] = words[:, rng.integers(0, 16, n // 4)]
    tie = rng.integers(0, n, n // 4)
    words[0, tie] = 0x80000007
    words[-1, tie[: n // 8]] = 0xFFFFFFF0 + (tie[: n // 8] % 3).astype(np.uint32)
    words[:, n - n // 10 :] = FULL
    return words


def _to_torch(words):
    return [torch.from_numpy(np.ascontiguousarray(w).view(np.int32)) for w in words]


def _np_lexsorted(words):
    order = np.lexsort(tuple(words[::-1]))
    return words[:, order]


# n not a multiple of the interpret-mode block (2048 elements): W = 1 and 2
# cross merge levels; W = 4 stays inside one block to bound interpret time.
@pytest.mark.parametrize("n_words,n", [(1, 3 * 2048 + 17), (2, 2048 + 517), (4, 1500)])
def test_sort_matches_jax_member_sort(n_words, n):
    rng = np.random.default_rng(n_words)
    words = _hard_keys(rng, n, n_words)
    got, _ = radix_sort.sort_words(_to_torch(words))
    want, _ = pallas_sort.sort_words(
        [jnp.asarray(w) for w in words], formulation="member"
    )
    expect = _np_lexsorted(words)
    for w in range(n_words):
        g = got[w].numpy().view(np.uint32)
        assert np.array_equal(g, np.asarray(want[w])), f"word {w}"
        assert np.array_equal(g, expect[w]), f"word {w}"
    assert (expect[0] >= 0x80000000).any()


@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_sort_keys_matches_jax_xla(n_words):
    """sort_keys folds the invalid mask into the sentinel like the JAX
    version; the recovered invalid flags and the words agree."""
    rng = np.random.default_rng(10 + n_words)
    n = 4000
    words = _hard_keys(rng, n, n_words)
    invalid = rng.random(n) < 0.2
    inv_s, got, _ = sort_ops.sort_keys(torch.from_numpy(invalid), _to_torch(words))
    jinv, want, _ = jsort.sort_keys(
        jnp.asarray(invalid), [jnp.asarray(w) for w in words], backend="xla"
    )
    assert np.array_equal(inv_s.numpy(), np.asarray(jinv).astype(np.int32))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(x))


def test_sort_is_stable_with_payloads():
    """Payload words ride along and equal keys keep their input order (the
    LSD passes rely on it); as a multiset the pairs match the JAX sort."""
    rng = np.random.default_rng(3)
    n = 3000
    words = _hard_keys(rng, n, 2)
    pay = np.arange(n, dtype=np.uint32)
    got_w, got_p = radix_sort.sort_words(_to_torch(words), _to_torch([pay]))
    order = np.lexsort((pay, words[1], words[0]))
    assert np.array_equal(got_p[0].numpy().view(np.uint32), pay[order])
    jw, jp = jsort.sort_marked(
        [jnp.asarray(w) for w in words], [jnp.asarray(pay)], backend="xla"
    )[1:]
    key = lambda ws, p: sorted(zip(*[np.asarray(w).tolist() for w in ws], np.asarray(p).tolist()))
    assert key([g.numpy().view(np.uint32) for g in got_w], got_p[0].numpy().view(np.uint32)) \
        == key(jw, jp[0])


def test_sentinel_valid_matches_jax():
    rng = np.random.default_rng(4)
    words = _hard_keys(rng, 1000, 2)
    words[0, :50] = FULL  # all-ones word 0 alone is not the sentinel
    got = sort_ops.sentinel_valid(_to_torch(words))
    want = jsort.sentinel_valid([jnp.asarray(w) for w in words])
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sort_rejects_bad_input():
    w = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_sort.sort_words([w] * 7)
    with pytest.raises(ValueError):
        radix_sort.sort_words([w, w[:5]])
    with pytest.raises(ValueError):
        radix_sort.sort_words([w.to(torch.int64)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1, 2, 3, 4, 5, 6])
def test_radix_kernel_matches_plain_on_cuda(cuda, n_words):
    from hysortk_tpu_torch import _build

    rng = np.random.default_rng(20 + n_words)
    n = 100_003  # several tiles, ragged last tile
    words = [w.to(cuda) for w in _to_torch(_hard_keys(rng, n, n_words))]
    pay = [torch.arange(n, dtype=torch.int32, device=cuda)]
    before = _build.launches["radix_sort"]
    got_w, got_p = radix_sort.sort_words(words, pay)
    assert _build.launches["radix_sort"] == before + 1
    want_w, want_p = radix_sort.sort_words_plain(words, pay)
    for g, x in zip(got_w + got_p, want_w + want_p):
        assert torch.equal(g, x)
