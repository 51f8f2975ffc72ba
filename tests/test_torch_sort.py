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
from hysortk_tpu_torch import testing
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


# The sorts' hard cases of hysortk_tpu_torch.testing. On the CPU they run
# through the plain version at a small tile (the sizes straddle 64 slots as
# the card's straddle the kernel's 8192) against the JAX package's sorts; on
# the card they run kernel against plain at the kernel's own tile.
CPU_TILE = 64
CPU_CASES = testing.sort_cases(CPU_TILE)
CARD_CASES = testing.sort_cases(testing.SORT_TILE)


def _case_inputs(kind, n, n_words, n_payloads, seed):
    words = testing.sort_case_words(kind, n, n_words, seed)
    pays = testing.sort_case_payloads(n, n_payloads)
    return words, pays


@pytest.mark.parametrize("name,kind,n,n_words,n_payloads", CPU_CASES,
                         ids=[c[0] for c in CPU_CASES])
def test_sort_hard_cases_match_jax(name, kind, n, n_words, n_payloads):
    """Keys bit-equal to the JAX sort (tolerance 0): the member-tile Pallas
    sort in interpret mode for the keys-only multi-tile cases, ops/sort's XLA
    sort for the others. Payloads against numpy's stable lexsort: the JAX
    sort is unstable, the port's keeps equal keys in input order."""
    words, pays = _case_inputs(kind, n, n_words, n_payloads, seed=11)
    got_w, got_p = radix_sort.sort_words(_to_torch(words), _to_torch(pays))
    jwords = [jnp.asarray(w) for w in words]
    if n_payloads == 0 and n > CPU_TILE + 1:
        want, _ = pallas_sort.sort_words(jwords, formulation="member")
    else:
        want = jsort.sort_marked(jwords, [jnp.asarray(p) for p in pays],
                                 backend="xla")[1]
    order = testing.stable_order(words)
    assert len(got_w) == n_words and len(got_p) == n_payloads
    for g, j, w in zip(got_w, want, words):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(j))
        assert np.array_equal(g.numpy().view(np.uint32), w[order])
    for g, p in zip(got_p, pays):
        assert np.array_equal(g.numpy().view(np.uint32), p[order])


def test_sort_case_generators_are_what_they_say():
    n = 3 * CPU_TILE + 17
    for w in (1, 2, 6):
        same = testing.sort_case_words("all_equal", n, w, 1)
        assert (same == same[:, :1]).all()
        one = testing.sort_case_words("one_digit", n, w, 1)
        varying = [(word >> shift) & 0xFF for word in one for shift in (0, 8, 16, 24)]
        assert sum(len(np.unique(d)) > 1 for d in varying) == 1
        tail = testing.sort_case_words("sentinel_tail", n, w, 1)
        assert (tail[:, n - n // 8:] == FULL).all() and (tail[:, 0] != FULL).any()
    assert testing.sort_case_sizes(8192) == [1, 8191, 8192, 8193, 24593]
    shapes = {(w, p) for _, _, _, w, p in CARD_CASES}
    assert {(w, 2) for w in range(1, 7)} | {(1, 6), (2, 6), (2, 0)} <= shapes
    assert np.array_equal(testing.sort_case_payloads(4, 2),
                          np.array([[0, 1, 2, 3], [1, 2, 3, 4]], dtype=np.uint32))


def test_sort_leaves_its_inputs_alone():
    """The caller's rows are read only and never handed back."""
    words, pays = _case_inputs("sentinel_tail", 500, 2, 1, seed=5)
    tw, tp = _to_torch(words), _to_torch(pays)
    got_w, got_p = radix_sort.sort_words(tw, tp)
    for t, w in zip(tw + tp, list(words) + list(pays)):
        assert np.array_equal(t.numpy().view(np.uint32), w)
    assert not {t.data_ptr() for t in tw + tp} & {t.data_ptr() for t in got_w + got_p}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,n,n_words,n_payloads", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_radix_kernel_hard_cases_on_cuda(cuda, name, kind, n, n_words, n_payloads):
    words, pays = _case_inputs(kind, n, n_words, n_payloads, seed=12)
    tw = [w.to(cuda) for w in _to_torch(words)]
    tp = [p.to(cuda) for p in _to_torch(pays)]
    got_w, got_p = radix_sort.sort_words(tw, tp)
    want_w, want_p = radix_sort.sort_words_plain(tw, tp)
    for g, x in zip(got_w + got_p, want_w + want_p):
        assert torch.equal(g, x)
    for t, w in zip(tw + tp, list(words) + list(pays)):
        assert np.array_equal(t.cpu().numpy().view(np.uint32), w)
