"""The port's block sort (hysortk_tpu_torch.ops.block_sort) and the
block-sort-then-merge formulation of the sort (sort_words(formulation="roll"))
against the JAX package's pallas_sort.block_bitonic_sort and
pallas_sort.sort_words(formulation="roll") in interpret mode (16-row blocks,
2048 slots). Key rows compare exactly; the JAX network is unstable, so (key,
payload) pairs compare as per-block multisets. Within the port, kernel,
plain version and the radix sort are all stable and compare exactly. The hard
cases of hysortk_tpu_torch.testing.block_sort_cases run here around a chunk
of 64 slots and on the card around the CUDA kernel's chunk."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import pallas_sort
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import block_sort, radix_sort
from hysortk_tpu_torch.ops import sort as sort_ops

FULL = np.uint32(0xFFFFFFFF)
BLOCK = 2048  # 16 rows of 128 lanes


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
    """(n_words, n) uint32 words: full-range values, a pool of exact
    duplicates spread over every block, word-0 ties that differ only in the
    last word, and a sentinel tail."""
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    dup = rng.integers(0, n, n // 4)
    words[:, dup] = words[:, rng.integers(0, 16, n // 4)]
    tie = rng.integers(0, n, n // 4)
    words[0, tie] = 0x80000007
    words[-1, tie[: n // 8]] = 0xFFFFFFF0 + (tie[: n // 8] % 3).astype(np.uint32)
    words[:, n - n // 10:] = FULL
    return words


def _to_torch(rows):
    return [torch.from_numpy(np.ascontiguousarray(r).view(np.int32)) for r in rows]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n_words,n_pay", [(1, 0), (2, 1), (4, 2)])
def test_block_sort_matches_jax_kernel(n_words, n_pay):
    rng = np.random.default_rng(n_words)
    n = 4 * BLOCK if n_words < 4 else 2 * BLOCK
    words = _hard_keys(rng, n, n_words)
    pay = [np.arange(n, dtype=np.uint32) * 3 + j for j in range(n_pay)]
    rows = list(words) + pay
    got = block_sort.block_bitonic_sort(_to_torch(rows), n_words, BLOCK)
    want = pallas_sort.block_bitonic_sort(
        [jnp.asarray(r) for r in rows], n_words, BLOCK // 128
    )
    got = np.stack([_u32(g) for g in got])
    want = np.stack([np.asarray(w) for w in want])
    assert np.array_equal(got[:n_words], want[:n_words])
    assert np.array_equal(got, testing.stable_block_order(rows, n_words, BLOCK, True))
    for b in range(n // BLOCK):  # (key, payload) pairs, block by block
        cols = slice(b * BLOCK, (b + 1) * BLOCK)
        assert sorted(zip(*got[:, cols].tolist())) == \
            sorted(zip(*want[:, cols].tolist()))
    # Even blocks ascend, odd blocks descend.
    assert got[0, 0] <= got[0, BLOCK - 1] and got[0, BLOCK] >= got[0, 2 * BLOCK - 1]


@pytest.mark.parametrize("descending_odd", [True, False])
@pytest.mark.parametrize("n_words,n_pay,block", [(1, 2, 64), (2, 0, 256),
                                                  (3, 1, 128), (6, 2, 32)])
def test_block_sort_plain_is_stable(n_words, n_pay, block, descending_odd):
    rng = np.random.default_rng(7 * n_words + block)
    n = 8 * block
    words = _hard_keys(rng, n, n_words)
    words[:, block - 5:block + 5] = 9  # duplicates that span a block edge
    rows = list(words) + [np.arange(n, dtype=np.uint32) + j for j in range(n_pay)]
    got = block_sort.block_bitonic_sort(_to_torch(rows), n_words, block, descending_odd)
    want = testing.stable_block_order(rows, n_words, block, descending_odd)
    assert np.array_equal(np.stack([_u32(g) for g in got]), want)


HARD_CASES = testing.block_sort_cases(64)


@pytest.mark.parametrize("case", HARD_CASES, ids=[c[0] for c in HARD_CASES])
def test_block_sort_hard_cases(case):
    """Every block size from 2 to the kernel's largest, the other kinds of
    keys, every number of payload rows: the wrapper against numpy's stable
    order, both orientations."""
    name, kind, n_words, n_pay, block, n_blocks = case
    rows = testing.block_sort_case_rows(kind, n_words, n_pay, block, n_blocks, 13)
    assert rows.shape == (n_words + n_pay, block * n_blocks)
    for descending_odd in (True, False):
        got = block_sort.block_bitonic_sort(_to_torch(rows), n_words, block,
                                            descending_odd)
        want = testing.stable_block_order(rows, n_words, block, descending_odd)
        assert np.array_equal(np.stack([_u32(g) for g in got]), want)


@pytest.mark.parametrize("kind", testing.BLOCK_SORT_KINDS)
def test_block_sort_kinds_match_jax_kernel(kind):
    """Each kind of keys through the JAX kernel too, at its smallest block
    in interpret mode (8 rows of 128 lanes): key rows exactly, (key, payload)
    pairs as per-block multisets."""
    n_words, n_pay, block, n_blocks = 2, 1, 1024, 2
    rows = testing.block_sort_case_rows(kind, n_words, n_pay, block, n_blocks, 13)
    got = block_sort.block_bitonic_sort(_to_torch(rows), n_words, block)
    want = pallas_sort.block_bitonic_sort(
        [jnp.asarray(r) for r in rows], n_words, block // 128
    )
    got = np.stack([_u32(g) for g in got])
    want = np.stack([np.asarray(w) for w in want])
    assert np.array_equal(got[:n_words], want[:n_words])
    for b in range(n_blocks):
        cols = slice(b * block, (b + 1) * block)
        assert sorted(zip(*got[:, cols].tolist())) == \
            sorted(zip(*want[:, cols].tolist()))


@pytest.mark.parametrize("n_words,n", [(1, 3 * BLOCK + 17), (2, BLOCK + 517), (4, 1500)])
def test_roll_formulation_matches_member_and_jax(n_words, n):
    rng = np.random.default_rng(20 + n_words)
    words = _hard_keys(rng, n, n_words)
    pay = [np.arange(n, dtype=np.uint32), rng.integers(0, 9, n).astype(np.uint32)]
    member = radix_sort.sort_words(_to_torch(words), _to_torch(pay))
    roll = radix_sort.sort_words(_to_torch(words), _to_torch(pay),
                                 formulation="roll", block=BLOCK)
    for a, b in zip(member[0] + member[1], roll[0] + roll[1]):
        assert torch.equal(a, b)
    want, _ = pallas_sort.sort_words(
        [jnp.asarray(w) for w in words], formulation="roll"
    )
    for g, w in zip(roll[0], want):
        assert np.array_equal(_u32(g), np.asarray(w))
    # The default block, and sort_marked / sort_keys passing it through.
    inv, via_marked, _ = sort_ops.sort_marked(_to_torch(words), formulation="roll")
    for a, b in zip(member[0], via_marked):
        assert torch.equal(a, b)
    assert int(inv.sum()) == n // 10
    invalid = torch.from_numpy(rng.random(n) < 0.2)
    a = sort_ops.sort_keys(invalid, _to_torch(words), _to_torch(pay))
    b = sort_ops.sort_keys(invalid, _to_torch(words), _to_torch(pay), "roll")
    for x, y in zip([a[0]] + a[1] + a[2], [b[0]] + b[1] + b[2]):
        assert torch.equal(x, y)


def test_block_sort_rejects_bad_geometry():
    w = torch.zeros(4096, dtype=torch.int32)
    for block in (0, 1, 48, 8192):  # not a power of two >= 2, or no divisor
        with pytest.raises(ValueError):
            block_sort.block_bitonic_sort([w], 1, block)
    with pytest.raises(ValueError):
        block_sort.block_bitonic_sort([w] * 9, 2, 64)
    with pytest.raises(ValueError):
        block_sort.block_bitonic_sort([w] * 7, 7, 64)
    with pytest.raises(ValueError):
        block_sort.block_bitonic_sort([w, w.to(torch.int64)], 1, 64)
    # A block the kernel cannot hold raises; it does not fall to another sort.
    assert [block_sort.max_block(w_) for w_ in (1, 2, 3, 4, 6)] == \
        [16384, 16384, 8192, 8192, 8192]
    big = torch.zeros(1 << 15, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        block_sort.block_bitonic_sort([big], 1, 1 << 15)
    with pytest.raises(ValueError, match="shared memory"):
        radix_sort.sort_words([big] * 3, formulation="roll", block=1 << 14)
    with pytest.raises(ValueError, match="formulation"):
        radix_sort.sort_words([w], formulation="bitonic")


@pytest.mark.cuda
@pytest.mark.parametrize("descending_odd", [True, False])
@pytest.mark.parametrize("n_words,n_pay,block", [
    (1, 0, 2048), (1, 2, 16384), (2, 2, 2048), (2, 0, 16384), (3, 1, 64),
    (4, 2, 8192), (6, 2, 8192), (2, 1, 2),
])
def test_block_sort_kernel_matches_plain_on_cuda(cuda, n_words, n_pay, block,
                                                 descending_odd):
    from hysortk_tpu_torch import _build

    rng = np.random.default_rng(50 + n_words + block)
    n = 8 * block
    words = _hard_keys(rng, n, n_words)
    words[:, block - 5:block + 5] = 9
    rows = list(words) + [np.arange(n, dtype=np.uint32) + j for j in range(n_pay)]
    rows = [r.to(cuda) for r in _to_torch(rows)]
    before = _build.launches["block_sort"]
    got = block_sort.block_bitonic_sort(rows, n_words, block, descending_odd)
    assert _build.launches["block_sort"] == before + 1
    want = block_sort.block_bitonic_sort_plain(rows, n_words, block, descending_odd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", testing.block_sort_cases(),
                         ids=[c[0] for c in testing.block_sort_cases()])
def test_block_sort_kernel_hard_cases_on_cuda(cuda, case, offset):
    """The hard cases around the kernel's own chunk; offset 1 hands it rows
    that are views one word into their buffers (4-byte alignment only)."""
    name, kind, n_words, n_pay, block, n_blocks = case
    rows = []
    for r in _to_torch(testing.block_sort_case_rows(
            kind, n_words, n_pay, block, n_blocks, 13)):
        buf = torch.empty(r.shape[0] + offset, dtype=torch.int32, device=cuda)
        buf[offset:] = r
        rows.append(buf[offset:])
    for descending_odd in (True, False):
        got = block_sort.block_bitonic_sort(rows, n_words, block, descending_odd)
        want = block_sort.block_bitonic_sort_plain(rows, n_words, block,
                                                   descending_odd)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_roll_formulation_on_cuda_matches_member(cuda, n_words):
    from hysortk_tpu_torch import _build

    rng = np.random.default_rng(60 + n_words)
    n = 100_003
    words = [w.to(cuda) for w in _to_torch(_hard_keys(rng, n, n_words))]
    pay = [torch.arange(n, dtype=torch.int32, device=cuda)]
    before = dict(_build.launches)
    roll = radix_sort.sort_words(words, pay, formulation="roll")
    assert _build.launches["block_sort"] == before["block_sort"] + 1
    assert _build.launches["merge_runs"] == before["merge_runs"] + 1
    assert _build.launches["radix_sort"] == before["radix_sort"]
    member = radix_sort.sort_words(words, pay)
    for a, b in zip(member[0] + member[1], roll[0] + roll[1]):
        assert torch.equal(a, b)
