"""The port's key mix and the sharded path's pure helpers against the JAX
package, on the CPU: fmix32, mix_keys (its plain version here; the kernel of
csrc/mixkey.cu on the card, `cuda` marker), the numpy mix and its inverse,
range_destinations / range_boundaries, split_capacity, the classifier and
dispatchers, and range_capacity. Integer work: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu import KmerConfig as JKmerConfig
from hysortk_tpu.ops import hashes as jhashes
from hysortk_tpu.ops import mixkey as jmixkey
from hysortk_tpu.ops import spill as jspill
from hysortk_tpu.parallel import dispatch as jdispatch
from hysortk_tpu.parallel import pipeline as jsharded
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.config import KmerConfig
from hysortk_tpu_torch.ops import hashes, mixkey, spill
from hysortk_tpu_torch.parallel import dispatch
from hysortk_tpu_torch.parallel import pipeline as sharded

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF, 0x85EBCA6B, 0xC2B2AE35], dtype=np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(words: np.ndarray, device="cpu", offset: int = 0):
    """(W, n) uint32 -> W int32 tensors, each `offset` words into its buffer."""
    out = []
    for r in words:
        buf = torch.zeros(r.shape[0] + offset, dtype=torch.int32, device=device)
        buf[offset:] = torch.from_numpy(np.ascontiguousarray(r).view(np.int32))
        out.append(buf[offset:])
    return out


def _u32(rows) -> np.ndarray:
    return np.stack([r.cpu().numpy().view(np.uint32) for r in rows])


def test_fmix32_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGES, rng.integers(0, 2**32, 5000, dtype=np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jhashes.fmix32(jnp.asarray(x)))
    got = hashes.fmix32(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(hashes.fmix32_np(x), want)
    # A bijection: no two of the inputs collide.
    assert np.unique(want).size == np.unique(x).size


@pytest.mark.parametrize("w_count", [1, 2, 3, 4, 5, 6])
def test_mix_keys_matches_jax(w_count):
    """mix_keys (the plain version on a CPU tensor) against the JAX device
    function and both numpy mixes, on full-range words, top-bit words, the
    sentinel and keys next to it; the sentinel is a fixed point and the
    numpy unmix inverts the mix."""
    rng = np.random.default_rng(w_count)
    keys = rng.integers(0, 2**32, (3000, w_count), dtype=np.uint64).astype(np.uint32)
    keys[:100] |= np.uint32(0x80000000)
    keys[100:110] = 0xFFFFFFFF
    keys[110:120, 0] = 0xFFFFFFFF
    keys[120:130] = EDGES[:, None]
    got = _u32(mixkey.mix_keys(_rows(keys.T))).T
    want = np.stack([np.asarray(x) for x in jmixkey.mix_keys(
        [jnp.asarray(keys[:, i]) for i in range(w_count)])], axis=-1)
    assert np.array_equal(got, want)
    assert np.array_equal(mixkey.mix_keys_np(keys), want)
    assert np.array_equal(jmixkey.mix_keys_np(keys), want)
    assert np.array_equal(mixkey.unmix_keys_np(want), keys)
    assert np.array_equal(jmixkey.unmix_keys_np(want), keys)
    assert (got[100:110] == 0xFFFFFFFF).all()
    # Only the sentinel mixes to the sentinel.
    sentinel = (keys == 0xFFFFFFFF).all(axis=1)
    assert np.array_equal((got == 0xFFFFFFFF).all(axis=1), sentinel)
    assert mixkey._sentinel_fix(w_count) == jmixkey._sentinel_fix(w_count)


MIX_CASES = testing.mix_cases()


@pytest.mark.parametrize("case", MIX_CASES, ids=[c[0] for c in MIX_CASES])
def test_mix_hard_cases_match_jax(case):
    """The kernel's hard cases (every width, sentinel rows, top-bit words,
    near-sentinel keys, ragged sizes, odd offsets) through the port's
    wrapper on the CPU, against the JAX package's numpy mix."""
    name, kind, w_count, n, offset = case
    words = testing.mix_case_words(kind, w_count, n, 7)
    got = _u32(mixkey.mix_keys(_rows(words, offset=offset)))
    want = jmixkey.mix_keys_np(words.T.copy()).T
    assert np.array_equal(got, want)
    sentinel = (words == 0xFFFFFFFF).all(axis=0)
    assert (got[:, sentinel] == 0xFFFFFFFF).all()
    assert not (got[:, ~sentinel] == 0xFFFFFFFF).all(axis=0).any()


def test_mix_keys_rejects_bad_input():
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        mixkey.mix_keys([w] * 7)
    with pytest.raises(ValueError):
        mixkey.mix_keys([w, w[:4]])
    with pytest.raises(ValueError):
        mixkey.mix_keys([w.to(torch.int64)])


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 7, 8, 1000, 65536])
def test_range_destinations_and_boundaries_match_jax(num_shards):
    rng = np.random.default_rng(num_shards)
    v = np.concatenate([EDGES, rng.integers(0, 2**32, 4000, dtype=np.uint64)
                        .astype(np.uint32)])
    bnd = mixkey.range_boundaries(num_shards)
    assert np.array_equal(bnd, jmixkey.range_boundaries(num_shards))
    want = np.asarray(jmixkey.range_destinations(jnp.asarray(v), num_shards))
    got = mixkey.range_destinations(torch.from_numpy(v.view(np.int32)), num_shards)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    # The destinations are the boundaries' ranges.
    assert np.array_equal(
        want, np.searchsorted(bnd, v.astype(np.uint64), side="right") - 1)


def test_split_capacity_matches_jax():
    for cap in [1, 2, 3, 64, 127, 128, 129, 1000, 2**20 + 2**14, 2**31 - 1]:
        assert spill.split_capacity(cap) == jspill.split_capacity(cap)
        m, sc = spill.split_capacity(cap)
        # The retry's doubling keeps m the largest power of two.
        assert spill.split_capacity(2 * cap) == (2 * m, 2 * sc)


@pytest.mark.parametrize("seed", range(6))
def test_dispatch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    num_shards = int(rng.integers(1, 9))
    num_buckets = num_shards * int(rng.integers(1, 5))
    sizes = rng.zipf(1.5, num_buckets).astype(np.int64)
    if seed % 2:
        sizes[rng.integers(0, num_buckets)] *= 50
    for ratio in (1.0, 2.3, 5.0):
        assert np.array_equal(dispatch.classify(sizes, ratio),
                              jdispatch.classify(sizes, ratio))
    assign = dispatch.balanced_assignment(sizes, num_shards)
    assert np.array_equal(assign, jdispatch.balanced_assignment(sizes, num_shards))
    rr = dispatch.round_robin_assignment(num_buckets, num_shards)
    assert np.array_equal(rr, jdispatch.round_robin_assignment(num_buckets, num_shards))
    for a in (assign, rr):
        assert dispatch.imbalance(sizes, a, num_shards) == \
            jdispatch.imbalance(sizes, a, num_shards)
    assert dispatch.classify(np.zeros(0)).size == 0
    assert (dispatch.NORMAL, dispatch.HEAVY) == (jdispatch.NORMAL, jdispatch.HEAVY)


def test_range_capacity_matches_jax_at_many_shapes():
    """The mean + max(mean/64, 64) rule at every n_local, pow2 or not
    (tests/test_sharded.py's shapes and more), and EXT's pow2 rule."""
    shapes = [1, 100, 128 * 3, 100_000, 1 << 21, (1 << 21) + 4096,
              int((1 << 21) * 1.5), (1 << 22) - 512, (1 << 26) + 1]
    for ext in (False, True):
        cfg = KmerConfig(k=31, m=17, lower=2, upper=50, extension=ext)
        jcfg = JKmerConfig(k=31, m=17, lower=2, upper=50, extension=ext)
        for n_local in shapes:
            for s in (1, 2, 3, 4, 8):
                got = sharded.range_capacity(n_local, s, cfg)
                assert got == jsharded.range_capacity(n_local, s, jcfg)
                if not ext:
                    mean = max(-(-n_local // s), 128)
                    assert mean + 64 <= got <= mean + max(mean // 64, 64)
    for x in (0, 1, 2, 3, 1000, 1 << 20):
        assert sharded._next_pow2(x) == jsharded._next_pow2(x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MIX_CASES, ids=[c[0] for c in MIX_CASES])
def test_mix_kernel_hard_cases_on_cuda(cuda, case):
    from hysortk_tpu_torch import _build

    name, kind, w_count, n, offset = case
    words = testing.mix_case_words(kind, w_count, n, 7)
    rows = _rows(words, cuda, offset)
    before = _build.launches["mix_keys"]
    got = mixkey.mix_keys(rows)
    assert _build.launches["mix_keys"] == before + 1
    want = mixkey.mix_keys_plain(rows)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert np.array_equal(_u32(got), mixkey.mix_keys_np(words.T.copy()).T)
