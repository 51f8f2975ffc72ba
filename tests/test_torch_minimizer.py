"""The bucketed routings' pure functions against their JAX twins on the CPU:
ops/hashes.mix_words (and its numpy twin, and the host hashes),
ops/minimizer (m-mer hashes, window minimum, destinations, compared at the
slots where a valid k-mer starts), ops/count.chunked_bincount / histogram,
parallel/dispatch.bucket_sizes_device, parallel/exchange.pack_by_destination
(counts, overflow flag, each destination's multiset of rows) and
ops/kmer.extend_kmer. Seeded inputs, K = 15, 31 and 95, top-bit words; the
tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.ops import count as jcount
from hysortk_tpu.ops import hashes as jhashes
from hysortk_tpu.ops import kmer as jkmer
from hysortk_tpu.ops import minimizer as jminimizer
from hysortk_tpu.parallel import dispatch as jdispatch
from hysortk_tpu.parallel import exchange as jexchange
from hysortk_tpu_torch.ops import count as count_ops
from hysortk_tpu_torch.ops import hashes
from hysortk_tpu_torch.ops import kmer as kmer_ops
from hysortk_tpu_torch.ops import minimizer
from hysortk_tpu_torch.parallel import dispatch
from hysortk_tpu_torch.parallel import exchange

KM = [(15, 7), (31, 17), (95, 17), (31, 2)]


def _words(rng, n_words: int, n: int, top_bit: bool) -> list[np.ndarray]:
    words = rng.integers(0, 2**32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    if top_bit:
        words[:, ::3] |= np.uint32(0x80000000)
        words[:, 1::5] = np.uint32(0xFFFFFFFF)
    return list(words)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 torch words with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_words", [1, 2, 6])
@pytest.mark.parametrize("top_bit", [False, True])
def test_mix_words_matches_jax(n_words, top_bit):
    rng = np.random.default_rng(n_words + 10 * top_bit)
    words = _words(rng, n_words, 5000, top_bit)
    want = np.asarray(jhashes.mix_words([jnp.asarray(w) for w in words]))
    assert np.array_equal(_u(hashes.mix_words([_t(w) for w in words])), want)
    assert np.array_equal(hashes.mix_words_np(words), want)
    assert np.array_equal(
        _u(hashes.mix_words([_t(w) for w in words], seed=7)),
        np.asarray(jhashes.mix_words([jnp.asarray(w) for w in words], seed=7)))


def _codes(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[100:400] = 0  # a poly-A stretch: many equal m-mers
    return codes


@pytest.mark.parametrize("k,m", KM)
def test_minimizer_trio_matches_jax(k, m):
    """At every slot where a k-mer fits (the JAX rolls wrap garbage into the
    last k - m slots, as the port's do)."""
    n = 6000
    codes = _codes(k + m, n)
    fits = slice(0, n - k + 1)
    mh = minimizer.mmer_hashes(torch.from_numpy(codes), m)
    want_mh = np.asarray(jminimizer.mmer_hashes(jnp.asarray(codes, jnp.int32), m))
    assert np.array_equal(_u(mh)[: n - m + 1], want_mh[: n - m + 1])
    window = k - m + 1
    got_min = _u(minimizer.sliding_window_min(mh, window))
    want_min = np.asarray(jminimizer.sliding_window_min(jnp.asarray(want_mh), window))
    assert np.array_equal(got_min[fits], want_min[fits])
    for buckets in (6, 24, 7):
        got = minimizer.kmer_destinations(torch.from_numpy(codes), k, m, buckets)
        want = np.asarray(jminimizer.kmer_destinations(
            jnp.asarray(codes, jnp.int32), k, m, buckets))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy()[fits], want[fits])


@pytest.mark.parametrize("top_bit", [False, True])
def test_sliding_window_min_is_unsigned(top_bit):
    rng = np.random.default_rng(3)
    x = _words(rng, 1, 3000, top_bit)[0]
    for window in (1, 2, 3, 15, 80):
        got = _u(minimizer.sliding_window_min(_t(x), window))
        want = np.asarray(jminimizer.sliding_window_min(jnp.asarray(x), window))
        assert np.array_equal(got[: x.size - window + 1], want[: x.size - window + 1])


def test_minimizer_destinations_match_the_window_oracle():
    reads = oracle.random_reads(np.random.default_rng(5), 6, 40, 90)
    k, m, buckets = 31, 17, 12
    for read in reads:
        codes, _ = jfasta.reads_to_codes([read])
        got = minimizer.kmer_destinations(torch.from_numpy(codes.astype(np.int8)),
                                          k, m, buckets).numpy()
        mh = lambda s: int(hashes.mix_words_np(
            [np.array([w], np.uint32) for w in kmer_ops.encode_kmer(s)])[0])
        want = oracle.oracle_minimizer_dests(read, k, m, buckets, mh)
        assert got[: len(want)].tolist() == want


@given(n=st.integers(1, 400), k=st.integers(3, 40), m_off=st.integers(1, 30),
       buckets=st.integers(1, 50), seed=st.integers(0, 2**31))
@settings(max_examples=25, deadline=None)
def test_kmer_destinations_hypothesis(n, k, m_off, buckets, seed):
    m = max(1, k - m_off)
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)
    got = minimizer.kmer_destinations(torch.from_numpy(codes), k, m, buckets).numpy()
    want = np.asarray(jminimizer.kmer_destinations(
        jnp.asarray(codes, jnp.int32), k, m, buckets))
    fits = max(n - k + 1, 0)
    assert np.array_equal(got[:fits], want[:fits])
    assert ((got >= 0) & (got < buckets)).all()


@pytest.mark.parametrize("bins", [1, 7, 51, 65536])
def test_chunked_bincount_and_histogram_match_jax(bins):
    rng = np.random.default_rng(bins)
    values = rng.integers(-3, bins + 5, 20000).astype(np.int32)
    valid = rng.random(20000) < 0.7
    got = count_ops.chunked_bincount(torch.from_numpy(values), torch.from_numpy(valid), bins)
    want = np.asarray(jcount.chunked_bincount(jnp.asarray(values), jnp.asarray(valid), bins))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(
        dispatch.bucket_sizes_device(torch.from_numpy(values), torch.from_numpy(valid),
                                     bins).numpy(),
        np.asarray(jdispatch.bucket_sizes_device(jnp.asarray(values),
                                                 jnp.asarray(valid), bins)))
    upper = bins - 1
    counts = np.clip(values, 0, upper)
    got = count_ops.histogram(torch.from_numpy(valid), torch.from_numpy(counts), upper)
    want = np.asarray(jcount.histogram(jnp.asarray(valid), jnp.asarray(counts), upper))
    assert np.array_equal(got.numpy(), want)


def _segments(send_rows, counts, capacity):
    """Per destination, the sorted multiset of its (row, ...) tuples."""
    out = []
    for s, c in enumerate(counts):
        take = min(int(c), capacity)
        rows = np.stack([r[s, :take] for r in send_rows], axis=1)
        out.append(sorted(map(tuple, rows.tolist())))
    return out


@pytest.mark.parametrize("n_words,n_payloads", [(1, 0), (2, 1), (6, 2)])
@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("capacity_scale", [2.0, 0.5])
def test_pack_by_destination_matches_jax(n_words, n_payloads, shards, capacity_scale):
    """The counts and the overflow flag always; each destination's rows as
    a multiset where no destination overflows (the JAX version orders a
    segment by key, the port by slot, and an overflowing segment keeps a
    different prefix)."""
    rng = np.random.default_rng(n_words * 100 + shards)
    n = 3000
    words = _words(rng, n_words, n, True)
    payloads = _words(rng, n_payloads, n, False)
    valid = rng.random(n) < 0.8
    dest = rng.integers(0, shards, n).astype(np.uint32)
    capacity = max(int(n / shards * capacity_scale), 1)
    send, counts, overflow = exchange.pack_by_destination(
        torch.from_numpy(valid), _t(dest), [_t(w) for w in words],
        [_t(p) for p in payloads], shards, capacity)
    jw, jp, jc, jo = jexchange.pack_by_destination(
        jnp.asarray((~valid).astype(np.uint32)), jnp.asarray(dest),
        [jnp.asarray(w) for w in words], [jnp.asarray(p) for p in payloads],
        shards, capacity)
    assert send.shape == (shards, n_words + n_payloads, capacity)
    assert np.array_equal(counts, np.asarray(jc)) and overflow == bool(jo)
    assert overflow == (capacity_scale < 1)
    rows = [_u(send[:, r].contiguous()) for r in range(send.shape[1])]
    slot = np.arange(capacity)[None, :]
    # Slots past a destination's count hold the sentinel.
    for r in rows:
        assert (r[slot >= counts[:, None]] == 0xFFFFFFFF).all()
    if not overflow:
        want_rows = [np.asarray(a) for a in (*jw, *jp)]
        assert _segments(rows, counts, capacity) == _segments(want_rows, counts, capacity)


def test_pack_by_destination_of_nothing():
    send, counts, overflow = exchange.pack_by_destination(
        torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.int32),
        [torch.zeros(0, dtype=torch.int32)], [], 3, 8)
    assert send.shape == (3, 1, 8) and (send == -1).all()
    assert counts.tolist() == [0, 0, 0] and not overflow


def test_host_hashes_match_jax():
    rng = np.random.default_rng(9)
    for n in list(range(0, 40)) + [100, 257]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert hashes.murmurhash3_64(data) == jhashes.murmurhash3_64(data)
        assert hashes.murmurhash3_64(data, 5) == jhashes.murmurhash3_64(data, 5)
        assert hashes.superfasthash(data) == jhashes.superfasthash(data)
    for key in [0, 1, 2**63, 2**64 - 1] + rng.integers(0, 2**63, 50).tolist():
        h = hashes.wanghash64(int(key))
        assert h == jhashes.wanghash64(int(key))
        assert hashes.wanghash64_inv(h) == int(key) == jhashes.wanghash64_inv(h)


@pytest.mark.parametrize("k", [15, 16, 17, 31, 32, 95, 96])
def test_extend_kmer_matches_jax(k):
    rng = np.random.default_rng(k)
    s = "".join(rng.choice(list("ACGT"), k + 20))
    key = kmer_ops.encode_kmer(s[:k])
    keys = np.stack([key, kmer_ops.encode_kmer(s[1: k + 1])])
    for i, ch in enumerate(s[k:]):
        code = "ACGT".index(ch)
        nxt = kmer_ops.extend_kmer(key, code, k)
        assert np.array_equal(nxt, jkmer.extend_kmer(key, code, k))
        assert np.array_equal(nxt, kmer_ops.encode_kmer(s[i + 1: i + 1 + k]))
        key = nxt
    assert np.array_equal(kmer_ops.extend_kmer(keys, 2, k), jkmer.extend_kmer(keys, 2, k))
    with pytest.raises(ValueError):
        kmer_ops.extend_kmer(key[:-1] if key.size > 1 else np.zeros(2, np.uint32), 0, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", KM)
def test_minimizer_on_cuda_matches_cpu(k, m):
    """On a card the destinations come from the scan kernel: they equal
    the CPU's at every slot where a k-mer fits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = torch.from_numpy(_codes(k, 1 << 16))
    got = minimizer.kmer_destinations(codes.cuda(), k, m, 24).cpu()
    want = minimizer.kmer_destinations(codes, k, m, 24)
    fits = codes.shape[0] - k + 1
    assert torch.equal(got[:fits], want[:fits])


@pytest.mark.cuda
def test_pack_by_destination_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    n = 1 << 16
    words = [_t(w) for w in _words(rng, 3, n, True)]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    dest = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    want = exchange.pack_by_destination(valid, dest, words, [], 4, n // 3)
    got = exchange.pack_by_destination(valid.cuda(), dest.cuda(),
                                       [w.cuda() for w in words], [], 4, n // 3)
    assert torch.equal(got[0].cpu(), want[0])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
