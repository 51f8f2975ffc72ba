"""The port's key build fused into the sort (hysortk_tpu_torch.ops.fused_sort,
HYSORTK_FUSED_SORT) against the JAX package's pallas_sort.sort_codes_fused in
interpret mode. A keys-only sort is fully determined, so the sorted words
compare exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import kmer as jkmer
from hysortk_tpu.ops import pallas_sort
from hysortk_tpu.ops import sort as jsort
from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import fused_sort, keybuild, radix_sort


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


def _codes_valid(rng, n, k):
    """Random codes; validity with invalid runs, a few lone invalid slots
    and the last k - 1 slots invalid (no k-mer starts there)."""
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    valid = rng.random(n) < 0.9
    for start in rng.integers(0, n, 5):
        valid[start:start + 40] = False
    valid[-(k - 1):] = False
    return codes, valid


# The sizes of the JAX package's own test of its fused sort: one block, a
# ragged count of blocks, two whole blocks (interpret mode: 2048 slots each).
@pytest.mark.parametrize("k,n", [(15, 2048), (31, 5000), (55, 4096)])
def test_sort_codes_fused_matches_jax(k, n):
    rng = np.random.default_rng(83 + k)
    codes, valid = _codes_valid(rng, n, k)
    got = fused_sort.sort_codes_fused(
        torch.from_numpy(codes), torch.from_numpy(valid), k
    )
    want = pallas_sort.sort_codes_fused(jnp.asarray(codes), jnp.asarray(valid), k)
    assert len(got) == len(want) == config.words_per_kmer(k)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    n_invalid = int((~valid).sum())
    assert all((g[n - n_invalid:] == -1).all() for g in got)


@pytest.mark.parametrize("k", [15, 16, 31, 32, 55, 96])
def test_sort_codes_fused_is_keybuild_then_sort(k):
    """Equal to the unfused pair of the port, and to a numpy lexsort of the
    key words, at k = 16W (no shift of the reverse complement) too."""
    rng = np.random.default_rng(k)
    n = 3000
    codes, valid = _codes_valid(rng, n, k)
    tc, tv = torch.from_numpy(codes), torch.from_numpy(valid)
    got = fused_sort.sort_codes_fused(tc, tv, k)
    marked = keybuild.canonical_keys_fused(tc, tv, k)
    want, _ = radix_sort.sort_words(marked)
    words = np.stack([m.numpy().view(np.uint32) for m in marked])
    expect = words[:, np.lexsort(tuple(words[::-1]))]
    for g, w, e in zip(got, want, expect):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy().view(np.uint32), e)


@pytest.mark.parametrize("k", [15, 31, 55])
def test_count_reads_with_fused_sort_set_equals_unset(k, monkeypatch):
    """HYSORTK_FUSED_SORT routes count_reads, count_flat and the streaming
    per-batch pass through sort_codes_fused; the results do not change."""
    from hysortk_tpu_torch.runtime import scheduler

    rng = np.random.default_rng(5)
    reads = testing.random_reads(rng, 30, 5, 120, "ACGTNacgt")
    reads += reads[:10]
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = config.KmerConfig(k=k, m=min(17, k - 1), lower=2, upper=50,
                            pad_multiple=256)
    flat, valid = fasta_io.flatten_for_device(codes, lengths, k, 256)

    def run_all():
        return [
            pipeline.count_reads(codes, lengths, cfg, device="cpu"),
            pipeline.count_flat(flat, valid, cfg, device="cpu"),
            scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu"),
        ]

    calls = []
    real = fused_sort.sort_codes_fused
    monkeypatch.setattr(fused_sort, "sort_codes_fused",
                        lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.delenv("HYSORTK_FUSED_SORT", raising=False)
    unset = run_all()
    assert not calls
    monkeypatch.setenv("HYSORTK_FUSED_SORT", "1")
    fused = run_all()
    assert len(calls) > 3 and set(calls) == {k}
    for (a, ha), (b, hb) in zip(unset, fused):
        assert np.array_equal(a.keys, b.keys) and len(a) > 0
        assert np.array_equal(a.counts, b.counts)
        assert np.array_equal(ha, hb)
    want = testing.oracle_filtered(reads, k, 2, 50)
    assert {km.decode(): c for km, c in fused[0][0].as_dict().items()} == want
    monkeypatch.setenv("HYSORTK_FUSED_SORT", "")  # empty counts as unset
    calls.clear()
    pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert not calls


def test_sort_codes_fused_rejects_bad_input():
    codes = torch.zeros(64, dtype=torch.int8)
    valid = torch.ones(64, dtype=torch.bool)
    with pytest.raises(TypeError):
        fused_sort.sort_codes_fused(codes.to(torch.int32), valid, 31)
    with pytest.raises(TypeError):
        fused_sort.sort_codes_fused(codes, valid.to(torch.int8), 31)
    with pytest.raises(ValueError):
        fused_sort.sort_codes_fused(codes, valid[:10], 31)
    with pytest.raises(ValueError):
        fused_sort.sort_codes_fused(codes, valid, 97)
    empty = fused_sort.sort_codes_fused(codes[:0], valid[:0], 31)
    assert len(empty) == 2 and all(e.shape == (0,) for e in empty)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 16, 31, 32, 55, 64, 96])
def test_fused_sort_kernel_matches_plain_on_cuda(cuda, k):
    from hysortk_tpu_torch import _build

    rng = np.random.default_rng(40 + k)
    n = 100_003  # several radix tiles, a ragged last one, halos across tiles
    codes, valid = _codes_valid(rng, n, k)
    valid[8192 - 20:8192 + 5] = True  # k-mers that straddle a tile boundary
    tc, tv = torch.from_numpy(codes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = dict(_build.launches)
    got = fused_sort.sort_codes_fused(tc, tv, k)
    assert _build.launches["fused_sort"] == before["fused_sort"] + 1
    assert _build.launches["keybuild"] == before["keybuild"]
    assert _build.launches["radix_sort"] == before["radix_sort"]
    want = fused_sort.sort_codes_fused_plain(tc, tv, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_count_reads_fused_on_cuda_matches_cpu(cuda, monkeypatch):
    from hysortk_tpu_torch import _build

    rng = np.random.default_rng(6)
    reads = testing.random_reads(rng, 200, 5, 160, "ACGTN")
    reads += reads[:50]
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg = config.KmerConfig(k=31, lower=2, upper=50)
    want, whist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    monkeypatch.setenv("HYSORTK_FUSED_SORT", "1")
    before = _build.launches["fused_sort"]
    got, hist = pipeline.count_reads(codes, lengths, cfg, device="cuda")
    assert _build.launches["fused_sort"] == before + 1
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts) and np.array_equal(hist, whist)


# The fused sort's hard cases of hysortk_tpu_torch.testing: on the CPU at a
# small tile against the JAX fused sort in interpret mode, on the card
# kernel against plain at the kernel's own tiles.
CPU_TILES = {w: 64 for w in range(1, 7)}
CPU_CASES = testing.fused_sort_cases(CPU_TILES)
CARD_CASES = testing.fused_sort_cases()


@pytest.mark.parametrize("name,kind,n,k", CPU_CASES, ids=[c[0] for c in CPU_CASES])
def test_sort_codes_fused_hard_cases_match_jax(name, kind, n, k):
    """Sorted key words bit-equal (tolerance 0) to the JAX package's: to
    pallas_sort.sort_codes_fused in interpret mode up to two key words, and
    beyond (where interpret mode takes half a minute a case) to its XLA key
    derivation (ops/kmer.canonical_words) sorted by ops/sort.sort_keys; and to a numpy lexsort of the
    port's unfused key build."""
    codes, valid = testing.fused_sort_case_codes(kind, n, k, seed=21)
    tc, tv = torch.from_numpy(codes), torch.from_numpy(valid)
    got = fused_sort.sort_codes_fused(tc, tv, k)
    if k <= 32:
        want = pallas_sort.sort_codes_fused(jnp.asarray(codes), jnp.asarray(valid), k)
    else:
        jwords = jkmer.canonical_words(jnp.asarray(codes), k)
        want = jsort.sort_keys(jnp.asarray(~valid), jwords, backend="xla")[1]
    marked = np.stack([m.numpy().view(np.uint32)
                       for m in keybuild.canonical_keys_fused(tc, tv, k)])
    expect = marked[:, testing.stable_order(marked)]
    assert len(got) == len(want) == config.words_per_kmer(k)
    for g, w, e in zip(got, want, expect):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
        assert np.array_equal(g.numpy().view(np.uint32), e)
    if kind == "poly_a" and valid.any():
        first = int(valid.sum())
        assert all((g[:first] == g[0]).all() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,n,k", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_fused_sort_kernel_hard_cases_on_cuda(cuda, name, kind, n, k):
    codes, valid = testing.fused_sort_case_codes(kind, n, k, seed=22)
    tc, tv = torch.from_numpy(codes).to(cuda), torch.from_numpy(valid).to(cuda)
    got = fused_sort.sort_codes_fused(tc, tv, k)
    want = fused_sort.sort_codes_fused_plain(tc, tv, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
