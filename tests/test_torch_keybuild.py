"""The port's key build (hysortk_tpu_torch.ops.keybuild / ops.kmer) against
the JAX package: the Pallas kernel in interpret mode and the XLA
formulation. Integer work, so every comparison is exact. The hard cases of
hysortk_tpu_torch.testing.keybuild_cases run here at a tile of 256 slots (the
JAX kernel's block in interpret mode) and on the card at the kernel's tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.ops import keybuild as jkeybuild
from hysortk_tpu.ops import kmer as jkmer
from hysortk_tpu.ops import pallas_sort
from hysortk_tpu.ops import sort as jsort
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import keybuild, kmer

KS = [15, 16, 17, 31, 32, 55, 96]  # W = 1, 1, 2, 2, 2, 4, 6; shift == 0 at 16, 32, 96


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


def _inputs(k, seed):
    """Flat codes + k-mer-start mask of random reads with Ns, some shorter
    than k, padded as the pipeline pads."""
    rng = np.random.default_rng(seed)
    reads = oracle.random_reads(rng, 12, max(1, k - 8), 3 * k, "ACGTN")
    codes, lengths = jfasta.reads_to_codes(reads)
    return jfasta.flatten_for_device(codes, lengths, k, 256)


def _as_u32(words):
    return [np.asarray(w.numpy()).view(np.uint32) for w in words]


@pytest.mark.parametrize("k", KS)
def test_keybuild_matches_jax_kernel(k):
    flat, valid = _inputs(k, k)
    got = keybuild.canonical_keys_fused(
        torch.from_numpy(flat), torch.from_numpy(valid), k
    )
    want = jkeybuild.canonical_keys_fused(
        jnp.asarray(flat, jnp.int8), jnp.asarray(valid), k, block_rows=2
    )
    assert len(got) == len(want) == (k + 15) // 16
    for w, (g, x) in enumerate(zip(_as_u32(got), want)):
        assert np.array_equal(g, np.asarray(x)), f"word {w}"


@pytest.mark.parametrize("k", KS)
def test_keybuild_matches_jax_xla(k):
    flat, valid = _inputs(k, 100 + k)
    got = keybuild.canonical_keys_plain(
        torch.from_numpy(flat), torch.from_numpy(valid), k
    )
    want = jsort.apply_sentinel(
        ~jnp.asarray(valid),
        jkmer.canonical_words(jnp.asarray(flat, jnp.int32), k),
    )
    for g, x in zip(_as_u32(got), want):
        assert np.array_equal(g, np.asarray(x))
    # Invalid slots hold the sentinel.
    assert np.all(g[~valid] == 0xFFFFFFFF)


CPU_TILE = 256  # block_rows=2 of the JAX kernel
HARD_CASES = testing.keybuild_cases(CPU_TILE)


def _case_tensors(case, tile, device="cpu"):
    """The case's codes and flags as views `offset` elements into their
    buffers on `device`."""
    name, kind, n, k, offset = case
    codes, valid = testing.keybuild_case_codes(kind, n, k, 17, tile)
    out = []
    for a in (codes, valid):
        buf = torch.zeros(n + offset, dtype=torch.from_numpy(a).dtype, device=device)
        buf[offset:] = torch.from_numpy(a).to(device)
        out.append(buf[offset:])
    return out


@pytest.mark.parametrize("case", HARD_CASES, ids=[c[0] for c in HARD_CASES])
def test_keybuild_hard_cases_match_jax_kernel(case):
    """Every key width, sizes that are not whole tiles or groups, inputs
    shorter than the halo, invalid slots either side of a tile edge, views at
    odd offsets: wrapper == JAX kernel, exactly."""
    name, kind, n, k, offset = case
    codes, valid = _case_tensors(case, CPU_TILE)
    got = keybuild.canonical_keys_fused(codes, valid, k)
    want = jkeybuild.canonical_keys_fused(
        jnp.asarray(codes.numpy()), jnp.asarray(valid.numpy()), k, block_rows=2
    )
    assert len(got) == len(want) == (k + 15) // 16
    for w, (g, x) in enumerate(zip(_as_u32(got), want)):
        assert np.array_equal(g, np.asarray(x)), f"word {w}"
    assert np.all(_as_u32(got)[0][~valid.numpy()] == 0xFFFFFFFF)


@pytest.mark.parametrize("k", [16, 31, 55])
def test_kmer_steps_match_jax(k):
    """Each step of the plain formulation, on words with the top bit set."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 700).astype(np.int8)
    p16 = kmer.sliding_pack16(torch.from_numpy(codes))
    jp16 = jkmer.sliding_pack16(jnp.asarray(codes, jnp.int32))
    assert np.array_equal(p16.numpy().view(np.uint32), np.asarray(jp16))
    assert (np.asarray(jp16) >= 0x80000000).any()

    fwd = kmer.forward_words(p16, k)
    jfwd = jkmer.forward_words(jp16, k)
    twn = kmer.twin_words(fwd, k)
    jtwn = jkmer.twin_words(jfwd, k)
    for a, b in zip(fwd + twn, jfwd + jtwn):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))
    less = kmer.lex_less(twn, fwd)
    assert np.array_equal(less.numpy(), np.asarray(jkmer.lex_less(jtwn, jfwd)))

    x = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    got = kmer.crumb_reverse32(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(
        got.numpy().view(np.uint32), np.asarray(jkmer.crumb_reverse32(jnp.asarray(x)))
    )


def test_widen_narrow_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    t = torch.from_numpy(x.view(np.int32))
    wide = kmer.widen(t)
    assert wide.tolist() == x.astype(np.int64).tolist()
    assert torch.equal(kmer.narrow(wide), t)
    assert torch.equal(kmer.narrow(wide + (5 << 32)), t)  # taken mod 2^32


def test_decode_encode_match_jax():
    rng = np.random.default_rng(5)
    k = 37
    kmers = ["".join(rng.choice(list("ACGT"), k)) for _ in range(50)]
    keys = np.stack([kmer.encode_kmer(s) for s in kmers])
    jkeys = np.stack([jkmer.encode_kmer(s) for s in kmers])
    assert np.array_equal(keys, jkeys)
    assert kmer.decode_keys(keys, k).tolist() == [s.encode() for s in kmers]


def test_keybuild_rejects_bad_input():
    codes = torch.zeros(64, dtype=torch.int8)
    valid = torch.ones(64, dtype=torch.bool)
    with pytest.raises(TypeError):
        keybuild.canonical_keys_fused(codes.to(torch.int32), valid, 31)
    with pytest.raises(ValueError):
        keybuild.canonical_keys_fused(codes, valid[:10], 31)
    with pytest.raises(ValueError):
        keybuild.canonical_keys_fused(codes, valid, 97)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_keybuild_kernel_matches_plain_on_cuda(cuda, k):
    from hysortk_tpu_torch import _build

    flat, valid = _inputs(k, 200 + k)
    codes_d = torch.from_numpy(flat).to(cuda)
    valid_d = torch.from_numpy(valid).to(cuda)
    before = _build.launches["keybuild"]
    got = keybuild.canonical_keys_fused(codes_d, valid_d, k)
    assert _build.launches["keybuild"] == before + 1
    want = keybuild.canonical_keys_plain(codes_d, valid_d, k)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.keybuild_cases(),
                         ids=[c[0] for c in testing.keybuild_cases()])
def test_keybuild_kernel_hard_cases_on_cuda(cuda, case):
    """The hard cases at the kernel's own tile, odd offsets included."""
    codes, valid = _case_tensors(case, testing.KEYBUILD_TILE, cuda)
    k = case[3]
    got = keybuild.canonical_keys_fused(codes, valid, k)
    want = keybuild.canonical_keys_plain(codes, valid, k)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
