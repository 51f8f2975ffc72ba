"""The minimizer scan (ops/minimizer.kmer_destinations) on every case of
hysortk_tpu_torch.testing.scan_cases: the plain version against the JAX
package on the CPU, and the kernel (csrc/minimizer_scan.cu) against the
plain version on a card (`cuda` marker). The sized scan
(kmer_destinations_sized: the buckets and the valid k-mers of each) on
every scan case under a seeded, an all-false and an all-true mask, and on
testing.sized_scan_cases (the redesigned kernel's block seams, bin counts
around its shared-memory cap, masks from reads with zero-length reads,
top-bit minima): the plain version against the JAX package's
kmer_destinations and dispatch.bucket_sizes_device (np.bincount of the JAX
buckets where the chunked one-hot of the latter would pass 2^25 entries),
the kernel against the plain version on a card. Buckets are exact at every
position where a k-mer fits (i <= n - k: the JAX version's rolls wrap
past it, and so do the plain version's and the kernel's, which agree
everywhere), every bucket in [0, num_buckets), the sizes exact. Seeded
numpy inputs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import minimizer as jminimizer
from hysortk_tpu.parallel import dispatch as jdispatch
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.ops import minimizer

CASES = testing.scan_cases()
IDS = [case[0] for case in CASES]


def _codes(case) -> np.ndarray:
    _, kind, n, _, m, _, seed = case
    return testing.scan_case_codes(kind, n, m, seed)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_scan_matches_jax(case):
    _, kind, n, k, m, buckets, _ = case
    codes = _codes(case)
    got = minimizer.kmer_destinations(torch.from_numpy(codes), k, m, buckets)
    want = np.asarray(jminimizer.kmer_destinations(jnp.asarray(codes, jnp.int32), k, m,
                                                   buckets))
    fits = max(n - k + 1, 0)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy()[:fits], want[:fits])
    assert ((got >= 0) & (got < buckets)).all()
    if kind == "top_bit" and fits:
        # The hazard the kind exists for: every window's least hash has the
        # top bit set, so a signed minimum would pick another one.
        least = minimizer.sliding_window_min(
            minimizer.mmer_hashes(torch.from_numpy(codes), m), k - m + 1)
        assert (least.numpy().view(np.uint32)[:fits] >= 2**31).all()


def test_scan_rejects_what_the_kernel_does_not_take():
    codes = torch.zeros(100, dtype=torch.int8)
    with pytest.raises(TypeError):
        minimizer.kmer_destinations(codes.to(torch.int32), 31, 17, 4)
    for k, m, buckets in ((31, 31, 4), (97, 17, 4), (31, 0, 4), (31, 17, 0),
                          (31, 17, 2**31)):
        with pytest.raises(ValueError):
            minimizer.kmer_destinations(codes, k, m, buckets)
    with pytest.raises(ValueError):
        minimizer.kmer_destinations(codes.to("meta"), 31, 17, 4)


# The sized scan: every scan case under each of testing.SCAN_MASKS, then the
# sized scan's own hard cases; (name, kind, n, k, m, buckets, seed, mask).
SIZED = ([(f"{c[0]}-{mask}", *c[1:], mask) for c in CASES for mask in testing.SCAN_MASKS]
         + testing.sized_scan_cases())
SIZED_IDS = [case[0] for case in SIZED]


@functools.lru_cache(maxsize=None)
def _jax_buckets(kind, n, k, m, buckets, seed) -> np.ndarray:
    codes = testing.scan_case_codes(kind, n, m, seed)
    return np.asarray(jminimizer.kmer_destinations(jnp.asarray(codes, jnp.int32), k, m,
                                                   buckets))


def _sized_inputs(case):
    _, kind, n, k, m, buckets, seed, mask = case
    return (torch.from_numpy(testing.scan_case_codes(kind, n, m, seed)),
            torch.from_numpy(testing.scan_mask(mask, n, k, seed)))


@pytest.mark.parametrize("case", SIZED, ids=SIZED_IDS)
def test_plain_sized_scan_matches_jax(case):
    _, kind, n, k, m, buckets, seed, _ = case
    codes, valid = _sized_inputs(case)
    dest, sizes = minimizer.kmer_destinations_sized(codes, valid, k, m, buckets)
    jdest = _jax_buckets(kind, n, k, m, buckets, seed)
    fits = max(n - k + 1, 0)
    assert dest.dtype == sizes.dtype == torch.int32
    assert dest.shape == (n,) and sizes.shape == (buckets,)
    assert np.array_equal(dest.numpy()[:fits], jdest[:fits])
    assert torch.equal(dest, minimizer.kmer_destinations(codes, k, m, buckets))
    if n * buckets <= 2**25:
        want = np.asarray(jdispatch.bucket_sizes_device(jnp.asarray(jdest),
                                                        jnp.asarray(valid.numpy()), buckets))
    else:
        want = np.bincount(jdest[valid.numpy()], minlength=buckets)
    assert np.array_equal(sizes.numpy(), want)
    assert int(sizes.sum()) == int(valid.sum())


def test_sized_scan_rejects_what_the_kernel_does_not_take():
    codes = torch.zeros(100, dtype=torch.int8)
    valid = torch.ones(100, dtype=torch.bool)
    with pytest.raises(TypeError):
        minimizer.kmer_destinations_sized(codes, valid.to(torch.uint8), 31, 17, 4)
    with pytest.raises(TypeError):
        minimizer.kmer_destinations_sized(codes, valid[:99], 31, 17, 4)
    with pytest.raises(ValueError):
        minimizer.kmer_destinations_sized(codes, valid, 31, 17, 0)
    with pytest.raises(ValueError):
        minimizer.kmer_destinations_sized(codes, valid.to("meta"), 31, 17, 4)


def test_sized_scan_cases_reach_the_kernels_edges():
    """The hard cases hit what they are named for: block seams at each
    geometry, bin counts on both sides of the shared-memory cap, an empty
    and a full mask, reads with zero-length reads."""
    cases = testing.sized_scan_cases()
    outs = {testing.scan_geometry(k, m)[2] for _, _, _, k, m, _, _, _ in cases}
    assert len(outs) == 4
    bins = {b for *_, b, _, _ in cases}
    assert {testing.SCAN_SHARED_BINS, testing.SCAN_SHARED_BINS + 1} <= bins
    assert testing.scan_geometry(31, 17) == (15, 256, 3824)
    masks = {mask for *_, mask in cases}
    assert masks == {*testing.SCAN_MASKS, "reads"}
    valid = testing.scan_mask("reads", 5000, 31, 3)
    assert 0 < valid.sum() < valid.size


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_kernel_matches_plain(case):
    """One launch of the scan kernel and none of the key build; equal at
    every position (the kernel reads the codes modulo n, as the plain
    version's rolls wrap them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, n, k, m, buckets, _ = case
    codes = torch.from_numpy(_codes(case))
    before = dict(_build.launches)
    got = minimizer.kmer_destinations(codes.cuda(), k, m, buckets).cpu()
    assert _build.launches["minimizer_scan"] == before["minimizer_scan"] + 1
    assert _build.launches["keybuild"] == before["keybuild"]
    want = minimizer.kmer_destinations(codes, k, m, buckets)
    assert torch.equal(got, want)
    assert ((got >= 0) & (got < buckets)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", SIZED, ids=SIZED_IDS)
def test_sized_scan_kernel_matches_plain(case):
    """One launch of the scan kernel for the buckets and the sizes, both
    equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, _, k, m, buckets, _, _ = case
    codes, valid = _sized_inputs(case)
    before = _build.launches["minimizer_scan"]
    dest, sizes = minimizer.kmer_destinations_sized(codes.cuda(), valid.cuda(), k, m,
                                                    buckets)
    torch.cuda.synchronize()
    assert _build.launches["minimizer_scan"] == before + 1
    want_dest, want_sizes = minimizer.kmer_destinations_sized(codes, valid, k, m, buckets)
    assert torch.equal(dest.cpu(), want_dest)
    assert torch.equal(sizes.cpu(), want_sizes)
