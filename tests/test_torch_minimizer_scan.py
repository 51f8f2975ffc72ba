"""The minimizer scan (ops/minimizer.kmer_destinations) on every case of
hysortk_tpu_torch.testing.scan_cases: the plain version against the JAX
package on the CPU, and the kernel (csrc/minimizer_scan.cu) against the
plain version on a card (`cuda` marker). Exact at every position where a
k-mer fits (i <= n - k: the plain versions' rolls wrap past it), and every
bucket in [0, num_buckets). Seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import minimizer as jminimizer
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_kernel_matches_plain(case):
    """One launch of the scan kernel and none of the key build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, n, k, m, buckets, _ = case
    codes = torch.from_numpy(_codes(case))
    before = dict(_build.launches)
    got = minimizer.kmer_destinations(codes.cuda(), k, m, buckets).cpu()
    assert _build.launches["minimizer_scan"] == before["minimizer_scan"] + 1
    assert _build.launches["keybuild"] == before["keybuild"]
    want = minimizer.kmer_destinations(codes, k, m, buckets)
    fits = max(n - k + 1, 0)
    assert torch.equal(got[:fits], want[:fits])
    assert ((got >= 0) & (got < buckets)).all()
