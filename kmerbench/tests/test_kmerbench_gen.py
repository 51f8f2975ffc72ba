"""The read generator: seeds, sizes and the read profile."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kmerbench.gen import reads as gen

HIFI = {"length": [10000, 20000], "substitution": 0.001, "reverse": 0.5, "n_per_2e26": 0,
        "repeats": {"elements": 20, "length": 2000, "share": 0.1, "divergence": 0.01}}
SHORT = {"length": [150, 150], "substitution": 0.005, "reverse": 0.5, "n_per_2e26": 1000,
         "repeats": None}


@pytest.mark.parametrize("profile", [HIFI, SHORT])
def test_kmerbench_gen_same_seed_same_reads(profile):
    a = gen.host_reads(profile, 1 << 21, 16, 2**31 + 17, "cpu")
    b = gen.host_reads(profile, 1 << 21, 16, 2**31 + 17, "cpu")
    c = gen.host_reads(profile, 1 << 21, 16, 2**31 + 18, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    # Another seed: the same sizes in another order.
    assert np.array_equal(np.sort(a[1]), np.sort(c[1]))
    assert a[0].dtype == np.uint8 and int(a[0].max()) <= 3


@pytest.mark.parametrize("bases", [1 << 20, 1 << 30, (1 << 31) + 12345])
def test_kmerbench_gen_lengths_fill_the_range(bases):
    lens = gen.read_lengths(HIFI, bases)
    assert int(lens.sum()) == bases
    assert lens.min() >= 10000 and lens.max() <= 20000
    assert abs(lens.mean() - 15000) < 50
    short = gen.read_lengths(SHORT, bases)
    assert (short == 150).all() and short.size == bases // 150


def test_kmerbench_gen_short_read_count_at_cell_size():
    assert gen.read_lengths(SHORT, 1 << 30).size == 7158278


def test_kmerbench_gen_substitution_rate():
    clean = dict(SHORT, substitution=0.0, n_per_2e26=0)
    noisy = dict(SHORT, substitution=0.01, n_per_2e26=0)
    a, _ = gen.host_reads(clean, 1 << 22, 16, 5, "cpu")
    b, _ = gen.host_reads(noisy, 1 << 22, 16, 5, "cpu")
    rate = float((a != b).mean())
    # Positions drawn with replacement: a few land twice.
    assert 0.0099 * 0.98 < rate <= 0.01 + 1e-4


def test_kmerbench_gen_reads_come_from_the_genome():
    """Every read of an error-free profile is a substring of the genome or
    of its reverse complement, so coverage is bases / genome."""
    profile = dict(HIFI, substitution=0.0, length=[300, 500])
    codes, lens = gen.host_reads(profile, 1 << 18, 32, 9, "cpu")
    g = torch.Generator().manual_seed(9)
    genome = gen.make_genome(profile, (1 << 18) // 32, g, "cpu").numpy()
    fwd = genome.tobytes()
    rev = (3 - genome[::-1]).astype(np.uint8).tobytes()
    offsets = np.concatenate([[0], np.cumsum(lens)])
    strands = 0
    for i in range(0, lens.size, 7):
        read = codes[offsets[i]:offsets[i + 1]].tobytes()
        assert read in fwd or read in rev
        strands += read in rev
    assert 0 < strands < len(range(0, lens.size, 7))


def test_kmerbench_gen_repeat_share():
    profile = dict(HIFI, repeats=dict(HIFI["repeats"], divergence=0.0))
    size = 1 << 20
    g = torch.Generator().manual_seed(3)
    genome = gen.make_genome(profile, size, g, "cpu").numpy()
    g = torch.Generator().manual_seed(3)
    torch.randint(0, 4, (size,), generator=g, dtype=torch.uint8)
    elements = torch.randint(0, 4, (20, 2000), generator=g, dtype=torch.uint8).numpy()
    known = {e.tobytes() for e in elements}
    slots = genome[: size // 2000 * 2000].reshape(-1, 2000)
    copies = sum(s.tobytes() in known for s in slots)
    assert copies == round(0.1 * size / 2000)


def test_kmerbench_gen_ns_are_coded_as_a():
    clean = dict(SHORT, substitution=0.0, n_per_2e26=0)
    with_n = dict(SHORT, substitution=0.0, n_per_2e26=1 << 16)
    a, _ = gen.host_reads(clean, 1 << 20, 16, 4, "cpu")
    b, _ = gen.host_reads(with_n, 1 << 20, 16, 4, "cpu")
    moved = a != b
    assert moved.any() and (b[moved] == 0).all()
