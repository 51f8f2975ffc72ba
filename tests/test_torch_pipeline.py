"""The port's single-device slice as a whole against the JAX package's
count_reads in its production configuration (fused keybuild, fused count,
member Pallas sort; Pallas in interpret mode) and the pure-Python oracle."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hysortk_tpu
import hysortk_tpu_torch
from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu import testing as oracle
from hysortk_tpu.ops import pallas_sort
from hysortk_tpu_torch import config, pipeline, testing
from hysortk_tpu_torch.ops import compact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# W = 1, 2 and 4 words; few enough bases that each interpret-mode member
# sort stays inside one 2048-slot block.
KS = [15, 31, 55]


@pytest.fixture(autouse=True)
def _interpret():
    prev = pallas_sort._INTERPRET
    pallas_sort.set_interpret(True)
    yield
    pallas_sort.set_interpret(prev)


def _reads(seed=31):
    rng = np.random.default_rng(seed)
    reads = oracle.random_reads(rng, 16, 5, 110, "ACGTNacgt")
    return reads + reads[:6]  # repeats so counts reach L


def _cfgs(k, **kw):
    fields = dict(k=k, m=min(17, k - 1), lower=2, upper=6, pad_multiple=256,
                  fuse_keybuild=True, fuse_count=True, sort_backend="pallas")
    fields.update(kw)
    j = hysortk_tpu.KmerConfig(**fields)
    return config.from_jax_fields(dataclasses.asdict(j)), j


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j : j + 60] + "\n")


@pytest.mark.parametrize("k", KS)
def test_count_reads_matches_jax(k):
    reads = _reads()
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(reads)
    assert codes.size + 16 <= 2048
    cfg, jcfg = _cfgs(k)
    got, hist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    want, jhist = jpipeline.count_reads(codes, lengths, jcfg)
    assert got.keys.dtype == np.uint32 and got.counts.dtype == np.int32
    assert got.keys.shape == want.keys.shape and len(got) > 0
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(hist, jhist)
    expect = testing.oracle_filtered(reads, k, cfg.lower, cfg.upper)
    assert {km.decode(): c for km, c in got.as_dict().items()} == expect


@pytest.mark.parametrize("k", KS)
def test_count_flat_matches_jax(k):
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(_reads(7))
    cfg, jcfg = _cfgs(k, fuse_keybuild=False, fuse_count=False, sort_backend="xla")
    flat, valid = hysortk_tpu_torch.io.fasta.flatten_for_device(codes, lengths, k, 256)
    got, hist = pipeline.count_flat(flat, valid, cfg, device="cpu")
    want, jhist = jpipeline.count_flat(flat, valid, jcfg)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(hist, jhist)


def test_facade_output_bytes_match_jax(tmp_path):
    """read_dna_buffer -> kmer_count(device="cpu") -> write_output_file
    gives the same 0.out as JAX count_reads -> write_output_file. (JAX's
    own kmer_count would take its sharded path under the tests' 8 virtual
    devices.)"""
    reads = _reads()
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, reads)
    cfg, jcfg = _cfgs(31)
    codes, lengths = hysortk_tpu_torch.read_dna_buffer(path)
    kl, hist = hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cpu")
    ours = hysortk_tpu_torch.write_output_file(kl, str(tmp_path / "port"))
    jkl, jhist = jpipeline.count_reads(codes, lengths, jcfg)
    theirs = hysortk_tpu.write_output_file(jkl, str(tmp_path / "jax"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read() and data
    assert hysortk_tpu_torch.print_kmer_histogram(hist) == \
        hysortk_tpu.print_kmer_histogram(jhist)


def test_config_carries_across():
    _, jcfg = _cfgs(55, lower=3, upper=40, routing="minimizer", combiner=True)
    cfg = config.from_jax_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.words == jcfg.words and cfg.window == jcfg.window
    assert dataclasses.asdict(config.KmerConfig()) == \
        dataclasses.asdict(hysortk_tpu.KmerConfig())
    with pytest.raises(ValueError):
        config.from_jax_fields({"k": 31, "no_such_field": 1})


@pytest.mark.parametrize("bad", [
    {"k": 2}, {"k": 97}, {"k": 31, "m": 31}, {"lower": 0},
    {"lower": 50, "upper": 40}, {"upper": 70000}, {"sort_backend": "gpu"},
    {"routing": "x"}, {"classifier": "x"}, {"dispatcher": "x"},
    {"extension": True, "combiner": True},
])
def test_bad_configs_refused_alike(bad):
    with pytest.raises(ValueError):
        hysortk_tpu.KmerConfig(**bad)
    with pytest.raises(ValueError):
        config.KmerConfig(**bad)


def _port_sources():
    """Every .py of the package, and chip_smoke.py."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "hysortk_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_import_leaves_jax_out():
    """Importing every module of the package (runtime/ and cli.py included)
    brings in neither jax nor hysortk_tpu, and no source of the package nor
    chip_smoke.py names either in an import statement."""
    code = ("import sys, pkgutil, importlib, hysortk_tpu_torch as ht\n"
            "names = [m.name for m in pkgutil.walk_packages(ht.__path__, ht.__name__ + '.')]\n"
            "for name in names: importlib.import_module(name)\n"
            "assert len(names) > 20 and 'hysortk_tpu_torch.cli' in names, names\n"
            "assert 'hysortk_tpu_torch.runtime.scheduler' in names, names\n"
            "assert 'hysortk_tpu_torch.parallel.pipeline' in names, names\n"
            "assert 'hysortk_tpu_torch.parallel.spawn' in names, names\n"
            "assert 'hysortk_tpu_torch.ops.minimizer' in names, names\n"
            "assert 'hysortk_tpu_torch.parallel.supermer_route' in names, names\n"
            "assert 'hysortk_tpu_torch.parallel.multihost' in names, names\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'hysortk_tpu' not in sys.modules, 'hysortk_tpu imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    sources = _port_sources()
    assert len(sources) > 25
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "hysortk_tpu"} & set(roots), (path, roots)


@pytest.mark.parametrize("k", KS)
def test_count_reads_device_compact_is_the_same_list(k):
    """cfg.device_compact selects nothing in the port's count_reads (the
    kept rows are always gathered on the device); the JAX count_reads
    honours it. All three give one KmerList."""
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(_reads())
    xla = dict(fuse_keybuild=False, fuse_count=False, sort_backend="xla")
    cfg, _ = _cfgs(k, **xla)
    cfg_dc, jcfg_dc = _cfgs(k, device_compact=True, **xla)
    plain, hist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    got, dhist = pipeline.count_reads(codes, lengths, cfg_dc, device="cpu")
    want, jhist = jpipeline.count_reads(codes, lengths, jcfg_dc)
    for other, ohist in ((plain, hist), (want, jhist)):
        assert np.array_equal(got.keys, other.keys)
        assert np.array_equal(got.counts, other.counts)
        assert np.array_equal(dhist, ohist)
    assert len(got) > 0


@pytest.mark.parametrize("upper,dtype", [(50, torch.uint8), (255, torch.uint8),
                                         (256, torch.uint16), (65535, torch.uint16)])
def test_narrow_counts_and_pull_prefix(upper, dtype):
    cnt = torch.tensor([1, 2, upper, 7, 0, 0], dtype=torch.int32)
    narrow = compact.compact_kept_plain([cnt], cnt, torch.ones(6, dtype=torch.bool),
                                        upper=upper).counts
    assert narrow.dtype == dtype
    pulled, words = pipeline.pull_prefix([narrow, cnt], 4)
    assert pulled.astype(np.int32).tolist() == [1, 2, upper, 7]
    assert words.tolist() == [1, 2, upper, 7] and words.dtype == np.int32
    assert pipeline.pull_prefix([cnt], 0)[0].shape == (0,)


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(_reads())
    with pytest.raises(RuntimeError, match="cuda"):
        hysortk_tpu_torch.kmer_count(codes, lengths, config.KmerConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.count_reads(codes, lengths, config.KmerConfig(), device="cuda")


def test_unported_modes_raise():
    """More than one device is not ported; extension mode is, and gives the
    counts of the plain call with every occurrence beside them."""
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(_reads())
    ext, hist = hysortk_tpu_torch.kmer_count(
        codes, lengths, config.KmerConfig(extension=True, lower=2, upper=6),
        device="cpu"
    )
    plain, phist = hysortk_tpu_torch.kmer_count(
        codes, lengths, config.KmerConfig(lower=2, upper=6), device="cpu"
    )
    assert isinstance(ext, hysortk_tpu_torch.KmerListExt) and len(ext) > 0
    assert np.array_equal(ext.keys, plain.keys)
    assert np.array_equal(ext.counts, plain.counts) and np.array_equal(hist, phist)
    assert [p.size for p in ext.pos] == ext.counts.tolist()
    with pytest.raises(NotImplementedError):
        hysortk_tpu_torch.kmer_count(
            codes, lengths, config.KmerConfig(extension=True),
            device=["cuda:0", "cuda:1"]
        )
    with pytest.raises(NotImplementedError):
        hysortk_tpu_torch.kmer_count(
            codes, lengths, config.KmerConfig(), device=["cuda:0", "cuda:1"]
        )


def test_empty_input():
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes([])
    kl, hist = hysortk_tpu_torch.kmer_count(
        codes, lengths, config.KmerConfig(), device="cpu"
    )
    assert len(kl) == 0 and kl.keys.shape == (0, 2) and hist.sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_count_reads_on_cuda_matches_cpu(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reads = _reads(k)
    codes, lengths = hysortk_tpu_torch.io.fasta.reads_to_codes(reads)
    cfg, _ = _cfgs(k)
    got, hist = pipeline.count_reads(codes, lengths, cfg, device="cuda")
    want, whist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(hist, whist)
