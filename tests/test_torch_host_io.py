"""The port's host library (csrc/host_io.cpp through io/native.py) against
its numpy plain versions and against the JAX package's host routes (its
native library where that loads, and its numpy route), at 1, 2 and 7
worker threads; and the library's build: its place, its reuse, and a
failed build that raises."""

import contextlib
import os
import stat

import numpy as np
import pytest
import torch

from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.io import native as jnative
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.io import writer as jwriter
from hysortk_tpu.ops import kmer as jkmer
from hysortk_tpu.pipeline import KmerList as JKmerList
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.io import fasta, native, supermer, writer
from hysortk_tpu_torch.ops import kmer
from hysortk_tpu_torch.pipeline import KmerList

THREADS = [1, 2, 7]
JAX_ROUTES = ["native", "numpy"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's thread count, which the loader hands the library, set to n."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(params=JAX_ROUTES)
def jax_route(request, monkeypatch):
    """The JAX package's host functions on one of its routes: its own native
    library (skipped where that does not load) or its numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    elif not jnative.available():
        pytest.skip("the JAX package's native library does not load here")
    return request.param


# ---------------------------------------------------------------------------
# FASTA strip and code


FASTA_CASES = ["wrapped_60", "wrapped_7", "one_read", "shorter_than_k",
               "empty_records", "large"]


def _fasta_reads(case: str) -> tuple[list[str], int]:
    """(reads, line width) of one FASTA case."""
    rng = np.random.default_rng(FASTA_CASES.index(case))
    if case == "wrapped_60":
        return testing.random_reads(rng, 60, 1, 400, "ACGTNacgtn"), 60
    if case == "wrapped_7":
        return testing.random_reads(rng, 40, 1, 90, "ACGTRYKMacgt"), 7
    if case == "one_read":
        return testing.random_reads(rng, 1, 1000, 1000, "ACGT"), 60
    if case == "shorter_than_k":
        return testing.random_reads(rng, 80, 1, 30, "ACGTN"), 60
    if case == "empty_records":
        reads = testing.random_reads(rng, 20, 1, 200, "ACGT")
        return [""] + reads[:10] + ["", ""] + reads[10:] + [""], 60
    if case == "large":  # 2^20 bases of 150-base reads
        codes = rng.integers(0, 5, ((1 << 20) // 150, 150))
        lut = np.array(list("ACGTN"))
        return ["".join(row) for row in lut[codes]], 60
    raise ValueError(case)


def _write_fasta(path, reads, width, newline="\n"):
    with open(path, "w", newline="") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i} description{newline}")
            for j in range(0, len(r), width):
                f.write(r[j : j + width] + newline)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", FASTA_CASES)
def test_strip_and_pack_matches_plain_and_jax(tmp_path, monkeypatch, jax_route,
                                              case, threads):
    reads, width = _fasta_reads(case)
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, reads, width)
    records = fasta.load_or_build_fai(path)
    args = fasta.read_record_bytes(path, records)
    with torch_threads(threads):
        got = native.strip_and_pack(*args)
        codes, lengths = fasta.read_records(path, records)
    want = fasta.strip_and_pack_plain(*args)
    oracle = fasta.CODE_LUT[np.frombuffer(
        "".join(testing.normalize(r) for r in reads).encode(), np.uint8)]
    jcodes, jlengths = jfasta.read_records(path, jfasta.load_or_build_fai(path))
    assert got.dtype == want.dtype == np.uint8
    for c in (got, codes, jcodes):
        assert np.array_equal(c, want)
    assert np.array_equal(want, oracle)
    assert np.array_equal(lengths, jlengths)
    assert lengths.tolist() == [len(r) for r in reads]


def test_read_records_empty_input(tmp_path, jax_route):
    path = str(tmp_path / "empty.fa")
    open(path, "w").close()
    records = fasta.load_or_build_fai(path)
    assert records == []
    codes, lengths = fasta.read_records(path, records)
    jcodes, jlengths = jfasta.read_records(path, jfasta.load_or_build_fai(path))
    assert codes.size == lengths.size == jcodes.size == jlengths.size == 0
    assert native.strip_and_pack(*[np.zeros(0, np.int64)] * 5).size == 0


def test_read_records_crlf_takes_the_plain_version(tmp_path, jax_route):
    """A `\\r` in the byte range routes read_records to the numpy plain
    version (its mask drops the `\\r`), as in the JAX package."""
    reads, width = _fasta_reads("wrapped_60")
    path = str(tmp_path / "crlf.fa")
    _write_fasta(path, reads, width, newline="\r\n")
    records = fasta.load_or_build_fai(path)
    before = native.calls["strip_and_pack"]
    codes, lengths = fasta.read_records(path, records)
    assert native.calls["strip_and_pack"] == before
    jcodes, jlengths = jfasta.read_records(path, jfasta.load_or_build_fai(path))
    assert np.array_equal(codes, jcodes) and np.array_equal(lengths, jlengths)
    want = "".join(testing.normalize(r) for r in reads)
    assert np.array_equal(codes, fasta.CODE_LUT[np.frombuffer(want.encode(), np.uint8)])


def test_strip_and_pack_refuses_records_past_the_bytes():
    raw = np.frombuffer(b"ACGT\nAC\n", np.uint8)
    one = np.ones(1, np.int64)
    with pytest.raises(ValueError):
        native.strip_and_pack(raw, 0 * one, 9 * one, 4 * one, 5 * one)


# ---------------------------------------------------------------------------
# 2-bit wire pack


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", [0, 16, 48, 1 << 20])
def test_pack_2bit_matches_plain_and_jax(jax_route, n, threads):
    # Inputs differ between thread counts, so that a word the library skips
    # cannot hold an earlier call's right answer.
    rng = np.random.default_rng(n + threads)
    codes = rng.integers(0, 4, n).astype(np.int8)
    if n:
        codes[:16] = 3  # a word with the top bit set
    with torch_threads(threads):
        got = native.pack_2bit(codes.astype(np.uint8))
        routed = supermer.pack_codes_2bit(codes)
    want = supermer.pack_codes_2bit_plain(codes)
    assert got.dtype == want.dtype == np.uint32 and got.shape == (n // 16,)
    for w in (routed, jsupermer.pack_codes_2bit(codes)):
        assert np.array_equal(got, w)
    assert np.array_equal(want, got)
    if n:
        assert got[0] == 0xFFFFFFFF


@pytest.mark.parametrize("n", [1, 15, 17, 1000003])
def test_pack_2bit_ragged_length_takes_the_plain_version(jax_route, n):
    """n % 16 != 0: the last word zero-filled, by the byte-wise plain pack."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.int8)
    before = native.calls["pack_2bit"]
    got = supermer.pack_codes_2bit(codes)
    assert native.calls["pack_2bit"] == before
    assert np.array_equal(got, jsupermer.pack_codes_2bit(codes))
    padded = np.zeros(n + (-n % 16), np.uint8)
    padded[:n] = codes
    assert np.array_equal(got, native.pack_2bit(padded))
    with pytest.raises(ValueError):
        native.pack_2bit(codes.astype(np.uint8))


# ---------------------------------------------------------------------------
# Key decode and the output formatter


def _keys(k: int, n: int, seed: int) -> np.ndarray:
    """n random packed keys of length k, half with the top bit set, the
    unused low bits of the last word zero."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (n, (k + 15) // 16), dtype=np.uint64).astype(np.uint32)
    r = k - 16 * (keys.shape[1] - 1)
    keys[:, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF)
    if n:
        keys[0] = 0xFFFFFFFF
        keys[0, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF)
    return keys


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", [0, 1, 40_000])
@pytest.mark.parametrize("k", [15, 31, 95])
def test_decode_keys_matches_plain_and_jax(jax_route, k, n, threads):
    keys = _keys(k, n, k * 7 + n + threads)
    with torch_threads(threads):
        got = native.decode_keys(keys, k)
        routed = kmer.decode_keys(keys, k)
    want = kmer.decode_keys_plain(keys, k)
    assert got.dtype == want.dtype == np.dtype(f"S{k}") and got.shape == (n,)
    for w in (want, routed, jkmer.decode_keys(keys, k)):
        assert np.array_equal(got, w)
    if n:
        assert got[0] == b"T" * k


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", [0, 1, 40_000])
@pytest.mark.parametrize("k", [17, 31, 55])
def test_format_output_matches_plain_and_jax(tmp_path, jax_route, k, n, threads):
    keys = _keys(k, n, k + n + threads)
    rng = np.random.default_rng(n + threads)
    counts = rng.integers(1, 2**31 - 1, n).astype(np.int32)
    counts[: min(n, 4)] = [1, 9, 10, 2**31 - 1][: min(n, 4)]
    ours, theirs = KmerList(keys, counts, k), JKmerList(keys, counts, k)
    with torch_threads(threads):
        got = native.format_output(keys, counts, k)
        lines = writer.format_output_lines(ours)
        path = writer.write_output_file(ours, str(tmp_path / "port"), chunk_rows=7919)
    want = writer.format_output_plain(keys, counts, k)
    assert got == lines == want == jwriter.format_output_lines(theirs)
    jpath = jwriter.write_output_file(theirs, str(tmp_path / "jax"))
    with open(path, "rb") as fa, open(jpath, "rb") as fb:
        assert fa.read() == fb.read() == want
    assert want.count(b"\n") == n


# ---------------------------------------------------------------------------
# Supermer run decomposition and run gather


RUN_CASES = list(testing.SUPERMER_KINDS) + ["one_read", "no_valid", "large"]


def _run_case(kind: str, k: int = 31, num_dest: int = 4, seed: int = 9):
    """(flat codes, valid, dest) of one encoder case."""
    if kind == "one_read":
        reads = testing.random_reads(np.random.default_rng(seed), 1, 900, 900)
        src = "random"
    elif kind == "no_valid":  # every read shorter than k
        reads = testing.random_reads(np.random.default_rng(seed), 50, 1, k - 1)
        src = "random"
    elif kind == "large":  # 2^20 bases: tens of thousands of runs
        reads, src = _fasta_reads("large")[0], "random"
    else:
        reads, src = testing.supermer_reads(kind, k, seed), kind
    codes, lengths = fasta.reads_to_codes(reads)
    flat, valid = fasta.flatten_for_device(codes, lengths, k, 256)
    dest = testing.supermer_case_dest(src, flat.size, num_dest, seed)
    return flat, valid, dest


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("kind", RUN_CASES)
def test_run_boundaries_and_gather_match_plain_and_jax(jax_route, kind, threads):
    k = 31
    flat, valid, dest = _run_case(kind, k, seed=9 + threads)
    max_kmers = supermer.MAX_SUPERMER_LEN - k + 1
    with torch_threads(threads):
        got = native.run_boundaries(valid, dest, max_kmers)
        routed = supermer.run_boundaries(valid, dest, k)
    want = supermer.run_boundaries_plain(valid, dest, max_kmers)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    jwant = jsupermer.run_boundaries(valid, dest, k)
    for g, w in zip(routed, jwant):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(routed[1], want[1] + k - 1)
    if kind == "no_valid":
        assert got[0].size == 0

    starts, bases = routed[0], routed[1]
    out_off = np.zeros(bases.size, np.int64)
    np.cumsum(bases[:-1], out=out_off[1:])
    total = int(bases.sum())
    with torch_threads(threads):
        gathered = native.gather_runs(flat, starts, bases, out_off, total)
        streams = supermer.encode_supermer_streams(flat, valid, dest, k, 4)
    assert np.array_equal(gathered, supermer.gather_runs_plain(
        flat, starts, bases, out_off, total))
    for (c, ln), (jc, jln) in zip(
        streams, jsupermer.encode_supermer_streams(flat, valid, dest, k, 4)
    ):
        assert c.dtype == jc.dtype and np.array_equal(c, jc)
        assert np.array_equal(ln, jln)


def test_plain_routes_run_without_the_library(tmp_path, monkeypatch):
    """With the seam patched, the callers take the plain versions and make
    no call into the library."""
    monkeypatch.setattr(native, "available", lambda: False)
    native.reset_calls()
    reads, width = _fasta_reads("wrapped_60")
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, reads, width)
    codes, lengths = fasta.read_records(path, fasta.load_or_build_fai(path))
    supermer.pack_codes_2bit(np.zeros(1 << 12, np.int8))
    keys = _keys(31, 5000, 1)
    writer.format_output_lines(KmerList(keys, np.ones(5000, np.int32), 31))
    kmer.decode_keys(keys, 31)
    flat, valid, dest = _run_case("random")
    supermer.encode_supermer_streams(flat, valid, dest, 31, 4)
    assert sum(native.calls.values()) == 0


# ---------------------------------------------------------------------------
# The build


def test_library_is_the_ports_own_build():
    """Loaded from build/host/<hash>/, built from csrc/host_io.cpp with no
    OpenMP and no -march=native; nothing under native/."""
    path = native.library_path()
    assert os.path.commonpath([path, os.path.join(REPO, "build", "host")]) == \
        os.path.join(REPO, "build", "host")
    assert os.path.commonpath([path, os.path.join(REPO, "native")]) != \
        os.path.join(REPO, "native")
    assert os.path.basename(_build.HOST_SOURCE) == "host_io.cpp"
    assert os.path.dirname(_build.HOST_SOURCE) == os.path.join(
        REPO, "hysortk_tpu_torch", "csrc")
    assert not any("openmp" in f or "march" in f for f in _build.HOST_FLAGS)
    with open(_build.HOST_SOURCE) as f:
        assert "pragma omp" not in f.read()


def _fake_compiler(path, version: str, body: str) -> str:
    """A shell script that answers --version with `version` and otherwise
    runs `body`."""
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nif [ "$1" = --version ]; then echo "{version}"; '
                f'exit 0; fi\n{body}\n')
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return str(path)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The loader with nothing loaded, building into a temp directory."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "host"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    return tmp_path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    """A build that cannot run raises from every native route instead of
    returning the numpy result."""
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    keys = _keys(31, 5000, 2)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        supermer.pack_codes_2bit(np.zeros(64, np.int8))
    with pytest.raises(RuntimeError):
        writer.format_output_lines(KmerList(keys, np.ones(5000, np.int32), 31))
    with pytest.raises(RuntimeError):
        kmer.decode_keys(keys, 31)
    assert native._lib is None


def test_failing_compiler_raises_with_its_errors(fresh_build, monkeypatch):
    cxx = _fake_compiler(fresh_build / "broken-cxx", "broken 1.0",
                         'echo "host_io.cpp:1: error: no luck here" >&2; exit 1')
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="error: no luck here"):
        native.library_path()
    assert not any(f.endswith(".so") for _, _, fs in os.walk(fresh_build / "host")
                   for f in fs)


def test_build_is_reused_and_keyed_by_the_compiler(fresh_build, monkeypatch):
    """A second load reuses the library; another compiler version line
    builds into another directory."""
    real = _build.find_cxx() if not os.environ.get("CXX") else os.environ["CXX"]
    cxx = _fake_compiler(fresh_build / "cxx-a", "wrapped 1", f'exec {real} "$@"')
    monkeypatch.setenv("CXX", cxx)
    first = _build.host_library_path()
    mtime = os.stat(first).st_mtime_ns
    assert _build.host_library_path() == first
    assert os.stat(first).st_mtime_ns == mtime
    with open(os.path.join(os.path.dirname(first), "build.log")) as f:
        assert "wrapped 1" in f.read()
    cxx = _fake_compiler(fresh_build / "cxx-b", "wrapped 2", f'exec {real} "$@"')
    monkeypatch.setenv("CXX", cxx)
    second = _build.host_library_path()
    assert os.path.dirname(second) != os.path.dirname(first)
    assert os.path.dirname(os.path.dirname(second)) == str(fresh_build / "host")
    with torch_threads(3):
        assert np.array_equal(
            native.pack_2bit(np.full(32, 3, np.uint8)), [0xFFFFFFFF] * 2)
    assert native.library_path() == second
