"""The port's columnar FASTA index (hysortk_tpu_torch/io/fasta.py: FaiIndex,
generate_fai, parse_fai, partition_bounds / partition_records,
read_record_bytes, read_records, read_dna_buffer) against the JAX package's
record-by-record index (hysortk_tpu/io/fasta.py) on the CPU: the written
.fai byte for byte, the parsed columns and names, the partition for 1 to 8
shards, the read displacements and owners, the codes and lengths read. The
FASTA cases are those of tests/test_fasta_io.py, headers without a name,
.fai files with blank lines and six columns, and 20 seeded random FASTAs;
each runs through the host library's index scan (`native.fai_build`) and
through its plain version. Exact equality throughout."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import hysortk_tpu
import hysortk_tpu_torch
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu_torch.io import fasta, native

THREADS = [1, 2, 7]
N_RANDOM = 20


def _write_reads(reads, width=60, desc=" desc words", newline="\n") -> bytes:
    out = []
    for i, r in enumerate(reads):
        out.append(f">read{i}{desc}{newline}")
        out += [r[j:j + width] + newline for j in range(0, len(r), width)]
    return "".join(out).encode()


def _random_fasta(seed: int) -> bytes:
    """Line widths 1-120, lengths 0-500 with runs of zero-length records,
    mixed case and Ns, now and then a CRLF file, a header with leading
    blanks, an empty line, or no newline at the end."""
    rng = np.random.default_rng(seed)
    newline = b"\r\n" if seed % 5 == 3 else b"\n"
    out = []
    for i in range(int(rng.integers(1, 40))):
        n = 0 if rng.random() < 0.3 else int(rng.integers(1, 501))
        width = int(rng.integers(1, 121))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), n))
        lead = b" \t"[: int(rng.integers(0, 3))]
        out.append(b">" + lead + b"r%d" % i + (b"\tx y" if rng.random() < 0.5 else b"")
                   + newline)
        out += [seq[j:j + width] + newline for j in range(0, n, width)]
        if rng.random() < 0.1:
            out.append(newline)
    data = b"".join(out)
    return data.rstrip(b"\r\n") if seed % 4 == 1 else data


def _case(name: str) -> bytes:
    """The FASTA bytes of one case."""
    if name == "content":
        return _write_reads(oracle.random_reads(np.random.default_rng(1), 15, 10, 200))
    if name == "roundtrip":
        return _write_reads(oracle.random_reads(np.random.default_rng(2), 8, 20, 100))
    if name == "single_line":
        return _write_reads(["ACGTACGTAC", "TTTTGGGGCC"], width=1000)
    if name == "subset":
        return _write_reads(oracle.random_reads(np.random.default_rng(3), 10, 30, 120))
    if name == "no_trailing_newline":
        return b">r0\nACGTACGTAC\n>r1\nTTGGCCAATT"
    if name == "crlf":
        return b">r0\r\nACGTAC\r\nGTACGT\r\n>r1\r\nTTTT\r\n"
    if name == "empty_record":
        return b">empty\n>r1\nACGT\n"
    if name == "lines_before_header":
        return b"ACGT\n\n>r0 x\nAC\nGT\nA\n>r1\nACG\n\n"
    if name == "empty_lines_only":
        return b">r0\n\n\n>r1\nAC\n\n"
    if name == "name_after_blank":
        return b">  x y\nACGT\n>\tz\nAC\n"
    if name.startswith("random"):
        return _random_fasta(int(name[len("random"):]))
    raise ValueError(name)


CASES = ["content", "roundtrip", "single_line", "subset", "no_trailing_newline",
         "crlf", "empty_record", "lines_before_header", "empty_lines_only",
         "name_after_blank"] + [f"random{s}" for s in range(N_RANDOM)]


@pytest.fixture(params=["native", "plain"])
def route(request, monkeypatch):
    """The port's index scan through the host library, or its plain version
    (the tests' seam, native.available)."""
    if request.param == "plain":
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _columns(index) -> list[tuple]:
    return [dataclasses.astuple(r) for r in index]


def _assert_same_index(got: fasta.FaiIndex, want: list) -> None:
    assert all(c.dtype == np.int64 for c in
               (got.length, got.offset, got.linebases, got.linewidth))
    assert len(got) == len(want)
    assert got.names == [r.name for r in want]
    assert np.array_equal(got.length, [r.length for r in want])
    assert np.array_equal(got.offset, [r.offset for r in want])
    assert np.array_equal(got.linebases, [r.linebases for r in want])
    assert np.array_equal(got.linewidth, [r.linewidth for r in want])
    assert _columns(got.records()) == _columns(want)


@pytest.mark.parametrize("case", CASES)
def test_index_partition_and_read_match_jax(tmp_path, route, case):
    path = str(tmp_path / "reads.fa")
    with open(path, "wb") as f:
        f.write(_case(case))
    index = fasta.generate_fai(path, path + ".fai")
    want = jfasta.generate_fai(path, str(tmp_path / "jax.fai"))
    with open(path + ".fai", "rb") as a, open(str(tmp_path / "jax.fai"), "rb") as b:
        assert a.read() == b.read()
    _assert_same_index(index, want)
    _assert_same_index(fasta.parse_fai(path + ".fai"), jfasta.parse_fai(path + ".fai"))
    _assert_same_index(fasta.load_or_build_fai(path), want)

    ids = np.arange(len(want))
    for shards in range(1, 9):
        parts = fasta.partition_records(index, shards)
        assert parts == jfasta.partition_records(want, shards)
        bounds = fasta.partition_bounds(index, shards)
        displs = fasta.read_displacements(parts)
        assert np.array_equal(bounds, displs)
        assert np.array_equal(displs, jfasta.read_displacements(parts))
        if ids.size:
            assert np.array_equal(fasta.getreadowner(displs, ids),
                                  jfasta.getreadowner(displs, ids))
        for s in range(shards):
            got = hysortk_tpu_torch.read_dna_buffer(path, s, shards)
            ref = hysortk_tpu.read_dna_buffer(path, s, shards)
            assert got[0].dtype == np.uint8 and got[1].dtype == np.int64
            assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])

    # A contiguous slice of records reads as the JAX package reads them.
    if len(want):
        lo, hi = len(want) // 3, len(want) - len(want) // 4
        for a, b in ((0, len(want)), (lo, max(hi, lo + 1))):
            codes, lengths = fasta.read_records(path, index[a:b])
            jcodes, jlengths = jfasta.read_records(path, want[a:b])
            assert np.array_equal(codes, jcodes) and np.array_equal(lengths, jlengths)
            raw, raw_off, seq_len, lb, lw = fasta.read_record_bytes(path, index[a:b])
            listed = fasta.read_record_bytes(path, index[a:b].records())
            for x, y in zip((raw, raw_off, seq_len, lb, lw), listed):
                assert np.array_equal(x, y)
            with open(path, "rb") as f:
                f.seek(int(index.offset[a:b].min()))
                assert raw.tobytes() == f.read(raw.size)


@pytest.mark.parametrize("header", [b">", b"> \t", b">\r"])
def test_header_without_a_name_raises_like_jax(tmp_path, route, header):
    path = str(tmp_path / "reads.fa")
    with open(path, "wb") as f:
        f.write(b">r0\nACGT\n" + header + b"\nACGT\n>r2\nAC\n")
    with pytest.raises(IndexError):
        jfasta.generate_fai(path)
    with pytest.raises(IndexError):
        fasta.generate_fai(path, path + ".fai")
    assert not os.path.exists(path + ".fai")


def test_empty_fasta_writes_no_index(tmp_path, route):
    path = str(tmp_path / "reads.fa")
    open(path, "wb").close()
    assert len(fasta.generate_fai(path, path + ".fai")) == len(jfasta.generate_fai(path))
    assert not os.path.exists(path + ".fai")
    codes, lengths = hysortk_tpu_torch.read_dna_buffer(path)
    assert codes.size == 0 and lengths.size == 0


FAI_TEXTS = {
    "blank_lines": b"\nr0\t10\t4\t60\t61\n\n  \nr1\t0\t20\t0\t0\n\n",
    "six_columns": b"r0\t10\t4\t60\t61\t100\nr1\t20\t30\t60\t61\t200\n",
    "spaces": b"r0 10 4 60 61\nr1  20\t30 60 61 extra\n",
    "crlf": b"r0\t10\t4\t60\t61\r\nr1\t20\t30\t60\t61\r\n",
    "no_newline": b"r0\t10\t4\t60\t61\nr1\t20\t30\t60\t61",
    "leading_zeros_and_sign": b"r0\t0010\t+4\t60\t61\n",
    "wide_numbers": b"r0\t%d\t%d\t60\t61\n" % (3 * 2**31, 2**40 + 7),
    "beyond_18_digits": b"r0\t%d\t4\t60\t61\n" % (10**18 + 3),
    "unicode_name": "ré\t10\t4\t60\t61\n".encode(),
}


@pytest.mark.parametrize("kind", sorted(FAI_TEXTS))
def test_parse_fai_matches_jax(tmp_path, kind):
    """Files off the columns' fast route (blank lines, spaces, six columns,
    \\r, signs, numbers beyond int32 and beyond 18 digits, non-ASCII names)
    parse as the JAX package parses them."""
    path = str(tmp_path / "x.fai")
    with open(path, "wb") as f:
        f.write(FAI_TEXTS[kind])
    _assert_same_index(fasta.parse_fai(path), jfasta.parse_fai(path))


def test_fai_text_of_wide_columns_matches_jax_format(tmp_path):
    """Offsets and lengths beyond 2^31 stay int64 through the text and back."""
    records = [fasta.FaiRecord("a", 3 * 2**31 + 5, 2**40 + 1, 60, 61),
               fasta.FaiRecord("bb", 0, 0, 0, 0),
               fasta.FaiRecord("c", 9, 10**15, 1, 1)]
    index = fasta.FaiIndex.from_records(records)
    text = "".join(f"{r.name}\t{r.length}\t{r.offset}\t{r.linebases}\t{r.linewidth}\n"
                   for r in records).encode()
    assert index.to_bytes() == text
    path = str(tmp_path / "w.fai")
    with open(path, "wb") as f:
        f.write(index.to_bytes())
    assert _columns(fasta.parse_fai(path)) == _columns(records)
    assert fasta.partition_records(index, 2) == jfasta.partition_records(
        [jfasta.FaiRecord(*dataclasses.astuple(r)) for r in records], 2)


LENGTH_CASES = {
    "balanced": [100, 100, 100, 100, 400, 50, 50, 100, 100],
    "one_record": [10],
    "none": [],
    "zeros_first": [0, 0, 0, 5, 5, 5],
    "all_zero": [0] * 7,
    "one_heavy": [1, 1, 1000, 1, 1],
    "fewer_than_shards": [3, 4],
    "wide": [3 * 2**31, 2**33, 5, 2**32],
}


@pytest.mark.parametrize("kind", sorted(LENGTH_CASES) + [f"random{s}" for s in range(6)])
def test_partition_matches_jax_loop(kind):
    """partition_bounds against the JAX package's loop over records, for 1
    to 8 shards (the must-advance rule and zero-length records included),
    on records given as FaiRecords and as an index."""
    if kind.startswith("random"):
        rng = np.random.default_rng(int(kind[len("random"):]))
        lengths = rng.integers(0, 300, int(rng.integers(1, 60)))
        lengths[rng.random(lengths.size) < 0.3] = 0
        lengths = lengths.tolist()
    else:
        lengths = LENGTH_CASES[kind]
    records = [fasta.FaiRecord(f"r{i}", n, 0, 60, 61) for i, n in enumerate(lengths)]
    jrecords = [jfasta.FaiRecord(f"r{i}", n, 0, 60, 61) for i, n in enumerate(lengths)]
    index = fasta.FaiIndex.from_records(records)
    for shards in range(1, 9):
        want = jfasta.partition_records(jrecords, shards)
        assert fasta.partition_records(records, shards) == want
        assert fasta.partition_records(index, shards) == want
        bounds = fasta.partition_bounds(index, shards)
        assert bounds.dtype == np.int64 and bounds.shape == (shards + 1,)
        assert np.array_equal(bounds, jfasta.read_displacements(want))


def test_main_path_builds_no_record(tmp_path, monkeypatch):
    """read_dna_buffer, building the .fai and then parsing it, never makes
    a FaiRecord: the index stays in columns."""
    path = str(tmp_path / "reads.fa")
    with open(path, "wb") as f:
        f.write(_random_fasta(7) + _random_fasta(8))
    want = [hysortk_tpu.read_dna_buffer(path, s, 3) for s in range(3)]
    os.remove(path + ".fai")

    def refuse(self, *args, **kwargs):
        raise AssertionError("a FaiRecord was built")

    monkeypatch.setattr(fasta.FaiRecord, "__init__", refuse)
    for build in (True, False):
        assert os.path.exists(path + ".fai") != build
        for s in range(3):
            codes, lengths = hysortk_tpu_torch.read_dna_buffer(path, s, 3)
            assert np.array_equal(codes, want[s][0])
            assert np.array_equal(lengths, want[s][1])
    with pytest.raises(AssertionError, match="FaiRecord"):
        fasta.load_or_build_fai(path)[0]


@pytest.mark.parametrize("threads", THREADS)
def test_fai_build_matches_plain_version(tmp_path, threads):
    """The host library's scan (several chunks: the file is over 3 MB) at
    1, 2 and 7 workers against its plain version: columns, name bounds and
    the .fai text."""
    rng = np.random.default_rng(threads)
    parts = [_random_fasta(int(s)) + b"\n" for s in rng.integers(0, 1000, 60)]
    long = _write_reads(oracle.random_reads(rng, 6000, 0, 1200), width=77)
    data = np.frombuffer(b"".join(parts[:30]) + long + b"".join(parts[30:]), np.uint8)
    assert data.size > 3 << 20
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        cols, name_lo, name_hi, text = native.fai_build(data)
    finally:
        torch.set_num_threads(before)
    pcols, plo, phi = fasta.fai_columns_plain(data)
    assert np.array_equal(cols, pcols)
    assert np.array_equal(name_lo, plo) and np.array_equal(name_hi, phi)
    path = str(tmp_path / "big.fa")
    data.tofile(path)
    index = fasta.generate_fai(path)
    assert text.tobytes() == index.to_bytes()
    jfasta.generate_fai(path, str(tmp_path / "jax.fai"))
    with open(str(tmp_path / "jax.fai"), "rb") as f:
        assert f.read() == text.tobytes()


def test_index_slices_and_records():
    records = [fasta.FaiRecord(n, i, 10 * i, 60, 61) for i, n in enumerate("abcdef")]
    index = fasta.FaiIndex.from_records(records)
    assert index[2] == records[2] and index[-1] == records[-1]
    part = index[1:4]
    assert part.records() == records[1:4] and part.names == ["b", "c", "d"]
    assert np.shares_memory(part.length, index.length)
    assert index == records and part == records[1:4] and part != records[:3]
    assert index == fasta.FaiIndex.from_records(records) and index != part
    assert len(index[5:2]) == 0 and index[5:2].names == []
    assert part.to_bytes() == b"b\t1\t10\t60\t61\nc\t2\t20\t60\t61\nd\t3\t30\t60\t61\n"
    with pytest.raises(IndexError):
        index[6]
    with pytest.raises(ValueError):
        index[::2]
