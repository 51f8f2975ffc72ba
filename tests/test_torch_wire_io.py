"""The port's host I/O and wire decode against the JAX package: 2-bit pack
-> device decode, FASTA reading, and the output writers byte for byte."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hysortk_tpu
import hysortk_tpu_torch
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.io import writer as jwriter
from hysortk_tpu.ops import wire as jwire
from hysortk_tpu.pipeline import KmerList as JKmerList
from hysortk_tpu_torch.io import fasta, native, supermer, writer
from hysortk_tpu_torch.ops import wire
from hysortk_tpu_torch.pipeline import KmerList


def _write_fasta(path, reads, width=60):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read{i} some description\n")
            for j in range(0, len(r), width):
                f.write(r[j : j + width] + "\n")


@pytest.mark.parametrize("k", [15, 31, 55])
def test_pack_decode_matches_jax(monkeypatch, k):
    rng = np.random.default_rng(k)
    lengths = rng.integers(0, 3 * k, 40)
    lengths[3] = 0  # an empty record
    total = int(lengths.sum())
    n = -(-(total + 16) // 256) * 256
    buf = np.zeros(n, dtype=np.int8)
    buf[:total] = rng.integers(0, 4, total)

    packed = supermer.pack_codes_2bit(buf)
    assert np.array_equal(packed, jsupermer.pack_codes_2bit(buf))
    with monkeypatch.context() as m:  # the numpy plain version packs alike
        m.setattr(native, "available", lambda: False)
        assert np.array_equal(supermer.pack_codes_2bit(buf), packed)
    assert (packed >= 0x80000000).any()
    codes, valid = wire.decode_block(
        torch.from_numpy(packed.view(np.int32)),
        torch.from_numpy(lengths.astype(np.int32)),
        k,
        n,
    )
    jcodes, jvalid = jwire.decode_block(
        jnp.asarray(packed), jnp.asarray(lengths.astype(np.int32)), k, n
    )
    assert codes.dtype == torch.int8 and valid.dtype == torch.bool
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(codes.numpy(), buf)
    _, host_valid = fasta.flatten_for_device(buf[:total], lengths, k, 256)
    assert np.array_equal(valid.numpy(), host_valid)


@pytest.mark.parametrize("rid_base,pad_reads", [(0, 0), (1000, 7)])
def test_rid_pos_from_lengths_matches_jax(rid_base, pad_reads):
    """Per-position (read id, position in read) from the lengths alone:
    zero-length reads (one leading, two stacked on one slot) keep counting,
    and the zero-padded pseudo-reads of `lens` mark past the real total."""
    rng = np.random.default_rng(rid_base + 3)
    lengths = rng.integers(1, 90, 30)
    lengths[[0, 11, 12, 29]] = 0
    total = int(lengths.sum())
    n = -(-(total + 16) // 256) * 256
    lens = np.concatenate([lengths, np.zeros(pad_reads, np.int64)]).astype(np.int32)
    rid, pos = wire.rid_pos_from_lengths(torch.from_numpy(lens), n, rid_base)
    jrid, jpos = jwire.rid_pos_from_lengths(jnp.asarray(lens), n, rid_base)
    assert rid.dtype == torch.int32 and pos.dtype == torch.int32
    assert np.array_equal(rid.numpy(), np.asarray(jrid))
    assert np.array_equal(pos.numpy().view(np.uint32), np.asarray(jpos))
    # Against the host flattener wherever a base lies.
    _, _, hrid, hpos = fasta.flatten_for_device_ext(
        np.zeros(total, np.uint8), lengths, 31, 256, rid_base)
    assert np.array_equal(rid.numpy()[:total], hrid[:total])
    assert np.array_equal(pos.numpy().view(np.uint32)[:total], hpos[:total])
    assert rid[0] == rid_base + 1  # the leading empty record took id rid_base


@pytest.mark.parametrize("k", [15, 31, 55])
def test_decode_block_ext_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    lengths = rng.integers(0, 3 * k, 40)
    lengths[5] = 0
    total = int(lengths.sum())
    n = -(-(total + 16) // 256) * 256
    buf = np.zeros(n, dtype=np.int8)
    buf[:total] = rng.integers(0, 4, total)
    packed = supermer.pack_codes_2bit(buf)
    lens = np.concatenate([lengths, np.zeros(9, np.int64)]).astype(np.int32)
    got = wire.decode_block_ext(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(lens), k, n, 17)
    want = jwire.decode_block_ext(jnp.asarray(packed), jnp.asarray(lens), k, n, 17)
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert np.array_equal(g.view(w.dtype) if g.dtype != w.dtype else g, w)
    host = fasta.flatten_for_device_ext(buf[:total], lengths, k, 256, 17)
    valid = host[1]
    assert np.array_equal(got[1].numpy(), valid)
    assert np.array_equal(got[2].numpy()[valid], host[2][valid])
    assert np.array_equal(got[3].numpy().view(np.uint32)[valid], host[3][valid])


@pytest.mark.parametrize("offset", [0, 123456])
def test_flatten_for_device_ext_matches_jax(offset):
    from hysortk_tpu.io import fasta as jfasta

    rng = np.random.default_rng(8)
    for lengths in (rng.integers(0, 80, 25), np.zeros(0, np.int64)):
        codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
        got = fasta.flatten_for_device_ext(codes, lengths, 31, 256, offset)
        want = jfasta.flatten_for_device_ext(codes, lengths, 31, 256, offset)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_decode_block_no_reads():
    codes, valid = wire.decode_block(
        torch.zeros(4, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 31, 64
    )
    assert codes.shape == (64,) and not valid.any()


def test_read_dna_buffer_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    reads = oracle.random_reads(rng, 30, 1, 200, "ACGTNacgtn")
    reads.append("")  # an empty record
    path = str(tmp_path / "reads.fa")
    _write_fasta(path, reads)
    assert os.path.getsize(path) < 10_000
    codes, lengths = hysortk_tpu_torch.read_dna_buffer(path)
    os.remove(path + ".fai")
    jcodes, jlengths = hysortk_tpu.read_dna_buffer(path)
    assert np.array_equal(codes, jcodes) and np.array_equal(lengths, jlengths)
    want = "".join(oracle.normalize(r) for r in reads)
    assert codes.tobytes() == fasta.CODE_LUT[np.frombuffer(want.encode(), np.uint8)].tobytes()
    # Shards tile the read set, as in the JAX facade.
    parts = [hysortk_tpu_torch.read_dna_buffer(path, s, 3) for s in range(3)]
    assert np.array_equal(np.concatenate([p[0] for p in parts]), codes)
    assert np.array_equal(np.concatenate([p[1] for p in parts]), lengths)


def _lists(k, n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (n, (k + 15) // 16), dtype=np.uint64).astype(np.uint32)
    r = k - 16 * (keys.shape[1] - 1)
    keys[:, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF)
    counts = rng.integers(1, 65536, n).astype(np.int32)
    return KmerList(keys, counts, k), JKmerList(keys, counts, k)


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("k,n", [(31, 5000), (17, 3), (55, 0)])
def test_writers_byte_identical(tmp_path, monkeypatch, k, n, native_lib):
    """Also on the numpy plain versions of the host library's formatter."""
    if not native_lib:
        monkeypatch.setattr(native, "available", lambda: False)
    ours, theirs = _lists(k, n, k + n)
    assert writer.format_output_lines(ours) == jwriter.format_output_lines(theirs)
    a = writer.write_output_file(ours, str(tmp_path / "port"), shard=2)
    b = jwriter.write_output_file(theirs, str(tmp_path / "jax"), shard=2)
    assert os.path.basename(a) == "2.out"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert writer.parse_output_files(str(tmp_path / "port")) == \
        jwriter.parse_output_files(str(tmp_path / "jax"))


def test_histogram_text_identical(capsys):
    hist = np.array([0, 5, 0, 7, 1, 0, 0, 2], dtype=np.int32)
    text = hysortk_tpu_torch.print_kmer_histogram(hist)
    assert capsys.readouterr().out == text
    assert text == jwriter.format_histogram(hist)
    assert writer.parse_histogram(text) == jwriter.parse_histogram(text) == {
        1: 5, 3: 7, 4: 1, 7: 2
    }
