"""Extension mode of the port ((ReadId, PosInRead) payloads riding the sort:
count_flat_ext, count_reads_ext, count_reads_streaming_ext, the facade with
extension=True) against the JAX package's functions and a pure-Python oracle
of kmer -> (count, {(rid, pos)}). The port's sort is stable and the JAX sort
is not, so results compare by KmerListExt.as_dict() (sets), and keys, counts
and histogram exactly. Integer work: tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

import hysortk_tpu
import hysortk_tpu_torch
from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu import testing as oracle
from hysortk_tpu.runtime import scheduler as jsched
from hysortk_tpu_torch import config, pipeline, testing
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch.runtime import scheduler

KS = [15, 31, 55]


def _reads(seed, n=24, lo=0, hi=110, repeat=10):
    """Reads with Ns, lower case, reads shorter than k, two empty records,
    and repeats so that counts reach L."""
    rng = np.random.default_rng(seed)
    reads = oracle.random_reads(rng, n, lo, hi, "ACGTNacgt")
    reads[2] = ""
    reads[7] = ""
    return reads + reads[:repeat]


def _cfgs(k, **kw):
    fields = dict(k=k, m=min(17, k - 1), lower=2, upper=50, pad_multiple=256,
                  extension=True)
    fields.update(kw)
    j = hysortk_tpu.KmerConfig(**fields)
    return config.from_jax_fields(dataclasses.asdict(j)), j


def _oracle_ext(reads, k, lower, upper, rid0=0):
    occ = {}
    for r, read in enumerate(reads):
        s = testing.normalize(read)
        for i in range(len(s) - k + 1):
            occ.setdefault(testing.canonical(s[i:i + k]).encode(), set()).add(
                (r + rid0, i))
    return {km: (len(v), v) for km, v in occ.items() if lower <= len(v) <= upper}


def _assert_same(got, want):
    (gl, gh), (wl, wh) = got, want
    assert gl.keys.dtype == np.uint32 and gl.counts.dtype == np.int32
    assert np.array_equal(gl.keys, wl.keys)
    assert np.array_equal(gl.counts, wl.counts)
    assert np.array_equal(gh, wh)
    assert gl.as_dict() == wl.as_dict()


@pytest.mark.parametrize("k", KS)
def test_count_reads_ext_matches_jax_and_oracle(k):
    reads = _reads(k)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(k)
    got = pipeline.count_reads_ext(codes, lengths, cfg, read_id_offset=1000,
                                   device="cpu")
    want = jpipeline.count_reads_ext(codes, lengths, jcfg, read_id_offset=1000)
    _assert_same(got, want)
    kl = got[0]
    assert len(kl) > 0 and kl.as_dict() == _oracle_ext(reads, k, 2, 50, 1000)
    assert kl.pos[0].dtype == np.uint32 and kl.rid[0].dtype == np.int32
    assert all(p.size == c for p, c in zip(kl.pos, kl.counts))
    # Stable sort: each k-mer's occurrences in ascending (rid, pos).
    for r, p in zip(kl.rid, kl.pos):
        pairs = list(zip(r.tolist(), p.tolist()))
        assert pairs == sorted(pairs)


def test_count_flat_ext_matches_jax_filtered_and_unfiltered():
    k = 31
    reads = _reads(4)
    codes, lengths = fasta_io.reads_to_codes(reads)
    flat, valid, rid, pos = fasta_io.flatten_for_device_ext(codes, lengths, k, 256, 5)
    for kw in ({}, {"unfiltered": True}):
        cfg, jcfg = _cfgs(k, **kw)
        got = pipeline.count_flat_ext(flat, valid, rid, pos, cfg, device="cpu")
        want = jpipeline.count_flat_ext(flat, valid, rid, pos, jcfg)
        _assert_same(got, want)
    # Unfiltered keeps every k-mer, singletons too.
    assert got[0].as_dict() == _oracle_ext(reads, k, 1, 2**31 - 1, 5)
    assert (got[0].counts == 1).any()


@pytest.mark.parametrize("k", KS)
def test_streaming_ext_equals_one_shot_and_oracle(k):
    """Several batches (whole reads of ~700 bases each), a non-zero read id
    offset carried across them, the [L, U] filter on merged totals only."""
    reads = _reads(10 + k, n=40)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, _ = _cfgs(k)
    assert len(scheduler.read_batch_spans(lengths, 700)) >= 3
    got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 700,
                                              read_id_offset=77, device="cpu")
    want = pipeline.count_reads_ext(codes, lengths, cfg, read_id_offset=77,
                                    device="cpu")
    _assert_same(got, want)
    assert got[0].as_dict() == _oracle_ext(reads, k, 2, 50, 77) and len(got[0]) > 0


def test_streaming_ext_matches_jax_streaming():
    k = 31
    reads = _reads(3, n=40)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(k, upper=12)
    got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 700,
                                              read_id_offset=9, device="cpu")
    want = jsched.count_reads_streaming_ext(codes, lengths, jcfg, 700,
                                            read_id_offset=9)
    _assert_same(got, want)
    assert len(got[0]) > 0


def test_merge_ext_partials_matches_jax():
    """The same per-batch partials through both host merges."""
    k = 31
    cfg, _ = _cfgs(k, unfiltered=True)
    parts, jparts = [], []
    rid0 = 0
    for seed in (1, 2, 3):
        reads = _reads(seed, n=12, repeat=4) + _reads(1, n=8, repeat=0)
        codes, lengths = fasta_io.reads_to_codes(reads)
        kl, _ = pipeline.count_reads_ext(codes, lengths, cfg, rid0, device="cpu")
        parts.append(kl)
        jparts.append(jpipeline.KmerListExt(
            keys=kl.keys, counts=kl.counts, k=k, pos=kl.pos, rid=kl.rid))
        rid0 += lengths.size
    got = pipeline.merge_ext_partials(parts, 2, 6, k, 2)
    want = jpipeline.merge_ext_partials(jparts, 2, 6, k, 2)
    assert np.array_equal(got.keys, want.keys) and len(got) > 0
    assert np.array_equal(got.counts, want.counts)
    assert got.as_dict() == want.as_dict()
    empty = pipeline.merge_ext_partials([], 2, 6, k, 2)
    assert len(empty) == 0 and empty.keys.shape == (0, 2) and empty.pos == []


def test_split_occurrences_are_views():
    pos = np.arange(20, dtype=np.uint32)
    rid = np.arange(20, dtype=np.int32) * 2
    starts, counts = np.array([0, 5, 19]), np.array([2, 4, 1])
    pos_runs, rid_runs = pipeline.split_occurrences(starts, counts, pos, rid)
    assert [p.tolist() for p in pos_runs] == [[0, 1], [5, 6, 7, 8], [19]]
    assert [r.tolist() for r in rid_runs] == [[0, 2], [10, 12, 14, 16], [38]]
    assert all(p.base is pos for p in pos_runs)


@pytest.mark.parametrize("k", KS)
def test_facade_extension_matches_oracle(tmp_path, k):
    """read_dna_buffer -> kmer_count(extension=True) -> write_output_file:
    occurrences equal to the oracle, the output file that of the
    non-extension call."""
    reads = _reads(20 + k)
    path = str(tmp_path / "reads.fa")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j:j + 60] + "\n")
            if not r:
                f.write("\n")
    codes, lengths = hysortk_tpu_torch.read_dna_buffer(path)
    cfg, _ = _cfgs(k)
    kl, hist = hysortk_tpu_torch.kmer_count(codes, lengths, cfg, device="cpu")
    assert isinstance(kl, hysortk_tpu_torch.KmerListExt)
    assert kl.as_dict() == _oracle_ext(reads, k, 2, 50) and len(kl) > 0
    plain_cfg = dataclasses.replace(cfg, extension=False)
    pl, phist = hysortk_tpu_torch.kmer_count(codes, lengths, plain_cfg, device="cpu")
    assert np.array_equal(kl.keys, pl.keys) and np.array_equal(kl.counts, pl.counts)
    assert np.array_equal(hist, phist)
    ours = hysortk_tpu_torch.write_output_file(kl, str(tmp_path / "ext"))
    theirs = hysortk_tpu_torch.write_output_file(pl, str(tmp_path / "plain"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read() and data


def test_ext_empty_and_all_short_reads():
    cfg, _ = _cfgs(31)
    for reads in ([], ["ACGT", "", "TTTT"]):
        codes, lengths = fasta_io.reads_to_codes(reads)
        for kl, hist in (
            pipeline.count_reads_ext(codes, lengths, cfg, device="cpu"),
            scheduler.count_reads_streaming_ext(codes, lengths, cfg, 700,
                                                device="cpu"),
        ):
            assert len(kl) == 0 and kl.keys.shape == (0, 2) and hist.sum() == 0
            assert kl.pos == [] and kl.rid == []


def test_ext_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    codes, lengths = fasta_io.reads_to_codes(_reads(1))
    cfg, _ = _cfgs(31)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.count_reads_ext(codes, lengths, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        scheduler.count_reads_streaming_ext(codes, lengths, cfg, 700)
    with pytest.raises(RuntimeError, match="cuda"):
        hysortk_tpu_torch.kmer_count(codes, lengths, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_ext_on_cuda_matches_cpu(k):
    """On the card the extension path launches the three kernels of the
    one-shot path with payload rows, one-shot and streamed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hysortk_tpu_torch import _build

    reads = _reads(30 + k, n=200, hi=160, repeat=50)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, _ = _cfgs(k)
    want = pipeline.count_reads_ext(codes, lengths, cfg, 3, device="cpu")
    before = dict(_build.launches)
    got = pipeline.count_reads_ext(codes, lengths, cfg, 3, device="cuda")
    for name in ("keybuild", "radix_sort", "fused_count"):
        assert _build.launches[name] == before[name] + 1
    _assert_same(got, want)
    # Kernel and plain version are both stable: the lists agree in order too.
    for a, b in zip(got[0].pos + got[0].rid, want[0].pos + want[0].rid):
        assert np.array_equal(a, b)
    batches = len(scheduler.read_batch_spans(
        lengths, scheduler.snap_batch_to_pow2_flat(4000, cfg.pad_multiple)))
    before = dict(_build.launches)
    streamed = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 4000, 3,
                                                   device="cuda")
    assert _build.launches["radix_sort"] == before["radix_sort"] + batches
    _assert_same(streamed, want)
