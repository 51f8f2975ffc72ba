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


# ---------------------------------------------------------------------------
# Flat occurrence storage


@pytest.mark.parametrize("offset", [0, 17])
def test_count_reads_ext_read_id_offset_matches_jax(offset):
    """The wire-fed one-shot call: read ids from the device's scan of the
    read lengths, counted from read_id_offset, as the JAX host flatten
    gives them."""
    reads = _reads(40 + offset)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(31)
    got = pipeline.count_reads_ext(codes, lengths, cfg, offset, device="cpu")
    want = jpipeline.count_reads_ext(codes, lengths, jcfg, read_id_offset=offset)
    _assert_same(got, want)
    assert got[0].as_dict() == _oracle_ext(reads, 31, 2, 50, offset)
    assert int(got[0].occ_rid.min()) >= offset


def test_count_reads_ext_builds_no_host_flatten(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("flatten_for_device_ext was called")

    monkeypatch.setattr(fasta_io, "flatten_for_device_ext", refuse)
    codes, lengths = fasta_io.reads_to_codes(_reads(5))
    cfg, jcfg = _cfgs(31)
    got = pipeline.count_reads_ext(codes, lengths, cfg, 3, device="cpu")
    monkeypatch.undo()
    _assert_same(got, jpipeline.count_reads_ext(codes, lengths, jcfg, read_id_offset=3))


def test_occurrences_are_views_of_the_flat_storage():
    codes, lengths = fasta_io.reads_to_codes(_reads(6))
    cfg, _ = _cfgs(31)
    kl, _ = pipeline.count_reads_ext(codes, lengths, cfg, device="cpu")
    n_occ = int(kl.counts.sum())
    assert kl.occ_rid.dtype == np.int32 and kl.occ_pos.dtype == np.uint32
    assert kl.offsets.dtype == np.int64 and kl.offsets.shape == (len(kl) + 1,)
    assert kl.offsets[0] == 0 and kl.offsets[-1] == n_occ == kl.occ_rid.size
    assert np.array_equal(np.diff(kl.offsets), kl.counts)
    for j in (0, len(kl) // 2, len(kl) - 1):
        assert np.shares_memory(kl.pos[j], kl.occ_pos)
        assert np.shares_memory(kl.rid[j], kl.occ_rid)
        a, b = kl.offsets[j], kl.offsets[j + 1]
        assert np.array_equal(kl.pos[j], kl.occ_pos[a:b])
        assert np.array_equal(kl.rid[-len(kl) + j], kl.occ_rid[a:b])
    assert len(kl.pos) == len(kl.rid) == len(kl)
    assert [p.size for p in kl.pos] == kl.counts.tolist()
    sub = kl.pos[1::3]
    assert len(sub) == len(range(1, len(kl), 3))
    assert all(np.shares_memory(p, kl.occ_pos) for p in sub if p.size)
    with pytest.raises(IndexError):
        kl.pos[len(kl)]


def test_list_and_flat_constructors_agree():
    codes, lengths = fasta_io.reads_to_codes(_reads(7))
    cfg, _ = _cfgs(31)
    kl, _ = pipeline.count_reads_ext(codes, lengths, cfg, 4, device="cpu")
    lists = pipeline.KmerListExt(kl.keys, kl.counts, kl.k,
                                 pos=[p.copy() for p in kl.pos],
                                 rid=[r.astype(np.int64) for r in kl.rid])
    flat = pipeline.KmerListExt.from_flat(kl.keys, kl.counts, kl.k,
                                          kl.occ_rid.copy(), kl.occ_pos.copy())
    assert lists.as_dict() == flat.as_dict() == kl.as_dict()
    assert lists.occ_rid.dtype == np.int32 and lists.occ_pos.dtype == np.uint32
    assert np.array_equal(lists.offsets, flat.offsets)
    assert lists.pos == kl.pos and lists.rid == kl.rid
    with pytest.raises(ValueError):
        pipeline.KmerListExt(kl.keys, kl.counts, kl.k)


def _partial(reads, cfg, rid0):
    codes, lengths = fasta_io.reads_to_codes(reads)
    return pipeline.count_reads_ext(codes, lengths, cfg, rid0, device="cpu")[0]


@pytest.mark.parametrize("k", [15, 31, 55])
@pytest.mark.parametrize("kind", ["empty", "single", "all_filtered", "overlapping"])
def test_merge_ext_partials_cases_match_jax(kind, k):
    """The flat merge against the JAX merge of the same partials: none,
    one, partials whose merged totals all fall outside [L, U], partials that
    share most keys; at one key word (k=15), two (the packed-key order) and
    four (np.lexsort)."""
    cfg, _ = _cfgs(k, unfiltered=True)
    base = _reads(k + 1, n=14, lo=k, hi=140, repeat=0)
    empty_p = _partial([], cfg, 0)
    if kind == "empty":
        parts = [empty_p, empty_p]
    elif kind == "single":
        parts = [empty_p, _partial(base + base[:4], cfg, 0)]
    elif kind == "all_filtered":
        parts = [_partial(base, cfg, 0), _partial(base, cfg, 100), empty_p]
    else:
        parts = [_partial(base + base[:5], cfg, 0), empty_p,
                 _partial(base[3:] + base[:2], cfg, 200), _partial(base, cfg, 400)]
    lower, upper = (5, 9) if kind == "all_filtered" else (2, 6)
    jparts = [jpipeline.KmerListExt(keys=p.keys, counts=p.counts, k=k,
                                    pos=list(p.pos), rid=list(p.rid)) for p in parts]
    words = cfg.words
    got = pipeline.merge_ext_partials(parts, lower, upper, k, words)
    want = jpipeline.merge_ext_partials(jparts, lower, upper, k, words)
    assert got.keys.shape == want.keys.shape and got.keys.shape[1] == words
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts) and got.counts.dtype == np.int32
    assert got.as_dict() == want.as_dict()
    assert np.array_equal(np.diff(got.offsets), got.counts)
    assert (len(got) == 0) == (kind in ("empty", "all_filtered"))
    if kind == "all_filtered":
        assert got.offsets.tolist() == [0] and got.occ_rid.size == 0


@pytest.mark.parametrize("k", [31, 55])
def test_streaming_ext_merge_matches_jax_at_widths(k):
    """count_reads_streaming_ext in several batches (whole reads; batch
    partials overlap in keys) against the JAX stream: two key words and
    four."""
    reads = _reads(50 + k, n=40, lo=k - 5, hi=160, repeat=16)
    codes, lengths = fasta_io.reads_to_codes(reads)
    cfg, jcfg = _cfgs(k, upper=20)
    assert len(scheduler.read_batch_spans(lengths, 900)) >= 3
    got = scheduler.count_reads_streaming_ext(codes, lengths, cfg, 900,
                                              read_id_offset=11, device="cpu")
    want = jsched.count_reads_streaming_ext(codes, lengths, jcfg, 900,
                                            read_id_offset=11)
    _assert_same(got, want)
    assert len(got[0]) > 0


def test_key_order_is_lexsort_order():
    """The packed-key sort gives np.lexsort's stable unsigned order
    (top-bit words, ties across entries) at one and two words, and the
    group heads where the key changes."""
    rng = np.random.default_rng(3)
    for w in (1, 2, 3):
        keys = rng.integers(0, 4, (5000, w)).astype(np.uint32) * np.uint32(0x7FFFFFFF)
        want = np.lexsort(tuple(keys[:, i] for i in range(w - 1, -1, -1)))
        order, head = pipeline._key_order(keys)
        assert np.array_equal(order, want)
        keys_s = keys[want]
        assert np.array_equal(head[1:], (keys_s[1:] != keys_s[:-1]).any(axis=1))
        assert head[0] and head.sum() == len(np.unique(keys, axis=0))
