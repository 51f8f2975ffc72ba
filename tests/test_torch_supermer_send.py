"""The supermer route's send side on the device against the host encoder and
the JAX package, on the CPU.

The device send side (parallel/supermer_route._device_send: the run layout
and the segment pack of ops/supermer, their plain versions here) must
build, from minimizer buckets and a bucket -> rank table, the very tensor
that the host
path builds from the same share, `_segments(_encode(...))` (the JAX
package's encoder, which the port keeps as the reference), and its words
and columns those of the JAX package's own exchange arrays
(hysortk_tpu.parallel.supermer_route._prepare_exchange_arrays): every
testing.SUPERMER_KINDS case at K = 15, 31, 55 and 95, on 1, 2 and 4
destinations, extension mode off and on (with read id offsets, one of them
wrapping past 2^31), with and without segment dims pinned from below. The
run table equals hysortk_tpu.io.supermer.run_boundaries, on the encoder
cases and on testing.run_table_cases; the run layout equals the layout
built from run_boundaries of the ranks assign[bucket] on every
testing.run_layout_cases case (the run-table cases at 1, 2, 4 and 257
destinations, some empty; caps at and across tile edges, a table of 9,000
buckets, 257 destinations, reads with zero-length reads); the device heavy
pre-count equals
hysortk_tpu.parallel.supermer_route.heavy_precount. One step of the route
calls neither the host flatten nor the host library's run boundaries and
run gather. Tolerance everywhere: exact equality.

The `cuda` tests hold each kernel against its plain version on the card;
they skip without one.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hysortk_tpu import KmerConfig as JKmerConfig
from hysortk_tpu.io import fasta as jfasta
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.parallel import dispatch as jdispatch
from hysortk_tpu.parallel import supermer_route as jroute
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.config import KmerConfig
from hysortk_tpu_torch.io import fasta, native
from hysortk_tpu_torch.io import supermer as supermer_io
from hysortk_tpu_torch.io.supermer import MAX_SUPERMER_LEN
from hysortk_tpu_torch.ops import supermer as supermer_ops
from hysortk_tpu_torch.ops import wire
from hysortk_tpu_torch.parallel import supermer_route as route
from hysortk_tpu_torch.pipeline import wire_batch

M_OF = {15: 7, 31: 17, 55: 13, 95: 17}
PAD = 256
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process: the send side's all-reduces
    (and the host reference's) run in it."""
    path = tmp_path_factory.mktemp("one_rank") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _share(kind: str, k: int, seed: int = 5):
    """An encoder case's reads as the rank's share: (codes, lengths int32)."""
    codes, lengths = fasta.reads_to_codes(testing.supermer_reads(kind, k, seed))
    return codes, lengths.astype(np.int32)


def _device_block(codes, lengths, k):
    """The share over the wire, decoded: (codes int8, valid, lengths, n)."""
    cfg = KmerConfig(k=k, m=M_OF[k], pad_multiple=PAD)
    packed, lens_d, n = wire_batch(codes, lengths, cfg, "cpu")
    codes_d, valid_d = wire.decode_block(packed, lens_d, k, n)
    return codes_d, valid_d, lens_d, n


SEND_CASES = [(kind, k, s, ext) for kind in testing.SUPERMER_KINDS
              for k in (15, 31, 55, 95) for s in (1, 2, 4) for ext in (False, True)]
SEND_IDS = [f"{kind}-k{k}-S{s}-{'ext' if ext else 'keys'}" for kind, k, s, ext in SEND_CASES]


@pytest.mark.parametrize("kind,k,num_dest,ext", SEND_CASES, ids=SEND_IDS)
def test_device_send_equals_host_segments(one_rank, kind, k, num_dest, ext):
    """The send tensor, block_len and lmax of the device send side equal
    `_segments(_encode(...))` on the same share bit for bit, and its
    packed words, lengths and (extension mode) headers are the JAX
    package's exchange arrays of that share. On 2 destinations the dims
    are pinned from below (min_dims); on 4 the extension-mode read id
    offset wraps past 2^31."""
    codes, lengths = _share(kind, k)
    cfg = KmerConfig(k=k, m=M_OF[k], pad_multiple=PAD, extension=ext)
    min_dims = (2 * 2048, 60) if num_dest == 2 else (0, 1)
    rid_offset = (2**31 - 5 if num_dest == 4 else 7) if ext else 0
    flat, valid = fasta.flatten_for_device(codes, lengths, k, PAD)
    shard_of = testing.supermer_case_dest(kind, flat.size, num_dest, 5)
    streams = route._encode(flat, valid, shard_of, cfg, num_dest, lengths, rid_offset, ext)
    want, want_bl, want_lmax = route._segments(streams, cfg, CPU, None, min_dims)

    codes_d, valid_d, lens_d, n = _device_block(codes, lengths, k)
    assert n == flat.size and np.array_equal(valid_d.numpy(), valid)
    # Buckets whose round-robin rank is shard_of: the send side maps them.
    bucket = shard_of + num_dest * np.random.default_rng(k).integers(0, 3, shard_of.size)
    assign = (np.arange(3 * num_dest) % num_dest).astype(np.int32)
    assert np.array_equal(assign[bucket], shard_of)
    got, block_len, lmax = route._device_send(
        codes_d, valid_d, torch.from_numpy(bucket.astype(np.int32)),
        torch.from_numpy(assign), lens_d, cfg, num_dest, rid_offset, ext, CPU, None,
        min_dims)
    assert (block_len, lmax) == (want_bl, want_lmax)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    if num_dest == 2:
        assert block_len >= min_dims[0] and lmax >= min_dims[1]

    jflat, jvalid = jfasta.flatten_for_device(codes, lengths, k, PAD)
    jcfg = JKmerConfig(k=k, m=M_OF[k], pad_multiple=PAD, extension=ext)
    packed, lens, rid0, pos0, jbl, jlmax = jroute._prepare_exchange_arrays(
        jflat, jvalid, shard_of, lengths, rid_offset, jcfg, num_dest, 1, False, ext,
        *min_dims)
    assert (jbl, jlmax) == (block_len, lmax)
    nw = block_len // 16
    seg = got.numpy()[:, 0]
    assert np.array_equal(seg[:, :nw].view(np.uint32), packed[0])
    assert np.array_equal(seg[:, nw: nw + lmax], lens[0])
    assert seg.shape[1] == nw + lmax * (3 if ext else 1)
    if ext:
        assert np.array_equal(seg[:, nw + lmax: nw + 2 * lmax], rid0[0])
        assert np.array_equal(seg[:, nw + 2 * lmax:].view(np.uint32), pos0[0])


PACK_CASES = testing.pack_cases()
PACK_IDS = [case[0] for case in PACK_CASES]
PACK_M = {15: 7, 31: 17}


def _pack_layout(case, device="cpu"):
    """A pack case's share over the wire, decoded, and its run layout (one
    bucket a destination): (codes, layout, dims, headers, lengths, n)."""
    _, codes, lengths, k, num_dest, dest, ext = case
    cfg = KmerConfig(k=k, m=PACK_M[k], pad_multiple=PAD)
    packed, lens_d, n = wire_batch(codes, lengths, cfg, device)
    codes_d, valid_d = wire.decode_block(packed, lens_d, k, n)
    shard_of = np.zeros(n, np.int32)
    shard_of[: dest.size] = dest
    layout = supermer_ops.run_layout(
        valid_d, torch.from_numpy(shard_of).to(device),
        torch.arange(num_dest, dtype=torch.int32, device=device), supermer_ops.max_kmers(k),
        k, num_dest)
    dims = supermer_ops.segment_dims(layout.cmax, layout.smax, PAD)
    headers = supermer_ops.run_headers(layout.src, lens_d, 2**31 - 5) if ext else ()
    return codes_d, layout, dims, headers, shard_of, n


@pytest.mark.parametrize("case", PACK_CASES, ids=PACK_IDS)
def test_pack_cases_match_jax(one_rank, case):
    """Each pack case's send tensor (the plain pack of the run layout) holds
    the JAX package's exchange arrays of the same share: its words, run
    lengths and (extension mode) read ids and positions, under its dims."""
    name, codes, lengths, k, num_dest, _, ext = case
    codes_d, layout, dims, headers, shard_of, n = _pack_layout(case)
    send = supermer_ops.pack_segments(codes_d, layout, *dims, headers)
    jcfg = JKmerConfig(k=k, m=PACK_M[k], pad_multiple=PAD, extension=ext)
    jflat, jvalid = jfasta.flatten_for_device(codes, lengths, k, PAD)
    assert jflat.size == n
    packed, lens, rid0, pos0, jbl, jlmax = jroute._prepare_exchange_arrays(
        jflat, jvalid, shard_of, lengths, 2**31 - 5 if ext else 0, jcfg, num_dest, 1, False,
        ext, 0, 1)
    assert (jbl, jlmax) == dims
    block_len, lmax = dims
    nw = block_len // 16
    seg = send.numpy()[:, 0]
    assert seg.shape == (num_dest, nw + lmax * (3 if ext else 1))
    assert np.array_equal(seg[:, :nw].view(np.uint32), packed[0])
    assert np.array_equal(seg[:, nw: nw + lmax], lens[0])
    if ext:
        assert np.array_equal(seg[:, nw + lmax: nw + 2 * lmax], rid0[0])
        assert np.array_equal(seg[:, nw + 2 * lmax:].view(np.uint32), pos0[0])


def test_pack_cases_reach_their_edges():
    """The pack cases hold what their names say, by their run layouts: run
    ends one base before, at and after pack tile edges and on word edges;
    runs of MAX_SUPERMER_LEN bases and runs cut from longer reads; runs at
    every source and segment offset mod 16; a destination without runs and
    a tile of padding only; 1, 4 and 64 destinations; a tile of more runs
    than it stages; extension mode."""
    tile, staged = testing.PACK_TILE, testing.PACK_STAGED
    by_name = {case[0]: case for case in PACK_CASES}
    layouts = {name: _pack_layout(case) for name, case in by_name.items()
               if not name.endswith("_ext")}

    def ends(name):
        lay = layouts[name][1]
        return set((lay.off + lay.bases.to(torch.int64)).tolist())

    assert {tile - 1, 2 * tile, 3 * tile + 1, 16 * 101, 16 * 700 + 1} <= ends("tile_edges")
    lay = layouts["max_len"][1]
    assert int(lay.bases.max()) == MAX_SUPERMER_LEN
    src_end = lay.src + lay.bases.to(torch.int64)
    assert bool((lay.src[1:] < src_end[:-1]).any())  # a cut: runs sharing bases
    lay = layouts["offsets"][1]
    assert set((lay.src % 16).tolist()) == set(range(16))
    assert set((lay.off % 16).tolist()) == set(range(16))
    lay, dims = layouts["skewed"][1], layouts["skewed"][2]
    runs_per = torch.diff(lay.dest_begin)
    assert int(runs_per[3]) == 0
    seg_len = torch.zeros(4, dtype=torch.int64).scatter_add_(
        0, torch.repeat_interleave(torch.arange(4), runs_per), lay.bases.to(torch.int64))
    assert int(seg_len[1:3].max()) + tile <= dims[0]  # a tile of padding only
    assert {layouts[name][1].dest_begin.numel() - 1 for name in layouts} == {1, 4, 64}
    assert int((torch.diff(layouts["dests64"][1].dest_begin) == 0).sum()) >= 1
    lay = layouts["short_runs"][1]
    first_tile = int(((lay.off < tile) & (lay.off + lay.bases.to(torch.int64) > 0))[
        lay.dest_begin[0]: lay.dest_begin[1]].sum())
    assert first_tile > staged
    assert [case[6] for case in PACK_CASES].count(True) == 3


def _run_table_np(valid, dest, k):
    """The run table on CPU tensors as numpy: (starts, bases, dest)."""
    starts, kmers, run_dest = supermer_ops.run_table(
        torch.from_numpy(valid), torch.from_numpy(dest), supermer_ops.max_kmers(k))
    assert starts.dtype == torch.int64 and kmers.dtype == torch.int32
    assert run_dest.dtype == torch.int32
    return starts.numpy(), kmers.numpy().astype(np.int64) + k - 1, run_dest.numpy()


@pytest.mark.parametrize("kind", testing.SUPERMER_KINDS)
@pytest.mark.parametrize("k", [15, 31, 55, 95])
@pytest.mark.parametrize("num_dest", [1, 2, 4])
def test_run_table_matches_jax(kind, k, num_dest):
    """The run table equals the JAX package's run_boundaries on the flat
    stream of every encoder case; every run within MAX_SUPERMER_LEN."""
    codes, lengths = _share(kind, k)
    flat, valid = fasta.flatten_for_device(codes, lengths, k, PAD)
    dest = testing.supermer_case_dest(kind, flat.size, num_dest, 5)
    got = _run_table_np(valid, dest, k)
    want = jsupermer.run_boundaries(valid, dest, k)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[1] <= supermer_ops.MAX_SUPERMER_LEN).all()


@pytest.mark.parametrize("case", testing.run_table_cases(), ids=lambda c: c[0])
def test_run_table_hard_cases(case):
    """The run table's hard cases against the port's numpy plain version
    (io/supermer.run_boundaries_plain) and the JAX package's
    run_boundaries (at the k whose cap is the case's max_kmers)."""
    _, valid, dest, m = case
    starts, kmers, run_dest = supermer_ops.run_table(
        torch.from_numpy(valid), torch.from_numpy(dest), m)
    want = supermer_io.run_boundaries_plain(valid, dest, m)
    assert np.array_equal(starts.numpy(), want[0])
    assert np.array_equal(kmers.numpy(), want[1])
    assert np.array_equal(run_dest.numpy(), want[2])
    k = supermer_ops.MAX_SUPERMER_LEN + 1 - m
    jstarts, jbases, jdest = jsupermer.run_boundaries(valid, dest, k)
    assert np.array_equal(starts.numpy(), jstarts)
    assert np.array_equal(kmers.numpy() + k - 1, jbases)
    assert np.array_equal(run_dest.numpy(), jdest)


def test_run_table_checks_its_inputs():
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        supermer_ops.run_table(valid, torch.zeros(8, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        supermer_ops.run_table(valid, torch.zeros(7, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        supermer_ops.run_table(valid, torch.zeros(8, dtype=torch.int32), 0)


LAYOUT_CASES = testing.run_layout_cases()
LAYOUT_K = 31


def _jax_layout(valid, bucket, assign, m, k, num_dest):
    """The layout built from the JAX package's run_boundaries of the ranks
    assign[bucket]: the runs grouped by rank in flat order, each run's
    offset the bases of its rank's runs before it. (src, off, bases,
    dest_begin, cmax, smax)."""
    ranks = np.where(valid, assign[np.where(valid, bucket, 0)], 0)
    k_jax = supermer_ops.MAX_SUPERMER_LEN + 1 - m  # run_boundaries caps at m k-mers
    starts, jbases, rdest = jsupermer.run_boundaries(valid, ranks, k_jax)
    kmers = np.asarray(jbases, np.int64) - (k_jax - 1)
    order = np.argsort(rdest, kind="stable")
    bases = kmers[order] + k - 1
    rdest = np.asarray(rdest, np.int64)[order]
    runs_per = np.bincount(rdest, minlength=num_dest)
    bases_per = np.bincount(rdest, weights=bases, minlength=num_dest).astype(np.int64)
    dest_begin = np.concatenate([[0], np.cumsum(runs_per)])
    off = np.cumsum(bases) - bases - (np.cumsum(bases_per) - bases_per)[rdest]
    return (np.asarray(starts, np.int64)[order], off, bases, dest_begin,
            int(bases_per.max(initial=0)), int(runs_per.max(initial=0)))


def _layout_fields(layout):
    return (layout.src, layout.off, layout.bases, layout.dest_begin, layout.cmax,
            layout.smax)


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: c[0])
def test_run_layout_matches_jax(case):
    """The run layout (its plain composition on the CPU) equals, field by
    field, the layout of the JAX package's run_boundaries of the ranks
    assign[bucket]."""
    _, valid, bucket, assign, m, num_dest = case
    got = supermer_ops.run_layout(torch.from_numpy(valid), torch.from_numpy(bucket),
                                  torch.from_numpy(assign), m, LAYOUT_K, num_dest)
    assert got.src.dtype == got.off.dtype == got.dest_begin.dtype == torch.int64
    assert got.bases.dtype == torch.int32 and got.dest_begin.shape == (num_dest + 1,)
    want = _jax_layout(valid, bucket, assign, m, LAYOUT_K, num_dest)
    for g, w in zip(_layout_fields(got)[:4], want[:4]):
        assert np.array_equal(g.numpy(), w)
    assert (got.cmax, got.smax) == want[4:]


def test_run_layout_cases_reach_their_edges():
    """Empty destinations, a table past the kernel's shared-memory one, a
    cap on a tile edge, one run over two tile edges."""
    cases = {c[0]: c for c in LAYOUT_CASES}
    _, valid, bucket, assign, m, d = cases["random-S257"]
    ranks = assign[bucket[valid]]
    assert d == 257 and np.unique(ranks).size < 257
    _, valid, bucket, assign, m, d = cases["random-S4"]
    assert 2 not in set(assign[bucket[valid]].tolist())
    assert cases["buckets"][3].size > 8192
    starts = supermer_io.run_boundaries_plain(*cases["cap_edge"][1:2],
                                              np.zeros(cases["cap_edge"][1].size, np.int32),
                                              cases["cap_edge"][4])[0]
    tile = testing.RUN_TABLE_TILE
    assert {tile - 1, 2 * tile, 3 * tile + 1} <= set(starts.tolist())
    _, valid, _, _, m, _ = cases["cap_two_edges"]
    assert m > 2 * tile and valid.all()


def test_run_layout_checks_its_inputs():
    valid = torch.ones(8, dtype=torch.bool)
    bucket = torch.zeros(8, dtype=torch.int32)
    assign = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        supermer_ops.run_layout(valid, bucket, assign.to(torch.int64), 4, 31, 1)
    with pytest.raises(ValueError):
        supermer_ops.run_layout(valid, bucket[:7], assign, 4, 31, 1)
    with pytest.raises(ValueError):
        supermer_ops.run_layout(valid, bucket, assign, 4, 31, 0)
    with pytest.raises(ValueError):
        supermer_ops.run_layout(valid, bucket, assign, 4, 31, supermer_ops.MAX_DEST + 1)


@pytest.mark.parametrize("k", [15, 31, 95])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_heavy_precount_device_matches_jax(k, num_shards):
    """The device heavy pre-count (key build over the heavy mask, one radix
    sort with the owner as payload, one fused count) equals the JAX
    package's heavy_precount: the valid mask without the heavy positions,
    and per owner rank the ascending keys (the dominant one with its top
    bit set) and their counts."""
    codes, lengths = _share("heavy_top_bit", k)
    flat, valid = fasta.flatten_for_device(codes, lengths, k, PAD)
    nb = num_shards * 3
    dest = route.host_destinations(flat, k, M_OF[k], nb, device="cpu")
    sizes = np.bincount(dest[valid], minlength=nb).astype(np.int64)
    types = jdispatch.classify(sizes, 2.3)
    assert (types == jdispatch.HEAVY).any()
    assign = jdispatch.balanced_assignment(np.where(types == 1, 0, sizes), num_shards)
    got_valid, got = route.heavy_precount_device(
        torch.from_numpy(flat), torch.from_numpy(valid), torch.from_numpy(dest),
        types, torch.from_numpy(assign.astype(np.int32)), k, num_shards)
    want_valid, want = jroute.heavy_precount(flat, valid, dest, types, assign, k,
                                             num_shards)
    assert np.array_equal(got_valid.numpy(), want_valid)
    assert len(got) == len(want) == num_shards
    for (gk, gc), (wk, wc) in zip(got, want):
        assert gk.dtype == np.uint32 and gc.dtype == np.int64
        assert gk.shape == wk.shape and np.array_equal(gk, wk)
        assert np.array_equal(gc, wc)
    top = max(got, key=lambda e: e[1].max() if e[1].size else 0)
    assert top[1].max() >= 1500 and top[0][np.argmax(top[1]), 0] >= 2**31


@pytest.mark.parametrize("ext", [False, True])
def test_step_runs_no_host_encoder(one_rank, monkeypatch, ext):
    """One step on the CPU (a heavy bucket flagged where the classifier
    runs) feeds the wire and nothing else of the host encoder: no host
    flatten, no host heavy pre-count, no host encoder or segment pack, no
    run boundaries or run gather in the host library; the wire's 2-bit
    pack is the library's one call. The step's count equals kmer_count's."""
    import hysortk_tpu_torch as ht

    def refuse(name):
        def raise_(*args, **kwargs):
            raise AssertionError(f"{name} was called")
        return raise_

    for mod, name in ((fasta, "flatten_for_device"), (route, "heavy_precount"),
                      (route, "_encode"), (route, "_segments"),
                      (supermer_io, "encode_supermer_streams"),
                      (supermer_io, "encode_supermer_streams_ext")):
        monkeypatch.setattr(mod, name, refuse(name))
    codes, lengths = _share("heavy_top_bit", 31)
    cfg = KmerConfig(k=31, m=17, lower=1, upper=2**15, pad_multiple=PAD,
                     routing="supermer", extension=ext)
    native.reset_calls()
    step = route._supermer_step(codes, lengths, cfg, None, CPU, read_id_offset=3)
    assert native.calls["run_boundaries"] == native.calls["gather_runs"] == 0
    assert native.calls["pack_2bit"] == (1 if native.available() else 0)
    assert (step.heavy is not None) == (not ext)
    kept = int(step.keep.sum()) + (int(step.heavy[0][1].size) if step.heavy else 0)
    want, _ = ht.kmer_count(codes, lengths, KmerConfig(k=31, m=17, lower=1, upper=2**15),
                            device="cpu")
    assert kept == len(want.keys)


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version.


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.run_table_cases(), ids=lambda c: c[0])
def test_run_table_kernel_matches_plain(case):
    """The run-table cases through the run-layout kernel (the identity
    table: a bucket a rank), equal to the plain composition; one launch."""
    _need_cuda()
    _, valid, dest, m = case
    num_dest = int(dest.max()) + 1
    args = (torch.from_numpy(valid).cuda(), torch.from_numpy(dest).cuda(),
            torch.arange(num_dest, dtype=torch.int32).cuda(), m, LAYOUT_K, num_dest)
    before = _build.launches["supermer_runs"]
    got = supermer_ops.run_layout(*args)
    torch.cuda.synchronize()
    assert _build.launches["supermer_runs"] == before + 1
    want = supermer_ops.run_layout_plain(*args)
    for g, w in zip(_layout_fields(got), _layout_fields(want)):
        assert g == w if isinstance(g, int) else (g.dtype == w.dtype and torch.equal(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: c[0])
def test_run_layout_kernel_matches_plain(case):
    """The run-layout kernel against its plain composition, field by field;
    one launch."""
    _need_cuda()
    _, valid, bucket, assign, m, num_dest = case
    args = (torch.from_numpy(valid).cuda(), torch.from_numpy(bucket).cuda(),
            torch.from_numpy(assign).cuda(), m, LAYOUT_K, num_dest)
    before = _build.launches["supermer_runs"]
    got = supermer_ops.run_layout(*args)
    torch.cuda.synchronize()
    assert _build.launches["supermer_runs"] == before + 1
    want = supermer_ops.run_layout_plain(*args)
    for g, w in zip(_layout_fields(got), _layout_fields(want)):
        assert g == w if isinstance(g, int) else (g.dtype == w.dtype and torch.equal(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACK_CASES, ids=PACK_IDS)
def test_pack_kernel_matches_plain_on_pack_cases(case):
    """Each pack case: one launch of the pack kernel, equal to the plain
    version on the same CUDA tensors."""
    _need_cuda()
    codes_d, layout, dims, headers, _, _ = _pack_layout(case, "cuda")
    before = _build.launches["supermer_pack"]
    got = supermer_ops.pack_segments(codes_d, layout, *dims, headers)
    torch.cuda.synchronize()
    assert _build.launches["supermer_pack"] == before + 1
    assert torch.equal(got, supermer_ops.pack_segments_plain(codes_d, layout, *dims, headers))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", testing.SUPERMER_KINDS)
@pytest.mark.parametrize("ext", [False, True])
def test_pack_kernel_matches_plain(kind, ext):
    _need_cuda()
    for k in (15, 95):
        for num_dest in (1, 4):
            codes, lengths = _share(kind, k)
            codes_d, valid_d, lens_d, n = _device_block(codes, lengths, k)
            dest = testing.supermer_case_dest(kind, n, num_dest, 5)
            layout = supermer_ops.run_layout(
                valid_d.cuda(), torch.from_numpy(dest).cuda(),
                torch.arange(num_dest, dtype=torch.int32).cuda(),
                supermer_ops.max_kmers(k), k, num_dest)
            block_len, lmax = supermer_ops.segment_dims(layout.cmax, layout.smax, PAD,
                                                        (0, 1))
            headers = (supermer_ops.run_headers(layout.src, lens_d.cuda(), 2**31 - 3)
                       if ext else ())
            before = _build.launches["supermer_pack"]
            got = supermer_ops.pack_segments(codes_d.cuda(), layout, block_len, lmax,
                                             headers)
            torch.cuda.synchronize()
            assert _build.launches["supermer_pack"] == before + 1
            want = supermer_ops.pack_segments_plain(codes_d.cuda(), layout, block_len,
                                                    lmax, headers)
            assert torch.equal(got, want)
