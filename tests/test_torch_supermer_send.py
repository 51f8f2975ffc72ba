"""The supermer route's send side on the device against the host encoder and
the JAX package, on the CPU.

The device send side (parallel/supermer_route._device_send: the run table
and the segment pack of ops/supermer, their plain versions here, and the
torch bookkeeping between them) must build the very tensor that the host
path builds from the same share, `_segments(_encode(...))` (the JAX
package's encoder, which the port keeps as the reference), and its words
and columns those of the JAX package's own exchange arrays
(hysortk_tpu.parallel.supermer_route._prepare_exchange_arrays): every
testing.SUPERMER_KINDS case at K = 15, 31, 55 and 95, on 1, 2 and 4
destinations, extension mode off and on (with read id offsets, one of them
wrapping past 2^31), with and without segment dims pinned from below. The
run table equals hysortk_tpu.io.supermer.run_boundaries, on the encoder
cases and on testing.run_table_cases; the device heavy pre-count equals
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
    got, block_len, lmax = route._device_send(
        codes_d, valid_d, torch.from_numpy(shard_of), lens_d, cfg, num_dest, rid_offset,
        ext, CPU, None, min_dims)
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
    _need_cuda()
    _, valid, dest, m = case
    args = (torch.from_numpy(valid).cuda(), torch.from_numpy(dest).cuda(), m)
    before = _build.launches["supermer_runs"]
    got = supermer_ops.run_table(*args)
    torch.cuda.synchronize()
    assert _build.launches["supermer_runs"] == before + 1
    for g, w in zip(got, supermer_ops.run_table_plain(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w)


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
            starts, kmers, run_dest = supermer_ops.run_table(
                valid_d.cuda(), torch.from_numpy(dest).cuda(), supermer_ops.max_kmers(k))
            layout = supermer_ops.segment_layout(starts, kmers, run_dest, k, num_dest)
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
