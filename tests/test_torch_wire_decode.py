"""The wire decode (ops/wire.decode_block, decode_block_ext) on every case
of hysortk_tpu_torch.testing.wire_decode_cases: the plain versions against
the JAX package on the CPU, and the kernel (csrc/wire_decode.cu) against the
plain version on a card (`cuda` marker), one launch a case, strided rows
read in place. Seeded numpy inputs; the tolerance is exact equality of
every output at every position."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.ops import wire as jwire
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.ops import wire

CASES = testing.wire_decode_cases()
IDS = [case[0] for case in CASES]


def _tensors(case, device="cpu"):
    _, packed, lengths, k, n, rid_base = case
    return (torch.from_numpy(packed.view(np.int32)).to(device),
            torch.from_numpy(lengths).to(device), k, n, rid_base)


def _decode(packed, lengths, k, n, rid_base):
    if rid_base is None:
        return wire.decode_block(packed, lengths, k, n)
    return wire.decode_block_ext(packed[0], lengths[0], k, n, rid_base)


def _jax_decode(case):
    """The JAX package's decode, segment by segment, as numpy arrays (read
    ids and positions as int32 bit patterns)."""
    _, packed, lengths, k, n, rid_base = case
    if rid_base is not None:
        out = jwire.decode_block_ext(jnp.asarray(packed[0]), jnp.asarray(lengths[0]), k, n,
                                     rid_base)
        return [np.asarray(o).view(np.int32) if np.asarray(o).dtype == np.uint32
                else np.asarray(o) for o in out]
    parts = [jwire.decode_block(jnp.asarray(packed[s]), jnp.asarray(lengths[s]), k, n)
             for s in range(packed.shape[0])]
    return [np.concatenate([np.asarray(p[i]) for p in parts]) for i in range(2)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_decode_matches_jax(case):
    got = _decode(*_tensors(case))
    want = _jax_decode(case)
    assert [g.dtype for g in got] == [torch.int8, torch.bool, torch.int32,
                                      torch.int32][: len(got)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (case[1].shape[0] * case[4],)
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", [c for c in CASES if c[1].shape[0] == 1 and c[5] is None],
                         ids=[c[0] for c in CASES if c[1].shape[0] == 1 and c[5] is None])
def test_one_segment_forms_agree(case):
    """A (1, R) segment decodes as its 1-D form does."""
    packed, lengths, k, n, _ = _tensors(case)
    flat = wire.decode_block(packed[0], lengths[0], k, n)
    rows = wire.decode_block(packed, lengths, k, n)
    assert all(torch.equal(a, b) for a, b in zip(flat, rows))


def test_decode_rejects_what_the_kernel_does_not_take():
    packed = torch.zeros(4, dtype=torch.int32)
    lengths = torch.tensor([10, 20], dtype=torch.int32)
    with pytest.raises(TypeError):
        wire.decode_block(packed.to(torch.int64), lengths, 31, 64)
    with pytest.raises(ValueError):  # fewer words than bases
        wire.decode_block(packed, lengths, 31, 65)
    with pytest.raises(ValueError):  # extension mode takes one segment
        wire.decode_block_ext(packed[None], lengths[None], 31, 64, 0)
    with pytest.raises(ValueError):  # a row of lengths a row of words
        wire.decode_block(packed.view(2, 2), lengths[None], 31, 32)
    with pytest.raises(ValueError):
        wire.decode_block(packed.to("meta"), lengths.to("meta"), 31, 64)


def _tile_reads(lengths: np.ndarray, n: int) -> np.ndarray:
    """The reads (zero-length ones too) each decode tile's positions can
    lie in: from the read holding its first position to the one holding
    the next tile's, as the kernel stages them."""
    ends = np.cumsum(lengths.astype(np.int64))
    tile = testing.WIRE_DECODE_TILE
    firsts = np.arange(0, n + tile, tile)
    holder = np.minimum(np.searchsorted(ends, firsts, side="right"), lengths.size - 1)
    return holder[1:] - holder[:-1] + 1


def test_wire_decode_cases_reach_their_edges():
    """The new tiles' hard cases hold what their names say: a tile with more
    reads than it stages, read ends on tile, step, warp and word edges and
    beside them, rows of an odd number of words and lengths, and read ids
    that wrap past int32."""
    by_name = {c[0]: c for c in CASES}
    _, _, lengths, _, n, _ = by_name["over_stage"]
    per_tile = _tile_reads(lengths[0], n)
    assert per_tile.max() + 1 > testing.WIRE_DECODE_STAGED
    assert (per_tile + 1 <= testing.WIRE_DECODE_STAGED).sum() >= 2
    _, _, lengths, _, n, _ = by_name["thread_edges"]
    ends = set(np.cumsum(lengths[0]).tolist())
    t, step = testing.WIRE_DECODE_TILE, testing.WIRE_DECODE_STEP
    for edge in (t, 2 * t, t + step, t + 2 * step, t + 512):
        assert {edge - 1, edge, edge + 1} <= ends
    assert n > 2 * t
    _, packed, lengths, _, n, _ = by_name["odd_strides"]
    assert packed.shape[0] == 3 and packed.shape[1] % 2 == 1 and lengths.shape[1] % 2 == 1
    assert n > t
    _, _, lengths, _, n, rid_base = by_name["ext_rid_wrap"]
    assert rid_base + lengths.shape[1] > 2**31
    assert all(by_name[f"ext_{name}"][5] is not None
               for name in ("over_stage", "thread_edges", "cut", "stacked"))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_kernel_matches_plain(case):
    _cuda_or_skip()
    before = _build.launches["wire_decode"]
    got = _decode(*_tensors(case, "cuda"))
    torch.cuda.synchronize()
    assert _build.launches["wire_decode"] == before + (case[4] > 0)
    want = _decode(*_tensors(case))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["segments3", "odd_strides"])
def test_decode_kernel_reads_strided_segments(name):
    """The received exchange's form: each segment's words and lengths as
    views into one (S, 1, width) tensor, at odd word counts."""
    _cuda_or_skip()
    _, packed, lengths, k, n, _ = next(c for c in CASES if c[0] == name)
    nw = packed.shape[1]
    recv = torch.from_numpy(np.concatenate(
        [packed.view(np.int32), lengths], axis=1)[:, None, :].copy())
    want = wire.decode_block(recv[:, 0, :nw], recv[:, 0, nw:], k, n)
    recv = recv.cuda()
    got = wire.decode_block(recv[:, 0, :nw], recv[:, 0, nw:], k, n)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


RUNS_CASES = testing.decode_runs_cases()
RUNS_IDS = [case[0] for case in RUNS_CASES]


def _runs_tensors(case, device="cpu"):
    _, packed, lengths, rid0, pos0, k, n = case
    return (torch.from_numpy(packed.view(np.int32)).to(device),
            torch.from_numpy(lengths).to(device), torch.from_numpy(rid0).to(device),
            torch.from_numpy(pos0.view(np.int32)).to(device), k, n)


@pytest.mark.parametrize("case", RUNS_CASES, ids=RUNS_IDS)
def test_plain_decode_runs_matches_jax(case):
    """The run-header mode's plain version against the JAX package's
    decode_block + fill_run_meta, segment by segment, at every position."""
    _, packed, lengths, rid0, pos0, k, n = case
    got = wire.decode_block_runs(*_runs_tensors(case))
    assert [g.dtype for g in got] == [torch.int8, torch.bool, torch.int32, torch.int32]
    for s in range(packed.shape[0]):
        codes, valid = jwire.decode_block(jnp.asarray(packed[s]), jnp.asarray(lengths[s]), k, n)
        rid, pos = jwire.fill_run_meta(jnp.asarray(lengths[s]), jnp.asarray(rid0[s]),
                                       jnp.asarray(pos0[s]), n)
        part = slice(s * n, (s + 1) * n)
        for g, w in zip(got, (codes, valid, rid, pos)):
            w = np.asarray(w)
            assert np.array_equal(g[part].numpy(), w.view(np.int32) if w.dtype == np.uint32
                                  else w)


def test_decode_runs_cases_reach_their_edges():
    by_name = {c[0]: c for c in RUNS_CASES}
    assert {"fill_zero_pad", "fill_wrap", "wire_cut", "wire_no_reads", "wire_stacked",
            "wire_segments3", "wire_over_stage"} <= set(by_name)
    assert by_name["wire_no_reads"][2].shape[1] == 0
    _, _, lengths, _, _, _, n = by_name["wire_cut"]
    assert lengths.sum() > n
    _, _, lengths, _, _, _, n = by_name["fill_zero_pad"]
    assert (lengths[0, -9:] == 0).all() and lengths.sum() < n
    assert (by_name["fill_wrap"][4] >= 2**31).any()
    assert all((c[4] >= 2**31).any() for c in RUNS_CASES
               if c[0].startswith("wire_") and c[4].size >= 8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RUNS_CASES, ids=RUNS_IDS)
def test_decode_runs_kernel_matches_plain(case):
    """One launch a case, on contiguous rows and on the received exchange's
    form: words, lengths, rid0 and pos0 as views into one (S, 1, width)
    tensor."""
    _cuda_or_skip()
    want = wire.decode_block_runs(*_runs_tensors(case))
    before = _build.launches["wire_decode"]
    got = wire.decode_block_runs(*_runs_tensors(case, "cuda"))
    torch.cuda.synchronize()
    assert _build.launches["wire_decode"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    _, packed, lengths, rid0, pos0, k, n = case
    nw, r = packed.shape[1], lengths.shape[1]
    recv = torch.from_numpy(np.concatenate(
        [packed.view(np.int32), lengths, rid0, pos0.view(np.int32)],
        axis=1)[:, None, :].copy()).cuda()
    got = wire.decode_block_runs(recv[:, 0, :nw], recv[:, 0, nw: nw + r],
                                 recv[:, 0, nw + r: nw + 2 * r], recv[:, 0, nw + 2 * r:], k, n)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
