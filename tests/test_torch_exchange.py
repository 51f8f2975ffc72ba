"""The port's range-exchange pieces against the JAX package on the CPU: the
segment offsets of sorted mixed keys, pack_sorted_ranges, mask_invalid_slots,
the receive-side merge by run bounds, and all_to_all_exchange on 2 and 4
gloo ranks (spawned processes, results through tmp_path) against the JAX
exchange on a mesh of as many virtual CPU devices. Integer work: exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from hysortk_tpu.ops import merge as jmerge
from hysortk_tpu.ops import mixkey as jmixkey
from hysortk_tpu.ops import sort as jsort
from hysortk_tpu.ops import spill as jspill
from hysortk_tpu.parallel import exchange as jexchange
from hysortk_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.ops import merge, mixkey
from hysortk_tpu_torch.parallel import exchange
from hysortk_tpu_torch.parallel import pipeline as sharded
from hysortk_tpu_torch.parallel.spawn import spawn_ranks

SPAWN_TIMEOUT = 120  # seconds for a few small collectives on 4 ranks


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _sorted_mixed(rng, n: int, n_words: int, n_sentinel: int) -> np.ndarray:
    """(n_words, n) mixed keys sorted ascending, duplicates, a key whose
    first word is all ones (not the sentinel) and a sentinel tail."""
    keys = rng.integers(0, 2**32, (n - n_sentinel, n_words),
                        dtype=np.uint64).astype(np.uint32)
    keys[rng.integers(0, keys.shape[0], keys.shape[0] // 4)] = keys[0]
    mixed = jmixkey.mix_keys_np(keys)
    if n_words > 1:
        mixed[1, 0] = 0xFFFFFFFF
        mixed[1, 1:] = 5
    mixed = mixed[np.lexsort(mixed.T[::-1])]
    full = np.full((n_sentinel, n_words), 0xFFFFFFFF, np.uint32)
    return np.concatenate([mixed, full]).T.copy()


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_segment_offsets_match_jax(num_shards, n_words):
    """The S - 1 inner boundaries searched in the unsigned first word (a
    plain signed search would misplace the top-bit half), then n_valid."""
    rng = np.random.default_rng(num_shards * 10 + n_words)
    words = _sorted_mixed(rng, 3000, n_words, 77)
    got = sharded._segment_offsets(
        [_t(w) for w in words], torch.tensor(3000 - 77), num_shards)
    jw = [jnp.asarray(w) for w in words]
    bnd = jmixkey.range_boundaries(num_shards)[1:-1].astype(np.uint32)
    inner = jnp.searchsorted(jw[0], jnp.asarray(bnd), side="left")
    n_valid = jnp.sum(jsort.sentinel_valid(jw).astype(jnp.int32))
    want = np.concatenate([[0], np.asarray(inner), [int(n_valid)]])
    assert np.array_equal(got.numpy(), want)
    assert (words[0] >= 0x80000000).sum() > 1000
    if n_words > 1:  # the all-ones first word lies in the last segment
        last = np.flatnonzero((words[0] == 0xFFFFFFFF) & (words[1] != 0xFFFFFFFF))
        assert last.size and want[-2] <= last.min() < want[-1]


@pytest.mark.parametrize("num_shards,capacity", [(1, 3100), (2, 1600), (3, 900),
                                                 (4, 700), (4, 200), (8, 64)])
def test_pack_sorted_ranges_matches_jax(num_shards, capacity):
    """Every slot of the send blocks, the pad past the rows' end included,
    the counts and the overflow flag."""
    rng = np.random.default_rng(capacity)
    n = 3000
    words = _sorted_mixed(rng, n, 2, 100)
    payload = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    inner = np.sort(rng.integers(0, n - 100, num_shards - 1))
    offsets = np.concatenate([[0], inner, [n - 100]]).astype(np.int64)
    send, counts, overflow = exchange.pack_sorted_ranges(
        [_t(w) for w in words], [_t(payload)], offsets, num_shards, capacity)
    jw, jp, jcounts, joverflow = jexchange.pack_sorted_ranges(
        [jnp.asarray(w) for w in words], [jnp.asarray(payload)],
        jnp.asarray(offsets, jnp.int32), num_shards, capacity)
    assert send.shape == (num_shards, 3, capacity)
    for r, want in enumerate(list(jw) + list(jp)):
        assert np.array_equal(send[:, r].numpy().view(np.uint32), np.asarray(want))
    assert np.array_equal(counts, np.asarray(jcounts))
    assert overflow == bool(joverflow)


def test_mask_invalid_slots_matches_jax():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**32, (2, 4, 50), dtype=np.uint64).astype(np.uint32)
    counts = np.array([0, 17, 50, 3])
    valid = np.arange(50)[None, :] < counts[:, None]
    got = exchange.mask_invalid_slots([_t(r) for r in rows], torch.from_numpy(valid))
    want = jexchange.mask_invalid_slots([jnp.asarray(r) for r in rows],
                                        jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


@pytest.mark.parametrize("num_shards,capacity", [(2, 640), (3, 1000), (4, 333), (8, 129)])
def test_receive_merge_by_bounds_matches_jax(num_shards, capacity):
    """The S received rows merged by their bounds equal the JAX receive
    side (each run padded to 2m with sentinels, the run count to a power of
    two, one pow2 merge) on every slot of theirs that is not pad; the pad
    is sentinel. The count row compares as per-key sums (the JAX merge is
    unstable), the sentinel's aside: its slots carry no weight."""
    rng = np.random.default_rng(num_shards)
    runs, pays = [], []
    for s in range(num_shards):
        fill = int(rng.integers(0, capacity + 1)) if s else capacity
        run = np.full((2, capacity), 0xFFFFFFFF, np.uint32)
        run[:, :fill] = _sorted_mixed(rng, fill + 1, 2, 1)[:, :fill]
        runs.append(run)
        pays.append(rng.integers(1, 100, capacity).astype(np.uint32))
    rows = np.stack(runs, axis=1)  # (2, S, capacity)
    pay = np.stack(pays)
    got = merge.merge_runs_at(
        [_t(r.reshape(-1)) for r in rows] + [_t(pay.reshape(-1))], 2,
        range(0, (num_shards + 1) * capacity, capacity))
    m, sc = jspill.split_capacity(capacity)
    run = 2 * m if sc else m
    s2 = 1 << (num_shards - 1).bit_length()
    pad_w = np.full((2, s2, run), 0xFFFFFFFF, np.uint32)
    pad_w[:, :num_shards, :capacity] = rows
    pad_p = np.zeros((s2, run), np.uint32)
    pad_p[:num_shards, :capacity] = pay
    want = jmerge.merge_sorted_runs(
        [jnp.asarray(r.reshape(-1)) for r in pad_w] + [jnp.asarray(pad_p.reshape(-1))],
        2, run)
    want = [np.asarray(w) for w in want]
    n = num_shards * capacity
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy().view(np.uint32), w[:n])
        assert (w[n:] == 0xFFFFFFFF).all()
    keys = np.stack([w[:n] for w in want[:2]], axis=-1)

    def sums(pay_row):
        out = {}
        for key, p in zip(map(tuple, keys.tolist()), pay_row.tolist()):
            out[key] = out.get(key, 0) + p
        out.pop((0xFFFFFFFF, 0xFFFFFFFF), None)  # sentinel slots weigh nothing
        return out

    assert sums(got[2].numpy().view(np.uint32)) == sums(want[2][:n])


def _send_buffers(num_shards: int, capacity: int, seed: int):
    rng = np.random.default_rng(seed)
    send = rng.integers(-2**31, 2**31, (num_shards, num_shards, 3, capacity),
                        dtype=np.int64).astype(np.int32)
    counts = rng.integers(0, capacity + 1, (num_shards, num_shards)).astype(np.int64)
    return send, counts


@pytest.mark.parametrize("num_shards", [2, 4])
def test_all_to_all_exchange_matches_jax(tmp_path, num_shards):
    """Block s of rank r's receive buffer is block r of rank s's send
    buffer, all rows in one collective; the counts and the valid mask as
    the JAX all_to_all gives them on a mesh of the same size."""
    capacity = 37
    send, counts = _send_buffers(num_shards, capacity, num_shards)
    inputs = str(tmp_path / "in.npz")
    np.savez(inputs, **{f"send_{r}": send[r] for r in range(num_shards)},
             **{f"counts_{r}": counts[r] for r in range(num_shards)})
    job = dict(name="a2a", kind="exchange", inputs=inputs)
    spawn_ranks(testing.run_rank_jobs, num_shards, ([job], str(tmp_path)),
                workdir=str(tmp_path), device="cpu", timeout=SPAWN_TIMEOUT)

    mesh = make_mesh(jax.devices()[:num_shards])

    def body(w0, w1, w2, c):
        rw, _, rc, rv = jexchange.all_to_all_exchange([w0, w1, w2], [], c, SHARD_AXIS)
        return (*rw, rc, rv)

    u = send.view(np.uint32)
    spec = P(SHARD_AXIS)
    jout = shard_map(body, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 5,
                     check_rep=False)(
        *[jnp.asarray(u[:, :, r].reshape(num_shards * num_shards, capacity))
          for r in range(3)],
        jnp.asarray(counts.reshape(-1).astype(np.int32)))
    jout = [np.asarray(x) for x in jout]
    for r in range(num_shards):
        got = np.load(os.path.join(tmp_path, f"a2a.{r}.npz"))
        rows = slice(r * num_shards, (r + 1) * num_shards)
        for w in range(3):
            assert np.array_equal(got["recv"][:, w].view(np.uint32), jout[w][rows])
        assert np.array_equal(got["recv_counts"], jout[3][rows])
        assert np.array_equal(got["recv_valid"], jout[4][rows])
        assert np.array_equal(got["recv"], send[:, r])
