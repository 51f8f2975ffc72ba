"""The pack by destination (parallel/exchange.pack_by_destination) on every
case of hysortk_tpu_torch.testing.dest_pack_cases: the plain version against
the JAX package's pack_by_destination (counts, overflow, the sentinel past
each count, each destination's rows as a multiset where none overflows: the
JAX version orders a destination by key, the port by slot) and against a
stable counting scatter in numpy, slot for slot; the bucket + table form
against the precomputed destinations; and the kernel (csrc/dest_pack.cu; past
255 destinations the radix-sort composition) against the plain version on a
card (`cuda` marker). Seeded numpy inputs; the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hysortk_tpu.parallel import exchange as jexchange
from hysortk_tpu_torch import _build, testing
from hysortk_tpu_torch.parallel import exchange

CASES = testing.dest_pack_cases()
IDS = [case[0] for case in CASES]


def _tensors(case, device="cpu"):
    """(valid, dest, words, payloads, num_shards, capacity, assign) as
    pack_by_destination takes them."""
    _, valid, dest, rows, n_words, num_shards, capacity, assign = case
    rows = [torch.from_numpy(r.view(np.int32)).to(device) for r in rows]
    return (torch.from_numpy(valid).to(device), torch.from_numpy(dest).to(device),
            rows[:n_words], rows[n_words:], num_shards, capacity,
            None if assign is None else torch.from_numpy(assign).to(device))


def _ranks(case) -> np.ndarray:
    """Each slot's destination rank, num_shards where it is not sent."""
    _, valid, dest, _, _, num_shards, _, assign = case
    dest = dest.astype(np.int64)
    if assign is not None:
        dest = assign[np.where(valid, dest, 0)].astype(np.int64)
    return np.where(valid & (dest >= 0) & (dest < num_shards), dest, num_shards)


def _counting_scatter(case):
    """The send block by a stable counting scatter, slot by slot: each
    sent slot takes the next column of its destination while one is left."""
    _, _, _, rows, _, num_shards, capacity, _ = case
    send = np.full((num_shards, rows.shape[0], capacity), 0xFFFFFFFF, dtype=np.uint32)
    counts = np.zeros(num_shards, dtype=np.int64)
    for i, d in enumerate(_ranks(case).tolist()):
        if d < num_shards:
            if counts[d] < capacity:
                send[d, :, counts[d]] = rows[:, i]
            counts[d] += 1
    return send, counts, bool((counts > capacity).any())


def _segments(send, counts, capacity):
    """Per destination, the sorted multiset of its column tuples."""
    out = []
    for s, c in enumerate(counts):
        take = min(int(c), capacity)
        out.append(sorted(map(tuple, send[s, :, :take].T.tolist())))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_pack_matches_jax(case):
    _, valid, _, rows, n_words, num_shards, capacity, _ = case
    send, counts, overflow = exchange.pack_by_destination_plain(*_tensors(case))
    if valid.size == 0:
        # The JAX version gathers from the empty sorted rows, which XLA
        # refuses; nothing is sent.
        assert send.shape == (num_shards, rows.shape[0], capacity)
        assert (send == -1).all() and not counts.any() and not overflow
        return
    ranks = _ranks(case)
    jw, jp, jc, jo = jexchange.pack_by_destination(
        jnp.asarray((ranks == num_shards).astype(np.uint32)),
        jnp.asarray(ranks.astype(np.uint32)),
        [jnp.asarray(r) for r in rows[:n_words]], [jnp.asarray(r) for r in rows[n_words:]],
        num_shards, capacity)
    assert send.shape == (num_shards, rows.shape[0], capacity)
    assert counts.dtype == np.int64
    assert np.array_equal(counts, np.asarray(jc)) and overflow == bool(jo)
    got = send.numpy().view(np.uint32)
    past = np.arange(capacity)[None, None, :] >= counts[:, None, None]
    assert (got[np.broadcast_to(past, got.shape)] == 0xFFFFFFFF).all()
    if not overflow:
        want = np.stack([np.asarray(a) for a in (*jw, *jp)], axis=1)
        assert _segments(got, counts, capacity) == _segments(want, counts, capacity)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_pack_is_a_stable_counting_scatter(case):
    send, counts, overflow = exchange.pack_by_destination(*_tensors(case))
    want, want_counts, want_overflow = _counting_scatter(case)
    assert np.array_equal(send.numpy().view(np.uint32), want)
    assert np.array_equal(counts, want_counts) and overflow == want_overflow


@pytest.mark.parametrize("case", [c for c in CASES if c[7] is not None],
                         ids=[c[0] for c in CASES if c[7] is not None])
def test_bucket_table_form_equals_destinations(case):
    valid, bucket, words, payloads, num_shards, capacity, assign = _tensors(case)
    ranks = torch.where(valid, assign[torch.where(valid, bucket, 0).to(torch.int64)],
                        num_shards + 5)
    by_table = exchange.pack_by_destination(valid, bucket, words, payloads, num_shards,
                                            capacity, assign)
    by_rank = exchange.pack_by_destination(valid, ranks, words, payloads, num_shards,
                                           capacity)
    assert torch.equal(by_table[0], by_rank[0])
    assert np.array_equal(by_table[1], by_rank[1]) and by_table[2] == by_rank[2]


def test_dest_pack_cases_reach_their_edges():
    by_name = {c[0]: c for c in CASES}
    assert by_name["empty"][1].size == 0
    assert by_name["ragged"][1].size % testing.DEST_PACK_TILE
    tile = testing.DEST_PACK_TILE
    assert {c[1].size for c in CASES} >= {tile - 1, tile, tile + 1}
    assert {c[5] for c in CASES} >= {1, 3, 4, 255, 300}
    assert not by_name["all_invalid"][1].any()
    for name in ("overflow", "cap1"):
        assert _counting_scatter(by_name[name])[2]
    assert by_name["table"][7].size == 3 * by_name["table"][5]
    assert by_name["table_big"][7].size > testing.DEST_PACK_STAGED
    assert {c[3].shape[0] for c in CASES} >= {1, 8}
    assert by_name["dest64"][2].dtype == np.int64
    for case in CASES:  # garbage at invalid slots
        _, valid, dest, _, _, num_shards, _, assign = case
        limit = num_shards if assign is None else assign.size
        if (~valid).sum() > 100:
            assert ((dest[~valid] >= limit) | (dest[~valid] < 0)).any()


def test_pack_rejects_what_it_does_not_take():
    valid = torch.ones(4, dtype=torch.bool)
    dest = torch.zeros(4, dtype=torch.int32)
    row = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):  # more rows than the kernel carries
        exchange.pack_by_destination(valid, dest, [row] * 9, [], 2, 4)
    with pytest.raises(TypeError):
        exchange.pack_by_destination(valid, dest.to(torch.int16), [row], [], 2, 4)
    with pytest.raises(ValueError):  # a table takes int32 buckets
        exchange.pack_by_destination(valid, dest.to(torch.int64), [row], [], 2, 4,
                                     torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        exchange.pack_by_destination(valid[:3], dest, [row], [], 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pack_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    num_shards = case[5]
    before = dict(_build.launches)
    got = exchange.pack_by_destination(*_tensors(case, "cuda"))
    torch.cuda.synchronize()
    kernel = num_shards <= exchange.MAX_KERNEL_DEST
    assert _build.launches["dest_pack"] == before["dest_pack"] + kernel
    assert _build.launches["radix_sort"] == before["radix_sort"] + (
        not kernel and case[1].size > 0)
    want = exchange.pack_by_destination_plain(*_tensors(case))
    assert torch.equal(got[0].cpu(), want[0])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
