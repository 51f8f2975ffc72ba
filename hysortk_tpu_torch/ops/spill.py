"""Exact-capacity geometry for the range exchange.

The port of hysortk_tpu/ops/spill.py. Each exchange cell carries
`capacity = m + sc` contiguous slots of one sorted segment: m, the largest
power of two <= capacity, holds the bulk, and a small spill lane sc absorbs
the hash-uniform overhang. The JAX receive side pads each run back to 2m
for its power-of-two merge network; the port's run merge takes run bounds
(ops/merge.merge_runs_at) and merges the S received rows of `capacity`
slots as they are, so here the split only documents the geometry and keeps
the overflow retry's invariant.
"""

from __future__ import annotations


def split_capacity(capacity: int) -> tuple[int, int]:
    """capacity -> (m, sc): m = largest power of two <= capacity.

    sc == 0 (capacity itself pow2) selects the legacy single-plane
    geometry — EXT mode and the overflow-retry doubling both preserve the
    invariant (m + sc doubles to 2m + 2sc with 2m still the largest pow2).
    """
    m = 1 << (int(capacity).bit_length() - 1)
    return m, capacity - m
