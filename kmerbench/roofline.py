"""The work a call has to do on the card, and the card's peaks.

A call's device inputs are read once: the 2-bit wire (0.25 B a base) and
the read lengths (4 B a read). Its outputs are written once: the kept rows
(W 4-byte key words and the count at the narrowest width that `upper`
fits), the histogram (4 B a bin over [0, upper]) and, in extension mode,
8 B an occurrence (read id, position). Counted per call, not per kernel, so
the same work stands whatever kernels do it.
"""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def count_bytes(upper: int) -> int:
    return 1 if upper < 1 << 8 else 2 if upper < 1 << 16 else 4


def call_bytes(bases: int, reads: int, rows: int, words: int, upper: int,
               occurrences: int = 0) -> int:
    wire = -(-bases // 16) * 4 + 4 * reads
    return wire + rows * (4 * words + count_bytes(upper)) + 4 * (upper + 1) + 8 * occurrences


def peak(kind: str, key: str) -> float | None:
    """The card's published peak `key` (peaks.json), None for a card the
    table does not know."""
    with open(PEAKS) as f:
        table = json.load(f)
    for name, row in table.items():
        if name in kind:
            return row.get(key)
    return None
