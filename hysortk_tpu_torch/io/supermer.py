"""Host side of the 2-bit packed read wire.

Only `pack_codes_2bit` of hysortk_tpu/io/supermer.py is ported (the wire
of the single-device and the sharded paths); supermer encoding and routing
are later work.
"""

from __future__ import annotations

import numpy as np


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Flat base codes -> uint32 wire words, 16 bases/word big-endian.

    The host side of the device decode in ops/wire.py: word w holds bases
    16w..16w+15, base b at shift 30 - 2*(b%16). ~2 bits/base on the wire
    (vs 8 for int8 codes), matching the reference's 2-bit supermer payload
    density (src/kmerops.cpp:1096-1148)."""
    n = int(codes.size)
    pad = -n % 16
    from . import native

    if pad == 0 and native.available():
        out = native.pack_2bit(codes.astype(np.uint8, copy=False))
        if out is not None:
            return out
    c = np.zeros(n + pad, dtype=np.uint32)
    c[:n] = codes.astype(np.uint32)
    c = c.reshape(-1, 16)
    out = np.zeros(c.shape[0], dtype=np.uint32)
    for j in range(16):
        out |= c[:, j] << np.uint32(30 - 2 * j)
    return out
