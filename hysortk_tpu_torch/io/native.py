"""ctypes bindings for the native host-IO library (native/host_io.cpp).

The wrapper of hysortk_tpu/io/native.py, loading the same library, cut to
the entry points the single-device slice uses.

Loads (building on first use if a toolchain is present) the OpenMP-parallel
C++ implementations of the host hot loops; every entry point has a numpy
fallback with identical semantics, so the package works without a compiler
and tests can compare the two.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libhysortk_host.so"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

        try:
            lib.hk_strip_and_pack.argtypes = [
                u8p, i64p, i64p, i64p, i64p, i64p, ctypes.c_int64, u8p,
            ]
            lib.hk_decode_keys.argtypes = [
                u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p,
            ]
            lib.hk_pack_2bit.argtypes = [u8p, ctypes.c_int64, u32p]
            lib.hk_format_output.argtypes = [
                u32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p,
            ]
            lib.hk_format_output.restype = ctypes.c_int64
        except AttributeError:
            # Stale prebuilt .so missing a symbol: degrade to the numpy
            # fallbacks (the module contract) instead of raising out of
            # every native entry point.
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def strip_and_pack(
    raw: np.ndarray,
    raw_off: np.ndarray,
    seq_len: np.ndarray,
    line_bases: np.ndarray,
    line_width: np.ndarray,
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    raw_off = np.ascontiguousarray(raw_off, dtype=np.int64)
    seq_len = np.ascontiguousarray(seq_len, dtype=np.int64)
    line_bases = np.ascontiguousarray(line_bases, dtype=np.int64)
    line_width = np.ascontiguousarray(line_width, dtype=np.int64)
    out_off = np.concatenate([[0], np.cumsum(seq_len)[:-1]]).astype(np.int64)
    out = np.empty(int(seq_len.sum()), dtype=np.uint8)
    lib.hk_strip_and_pack(
        raw, raw_off, seq_len, line_bases, line_width, out_off,
        seq_len.size, out,
    )
    return out


def pack_2bit(codes: np.ndarray) -> Optional[np.ndarray]:
    """16 base codes per uint32 wire word; len(codes) % 16 == 0."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(codes.size // 16, dtype=np.uint32)
    lib.hk_pack_2bit(codes, codes.size, out)
    return out


def decode_keys(keys: np.ndarray, k: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, w = keys.shape
    buf = ctypes.create_string_buffer(n * k)
    lib.hk_decode_keys(keys, n, w, k, buf)
    return np.frombuffer(buf, dtype=np.uint8).view(f"S{k}").reshape(n).copy() \
        if n else np.zeros(0, dtype=f"S{k}")


def format_output_into(
    keys: np.ndarray, counts: np.ndarray, k: int, out: np.ndarray
) -> Optional[int]:
    """Render `kmer\\tcount\\n` rows into a caller-provided uint8 buffer
    (capacity >= n*(k+12)); returns the byte count, or None without the
    library. Zero-copy: the writer hands `memoryview(out)[:nbytes]`
    straight to file.write — no zeroing, no bytes duplication (the
    create_string_buffer version memset + copied ~1.4 GB per 2^24 rows)."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    n, w = keys.shape
    assert out.dtype == np.uint8 and out.size >= n * (k + 12)
    nbytes = lib.hk_format_output(
        keys, counts, n, w, k, out.ctypes.data_as(ctypes.c_char_p)
    )
    return int(nbytes)


def format_output(keys: np.ndarray, counts: np.ndarray, k: int) -> Optional[bytes]:
    n = keys.shape[0]
    out = np.empty(n * (k + 12), dtype=np.uint8)
    nbytes = format_output_into(keys, counts, k, out)
    if nbytes is None:
        return None
    return out[:nbytes].tobytes()
