"""Output writers: per-shard {kmer, count} files and the frequency histogram.

Formats are byte-identical to the reference:
  * write_output_file (src/hysortk.cpp:138-164): `<outdir>/<shard>.out`, one
    ASCII `kmer\\tcount` line per entry.
  * print_kmer_histogram (src/hysortk.cpp:98-136): header `#count\\tnumkmers`,
    one `count\\tnumkmers` line per nonzero bin (count >= 1), then a blank line.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.kmer import decode_keys_plain
from ..pipeline import KmerList


def format_output_lines(kmerlist: KmerList) -> bytes:
    """Render `kmer\\tcount\\n` lines (the host library's formatter)."""
    if len(kmerlist) == 0:
        return b""
    from . import native

    fmt = native.format_output if native.available() else format_output_plain
    return fmt(kmerlist.keys, kmerlist.counts.astype(np.int32), kmerlist.k)


def format_output_plain(keys: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    """The plain version of `native.format_output`: one Python line a
    k-mer."""
    if keys.shape[0] == 0:
        return b""
    parts = [
        kmer + b"\t" + str(int(cnt)).encode()
        for kmer, cnt in zip(decode_keys_plain(keys, k), counts)
    ]
    return b"\n".join(parts) + b"\n"


def write_output_file(
    kmerlist: KmerList, output_dir: str, shard: int = 0,
    chunk_rows: int = 1 << 22,
) -> str:
    """Write `<outdir>/<shard>.out` in row chunks through one reused
    format buffer: each chunk renders with the host library's formatter
    (csrc/host_io.cpp hk_format_output, on torch's thread count) and goes
    to the file as a memoryview — no per-chunk allocation or bytes copy,
    and peak buffer memory stays ~chunk_rows x (k+12) B instead of the
    whole file (multi-GB at genome scale). Reference writes per-rank files
    concurrently (src/hysortk.cpp:138-164); single-shard runs rely on
    this thread parallelism instead."""
    from . import native

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{shard}.out")
    n = len(kmerlist)
    with open(path, "wb") as f:
        if n == 0 or not native.available():
            f.write(format_output_lines(kmerlist))
            return path
        k = kmerlist.k
        counts32 = kmerlist.counts.astype(np.int32)
        rows = min(n, chunk_rows)
        buf = np.empty(rows * (k + 12), dtype=np.uint8)
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            nbytes = native.format_output_into(
                kmerlist.keys[lo:hi], counts32[lo:hi], k, buf
            )
            f.write(memoryview(buf)[:nbytes])
    return path


def format_histogram(hist: np.ndarray) -> str:
    """hist[c] = number of kmers with count c; render the reference's format."""
    lines = ["#count\tnumkmers"]
    for c in range(1, len(hist)):
        if hist[c] > 0:
            lines.append(f"{c}\t{int(hist[c])}")
    lines.append("")
    return "\n".join(lines) + "\n"


def parse_histogram(text: str) -> dict[int, int]:
    """Parse the reference's histogram output into {count: numkmers}."""
    out: dict[int, int] = {}
    for line in text.splitlines():
        line = line.strip()
        parts = line.split("\t")
        # Histogram rows are exactly "<count>\t<numkmers>"; the reference's
        # stdout interleaves timing/log lines that must be ignored.
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            out[int(parts[0])] = int(parts[1])
    return out


def parse_output_files(output_dir: str) -> dict[bytes, int]:
    """Union of all `<shard>.out` files -> {kmer: count} (order-free compare)."""
    merged: dict[bytes, int] = {}
    for name in sorted(os.listdir(output_dir)):
        if not name.endswith(".out"):
            continue
        with open(os.path.join(output_dir, name), "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                kmer, cnt = line.rstrip(b"\n").split(b"\t")
                assert kmer not in merged, f"duplicate kmer across shards: {kmer!r}"
                merged[kmer] = int(cnt)
    return merged
