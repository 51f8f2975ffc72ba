"""hysortk_tpu_torch — the k-mer counter in PyTorch, with CUDA kernels for Hopper.

The port of hysortk_tpu (JAX/Pallas) to one NVIDIA H100. The facade mirrors
the reference library API (reference: include/hysortk.hpp:10-16):

    read_dna_buffer       -> read + 2-bit code (a shard of) a FASTA file
    kmer_count            -> canonical k-mer counting with [L, U] filtering
    print_kmer_histogram  -> frequency histogram in the reference format
    write_output_file     -> per-shard `{kmer}\\t{count}` files

This package covers single-device, non-extension counting. It imports
neither jax nor hysortk_tpu.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import KmerConfig, from_jax_fields
from .io import fasta as _fasta
from .io import writer as _writer
from .pipeline import KmerList, count_flat, count_reads

__version__ = "0.1.0"

__all__ = [
    "KmerConfig",
    "KmerList",
    "from_jax_fields",
    "read_dna_buffer",
    "kmer_count",
    "print_kmer_histogram",
    "write_output_file",
    "count_flat",
    "count_reads",
]


def read_dna_buffer(
    fasta_path: str, shard: int = 0, num_shards: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Read this shard's portion of a FASTA file, 2-bit coded.

    Returns (codes uint8 flat, lengths int64). Facade analogue of
    hysortk::read_dna_buffer (src/hysortk.cpp:18-34).
    """
    records = _fasta.load_or_build_fai(fasta_path)
    parts = _fasta.partition_records(records, num_shards)
    mine = [records[i] for i in parts[shard]]
    return _fasta.read_records(fasta_path, mine)


def kmer_count(
    codes: np.ndarray,
    lengths: np.ndarray,
    config: Optional[KmerConfig] = None,
    device="cuda",
) -> tuple[KmerList, np.ndarray]:
    """Count canonical k-mers on one device. Facade analogue of
    hysortk::kmer_count (src/hysortk.cpp:36-95). Returns (filtered KmerList,
    histogram array).

    `device` is a torch device ("cuda", "cuda:1", "cpu"); "cpu" runs the
    plain PyTorch versions of the kernels. Extension mode, more than one
    device and bounded-memory streaming are not ported yet: the first two
    raise NotImplementedError."""
    cfg = config or KmerConfig()
    if cfg.extension:
        raise NotImplementedError("extension mode is not ported yet")
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "counting across more than one device is not ported yet"
            )
        device = device[0]
    return count_reads(codes, lengths, cfg, device=device)


def print_kmer_histogram(hist: np.ndarray) -> str:
    """Render + print the frequency histogram (src/hysortk.cpp:98-136)."""
    text = _writer.format_histogram(hist)
    print(text, end="")
    return text


def write_output_file(
    kmerlist: KmerList, output_dir: str, shard: int = 0
) -> str:
    """Write `<outdir>/<shard>.out` (src/hysortk.cpp:138-164)."""
    return _writer.write_output_file(kmerlist, output_dir, shard)
