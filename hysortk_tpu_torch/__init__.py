"""hysortk_tpu_torch — the k-mer counter in PyTorch, with CUDA kernels for Hopper.

The port of hysortk_tpu (JAX/Pallas) to one NVIDIA H100. The facade mirrors
the reference library API (reference: include/hysortk.hpp:10-16):

    read_dna_buffer       -> read + 2-bit code (a shard of) a FASTA file
    kmer_count            -> canonical k-mer counting with [L, U] filtering
    print_kmer_histogram  -> frequency histogram in the reference format
    write_output_file     -> per-shard `{kmer}\\t{count}` files

This package covers single-device counting, one-shot and in bounded device
memory (runtime/scheduler.count_reads_streaming), with and without
extension mode ((ReadId, PosInRead) occurrence payloads: count_reads_ext,
count_reads_streaming_ext), and counting across the ranks of a
torch.distributed process group, one device a rank
(parallel/pipeline.count_reads_sharded: the range exchange by default, the
minimizer and kmer_hash routings, and supermer routing, the reference's own
exchange, parallel/supermer_route.py; count_reads_sharded_streaming,
count_reads_sharded_ext, count_reads_sharded_ext_streaming), and
multi-process runs, where each process reads its own records of a FASTA
file and keeps its own share of the result with the global histogram
(parallel/multihost.py: count_fasta_multihost, count_fasta_multihost_ext,
count_fasta_multihost_streaming, count_fasta_multihost_ext_streaming;
count_fasta_multihost_supermer; the group joined by
initialize_distributed, as the CLI's --coordinator does). It imports
neither jax nor hysortk_tpu.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as _dist

from .config import KmerConfig, from_jax_fields
from .io import fasta as _fasta
from .io import writer as _writer
from .pipeline import (
    KmerList,
    KmerListExt,
    count_flat,
    count_flat_ext,
    count_reads,
    count_reads_ext,
    resolve_device,
)
from .runtime import memcheck as _memcheck
from .runtime.scheduler import (
    count_reads_streaming,
    count_reads_streaming_ext,
    suggest_batch_bases,
)

__version__ = "0.1.0"

_SHARDED_ENTRIES = (
    "count_reads_sharded",
    "count_reads_sharded_ext",
    "count_reads_sharded_streaming",
    "count_reads_sharded_ext_streaming",
)
_SUPERMER_ENTRIES = (
    "count_reads_supermer",
    "count_reads_supermer_ext",
    "count_reads_supermer_exchange",
    "count_fasta_multihost_supermer",
)
_MULTIHOST_ENTRIES = (
    "count_fasta_multihost",
    "count_fasta_multihost_ext",
    "count_fasta_multihost_streaming",
    "count_fasta_multihost_ext_streaming",
)

__all__ = [
    "KmerConfig",
    "KmerList",
    "KmerListExt",
    "from_jax_fields",
    "read_dna_buffer",
    "kmer_count",
    "print_kmer_histogram",
    "write_output_file",
    "count_flat",
    "count_reads",
    "count_reads_streaming",
    "count_flat_ext",
    "count_reads_ext",
    "count_reads_streaming_ext",
    *_SHARDED_ENTRIES,
    *_SUPERMER_ENTRIES,
    *_MULTIHOST_ENTRIES,
]


def __getattr__(name):
    # The sharded entry points load with their module, on first use.
    if name in _SHARDED_ENTRIES:
        from .parallel import pipeline as _pp

        return getattr(_pp, name)
    if name in _SUPERMER_ENTRIES:
        from .parallel import supermer_route as _sr

        return getattr(_sr, name)
    if name in _MULTIHOST_ENTRIES:
        from .parallel import multihost as _mh

        return getattr(_mh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def read_dna_buffer(
    fasta_path: str, shard: int = 0, num_shards: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Read this shard's portion of a FASTA file, 2-bit coded.

    Returns (codes uint8 flat, lengths int64). Facade analogue of
    hysortk::read_dna_buffer (src/hysortk.cpp:18-34): the index (built and
    written where the .fai is missing), the shard's record bounds, one read
    of its byte range.
    """
    index = _fasta.load_or_build_fai(fasta_path)
    bounds = _fasta.partition_bounds(index, num_shards)
    return _fasta.read_records(fasta_path, index[bounds[shard]:bounds[shard + 1]])


def kmer_count(
    codes: np.ndarray,
    lengths: np.ndarray,
    config: Optional[KmerConfig] = None,
    device="cuda",
) -> tuple[KmerList | KmerListExt, np.ndarray]:
    """Count canonical k-mers. Facade analogue of hysortk::kmer_count
    (src/hysortk.cpp:36-95). Returns (filtered KmerList, histogram array).

    `device` is a torch device ("cuda", "cuda:1", "cpu"); "cpu" runs the
    plain PyTorch versions of the kernels. Streams in bounded device memory
    by itself (count_reads_streaming) when the one-shot working set would
    not fit the device's memory headroom; the reference instead switches
    sorters on MemFree (src/kmerops.cpp:1344-1379). The CPU reports no
    headroom and always runs one-shot. Under cfg.extension the result is a
    KmerListExt with every k-mer's (read id, position) occurrences, counted
    one-shot (count_reads_ext; as in the JAX package the facade does not
    stream extension mode by itself, count_reads_streaming_ext does when
    called).

    Inside a torch.distributed process group of more than one rank, every
    rank calls this with the same reads and counts its share on its own
    device ("cuda": the card of its local rank), as the JAX facade does when
    it sees more than one device: extension mode by
    parallel/pipeline.count_reads_sharded_ext, a rank's share over the
    device's headroom by count_reads_sharded_streaming (in batches of
    suggest_batch_bases x the rank count), else count_reads_sharded; each
    rank returns the whole result. One process drives one device, so a list
    of devices raises NotImplementedError."""
    cfg = config or KmerConfig()
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "one process counts on one device; across devices, run one "
                "rank per device in a torch.distributed process group"
            )
        device = device[0]
    if _dist.is_available() and _dist.is_initialized() and _dist.get_world_size() > 1:
        return _kmer_count_sharded(codes, lengths, cfg, device)
    dev = resolve_device(device)
    if cfg.extension:
        return count_reads_ext(codes, lengths, cfg, device=dev)
    if _over_headroom(int(codes.size), cfg, dev):
        batch = suggest_batch_bases(cfg, dev)
        return count_reads_streaming(codes, lengths, cfg, batch, device=dev)
    return count_reads(codes, lengths, cfg, device=dev)


def _over_headroom(n_bases: int, cfg: KmerConfig, dev) -> bool:
    """Whether one-shot counting of n_bases would exceed the device's
    memory headroom (never on the CPU, which reports none)."""
    headroom = _memcheck.hbm_headroom_bytes(dev)
    need = n_bases * (4 + 2 * cfg.words * 4 + 8) * 2
    return headroom is not None and 0 < headroom < need


def _kmer_count_sharded(codes, lengths, cfg: KmerConfig, device):
    from .parallel import group as _group
    from .parallel import pipeline as _sharded

    dev = _group.rank_device(device)
    if cfg.extension:
        return _sharded.count_reads_sharded_ext(codes, lengths, cfg, device=dev)
    ranks = _dist.get_world_size()
    if _over_headroom(-(-int(codes.size) // ranks), cfg, dev):
        batch = suggest_batch_bases(cfg, dev) * ranks
        return _sharded.count_reads_sharded_streaming(codes, lengths, cfg, batch,
                                                      device=dev)
    return _sharded.count_reads_sharded(codes, lengths, cfg, device=dev)


def print_kmer_histogram(hist: np.ndarray) -> str:
    """Render + print the frequency histogram (src/hysortk.cpp:98-136)."""
    text = _writer.format_histogram(hist)
    print(text, end="")
    return text


def write_output_file(
    kmerlist: KmerList | KmerListExt, output_dir: str, shard: int = 0
) -> str:
    """Write `<outdir>/<shard>.out` (src/hysortk.cpp:138-164)."""
    return _writer.write_output_file(kmerlist, output_dir, shard)
