"""The supermer route's send side on the device: the run layout and the
segment pack, two kernels of the slice, and the plain functions they are
held to.

The JAX package encodes supermers on the host (hysortk_tpu/io/supermer.py
run_boundaries, encode_supermer_streams[_ext]; parallel/supermer_route.py
_pack_streams, _prepare_exchange_arrays), as the port's io/supermer.py and
supermer_route._segments still do for the tests. Here the same send tensor
is built where the rank's codes already lie:

  run_layout      (valid, minimizer bucket, bucket -> rank table) over the
                  rank's positions -> the runs grouped by destination rank
                  in flat order within each (first base, base offset in the
                  destination's segment, length), the destinations' run
                  bounds and their largest base and run counts
                  (csrc/supermer_runs.cu on a CUDA tensor, two launches and
                  one read of (runs, cmax, smax); `run_layout_plain` on a
                  CPU tensor);
  run_layout_plain  its plain composition: `run_table_plain` of the ranks
                  assign[dest], then `segment_layout` (torch ops);
  run_table       each run's flat start, k-mer count and destination, in
                  ascending flat order (`run_table_plain`, plain torch on any
                  device: the tests hold it to the JAX package's
                  run_boundaries);
  run_headers     extension mode: each run's first read id and in-read
                  position, from the read lengths (torch.searchsorted);
  pack_segments   the (S, 1, width) int32 send tensor, bit for bit what
                  _segments builds from the host streams
                  (csrc/supermer_pack.cu on a CUDA tensor: one launch, a
                  block a tile of 2048 words of one destination with its
                  runs staged in shared memory, a word read in one stretch
                  of the codes by two 16-byte loads, the columns by
                  blocks of their own; `pack_segments_plain` on a CPU
                  tensor).

The rule of a run is the reference's SupermerEncoder's
(src/kmerops.cpp:1096-1148): a maximal stretch of consecutive valid k-mer
starts with one destination, cut every max_kmers k-mers from the stretch's
start (MAX_SUPERMER_LEN bases, include/supermer.hpp:20).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build
from ..io.supermer import MAX_SUPERMER_LEN
from .wire import _wrap32


def max_kmers(k: int) -> int:
    """The k-mers of a run of MAX_SUPERMER_LEN bases."""
    return MAX_SUPERMER_LEN - k + 1


def _check_run_inputs(valid: torch.Tensor, dest: torch.Tensor, max_kmers_: int) -> None:
    if valid.dtype != torch.bool or dest.dtype != torch.int32:
        raise TypeError(f"need bool valid and int32 destinations, got {valid.dtype} "
                        f"and {dest.dtype}")
    if valid.dim() != 1 or valid.shape != dest.shape:
        raise ValueError(f"need matching 1-D valid and destinations, got "
                         f"{tuple(valid.shape)} and {tuple(dest.shape)}")
    if valid.device != dest.device:
        raise ValueError(f"valid on {valid.device}, destinations on {dest.device}")
    if max_kmers_ < 1:
        raise ValueError(f"max_kmers must be at least 1, got {max_kmers_}")


def run_table_plain(
    valid: torch.Tensor, dest: torch.Tensor, max_kmers_: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the run-table kernel, on any device:
    io/supermer.run_boundaries_plain's mask arithmetic in torch."""
    dev = valid.device
    idx = torch.nonzero(valid).squeeze(1)
    if idx.numel() == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    d = dest[idx]
    head = torch.ones(idx.numel(), dtype=torch.bool, device=dev)
    head[1:] = (idx[1:] != idx[:-1] + 1) | (d[1:] != d[:-1])
    ar = torch.arange(idx.numel(), device=dev)
    into = ar - torch.cummax(torch.where(head, ar, 0), 0).values
    start = (into % max_kmers_) == 0
    first = torch.nonzero(start).squeeze(1)
    kmers = torch.diff(first, append=first.new_tensor([idx.numel()]))
    return idx[first], kmers.to(torch.int32), d[first]


def run_table(
    valid: torch.Tensor, dest: torch.Tensor, max_kmers_: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Supermer runs of a rank's positions: valid (n,) bool k-mer starts,
    dest (n,) int32 destination ranks (read only where valid) -> (start
    int64, k-mer count int32, destination int32) per run, ascending by
    start. A run of R k-mers spans R + k - 1 bases. Plain torch on any
    device (run_layout is the kernel that lays the runs out)."""
    _check_run_inputs(valid, dest, max_kmers_)
    return run_table_plain(valid, dest, max_kmers_)


@dataclasses.dataclass
class SegmentLayout:
    """The runs grouped by destination, in flat order within each, all on
    the device: src (R,) int64 first base in the codes; off (R,) int64 first
    base in the destination's segment; bases (R,) int32 length;
    dest_begin (S + 1,) int64 run bounds of the destinations. cmax and smax
    (host ints): the most bases and the most runs of any destination."""

    src: torch.Tensor
    off: torch.Tensor
    bases: torch.Tensor
    dest_begin: torch.Tensor
    cmax: int
    smax: int


def segment_layout(starts: torch.Tensor, kmers: torch.Tensor, run_dest: torch.Tensor,
                   k: int, num_dest: int) -> SegmentLayout:
    """The per-destination bookkeeping of a run table, by torch ops where
    the table lies (one read of the two maxima to the host)."""
    bases = kmers.to(torch.int64) + (k - 1)
    order = torch.sort(run_dest, stable=True).indices
    d = run_dest[order].to(torch.int64)
    bases = bases[order]
    runs_per = torch.bincount(d, minlength=num_dest)
    bases_per = torch.zeros(num_dest, dtype=torch.int64, device=bases.device)
    bases_per.scatter_add_(0, d, bases)
    dest_begin = torch.cat([runs_per.new_zeros(1), torch.cumsum(runs_per, 0)])
    seg_begin = torch.cumsum(bases_per, 0) - bases_per
    off = torch.cumsum(bases, 0) - bases - seg_begin[d]
    cmax, smax = (int(v) for v in torch.stack([bases_per.max(), runs_per.max()]).cpu())
    return SegmentLayout(starts[order], off, bases.to(torch.int32), dest_begin, cmax,
                         smax)


MAX_DEST = 8192  # csrc/supermer_runs.cu's destinations a call


def _check_layout_inputs(valid, dest, assign, max_kmers_: int, k: int,
                         num_dest: int) -> None:
    _check_run_inputs(valid, dest, max_kmers_)
    if assign.dtype != torch.int32 or assign.dim() != 1 or assign.numel() < 1:
        raise TypeError(f"need a 1-D int32 bucket -> rank table, got {assign.dtype}"
                        f"{tuple(assign.shape)}")
    if assign.device != valid.device:
        raise ValueError(f"valid on {valid.device}, the table on {assign.device}")
    if not 1 <= num_dest <= MAX_DEST or k < 1:
        raise ValueError(f"need 1 <= num_dest <= {MAX_DEST} and k >= 1, got "
                         f"{num_dest}, {k}")


def run_layout_plain(valid: torch.Tensor, dest: torch.Tensor, assign: torch.Tensor,
                     max_kmers_: int, k: int, num_dest: int) -> SegmentLayout:
    """The plain PyTorch version of the run-layout kernel, on any device:
    the run table of the ranks assign[dest], then segment_layout."""
    ranks = torch.where(valid, assign[torch.where(valid, dest, 0).to(torch.int64)], 0)
    return segment_layout(*run_table_plain(valid, ranks, max_kmers_), k, num_dest)


def run_layout(valid: torch.Tensor, dest: torch.Tensor, assign: torch.Tensor,
               max_kmers_: int, k: int, num_dest: int) -> SegmentLayout:
    """The segment layout of a rank's supermer runs: valid (n,) bool k-mer
    starts, dest (n,) int32 minimizer buckets in [0, assign.numel()) where
    valid, assign the bucket -> destination rank table (int32 ranks in [0,
    num_dest)). Field by field what run_layout_plain gives."""
    _check_layout_inputs(valid, dest, assign, max_kmers_, k, num_dest)
    if valid.device.type == "cpu":
        return run_layout_plain(valid, dest, assign, max_kmers_, k, num_dest)
    if valid.device.type != "cuda":
        raise ValueError(f"unsupported device {valid.device}")
    return _run_layout_cuda(valid.contiguous(), dest.contiguous(), assign.contiguous(),
                            max_kmers_, k, num_dest)


def _run_layout_cuda(valid, dest, assign, max_kmers_, k, num_dest) -> SegmentLayout:
    dev = valid.device
    n = valid.shape[0]
    if n == 0:
        return SegmentLayout(torch.empty(0, dtype=torch.int64, device=dev),
                             torch.empty(0, dtype=torch.int64, device=dev),
                             torch.empty(0, dtype=torch.int32, device=dev),
                             torch.zeros(num_dest + 1, dtype=torch.int64, device=dev), 0, 0)
    if n >= 2**31 - 4096:
        raise ValueError(f"run layout takes n < 2^31 - 4096, got {n}")
    lib = _build.lib()
    buckets = assign.numel()
    scratch = torch.empty(lib.hk_run_layout_scratch(n, num_dest), dtype=torch.uint8,
                          device=dev)
    dest_begin = torch.empty(num_dest + 1, dtype=torch.int64, device=dev)
    info = torch.empty(3, dtype=torch.int64, device=dev)
    args = (valid.data_ptr(), dest.data_ptr(), assign.data_ptr(), buckets, n, max_kmers_,
            k, num_dest, scratch.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hk_run_layout_count(*args, dest_begin.data_ptr(), info.data_ptr(),
                                         stream)
        _build.check(status, "run layout count launch")
        runs, cmax, smax = (int(v) for v in info.cpu())
        src = torch.empty(runs, dtype=torch.int64, device=dev)
        off = torch.empty(runs, dtype=torch.int64, device=dev)
        bases = torch.empty(runs, dtype=torch.int32, device=dev)
        if runs:
            status = lib.hk_run_layout_write(*args, dest_begin.data_ptr(), src.data_ptr(),
                                             off.data_ptr(), bases.data_ptr(), stream)
            _build.check(status, "run layout write launch")
    _build.launches["supermer_runs"] += 1
    return SegmentLayout(src, off, bases, dest_begin, cmax, smax)


def segment_dims(cmax: int, smax: int, pad_multiple: int,
                 min_dims: tuple[int, int] = (0, 1)) -> tuple[int, int]:
    """(block_len, lmax) of the segments from the largest base and run
    counts of any (rank, destination), as supermer_route._segments sizes
    them: block_len a multiple of lcm(16, pad_multiple) with 16 spare
    slots, lmax at least 1, both pinned from below by min_dims."""
    gran = math.lcm(16, pad_multiple)
    block_len = -(-max(cmax + 16, gran, min_dims[0]) // gran) * gran
    return block_len, max(smax, 1, min_dims[1])


def run_headers(src: torch.Tensor, read_lengths: torch.Tensor,
                read_id_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Extension mode: each run's first read id (read_id_offset + the index
    of the read holding its first base, int32 with a two's complement wrap)
    and in-read position (int32 holding uint32 bits), from the rank's read
    lengths (zero-length reads counted) by one search over the read
    starts."""
    lens = read_lengths.to(torch.int64)
    read_starts = torch.cumsum(lens, 0) - lens
    rid = torch.searchsorted(read_starts, src, right=True) - 1
    pos = src - read_starts[rid.clamp(min=0)]
    return _wrap32(rid + read_id_offset), _wrap32(pos)


def _check_pack_inputs(codes, layout: SegmentLayout, headers, block_len, lmax) -> None:
    if codes.dtype != torch.int8 or codes.dim() != 1:
        raise TypeError(f"need 1-D int8 codes, got {codes.dtype} {tuple(codes.shape)}")
    if block_len % 16 or block_len < 16 or lmax < 1:
        raise ValueError(f"need block_len a positive multiple of 16 and lmax >= 1, "
                         f"got {block_len}, {lmax}")
    rows = [layout.src, layout.off, layout.bases, layout.dest_begin, *headers]
    if any(r.device != codes.device for r in rows):
        raise ValueError("the codes and the layout must lie on one device")
    if headers and len(headers) != 2:
        raise ValueError(f"need (rid0, pos0) headers or none, got {len(headers)}")


def pack_segments_plain(codes: torch.Tensor, layout: SegmentLayout, block_len: int,
                        lmax: int, headers=()) -> torch.Tensor:
    """The plain PyTorch version of the pack kernel, on any device: every
    run's bases gathered into a zeroed (S, block_len) buffer, 16 codes a
    word, then the columns."""
    dev = codes.device
    num_dest = layout.dest_begin.shape[0] - 1
    nw = block_len // 16
    width = nw + lmax * (3 if headers else 1)
    send = torch.zeros((num_dest, width), dtype=torch.int32, device=dev)
    runs = layout.bases.shape[0]
    if runs:
        bases = layout.bases.to(torch.int64)
        d = torch.repeat_interleave(
            torch.arange(num_dest, device=dev), torch.diff(layout.dest_begin))
        run = torch.repeat_interleave(torch.arange(runs, device=dev), bases)
        into = torch.arange(run.numel(), device=dev) - (torch.cumsum(bases, 0) - bases)[run]
        buf = torch.zeros(num_dest * block_len, dtype=torch.int64, device=dev)
        buf[d[run] * block_len + layout.off[run] + into] = \
            codes[layout.src[run] + into].to(torch.int64) & 3
        shifts = 30 - 2 * torch.arange(16, device=dev)
        words = (buf.view(-1, 16) << shifts).sum(1)
        send[:, :nw] = _wrap32(words).view(num_dest, nw)
        rank = torch.arange(runs, device=dev) - layout.dest_begin[d]
        for col, row in enumerate([layout.bases, *headers]):
            send[d, nw + col * lmax + rank] = row
    return send.view(num_dest, 1, width)


def pack_segments(codes: torch.Tensor, layout: SegmentLayout, block_len: int,
                  lmax: int, headers=()) -> torch.Tensor:
    """The (S, 1, block_len / 16 + lmax * (3 if headers else 1)) int32 send
    tensor of a layout: each destination's runs, 2-bit packed from `codes`
    (the rank's (n,) int8 base codes), their lengths, and with headers =
    (rid0, pos0) (run_headers, in the layout's order) those columns too."""
    headers = tuple(headers)
    _check_pack_inputs(codes, layout, headers, block_len, lmax)
    if codes.device.type == "cpu":
        return pack_segments_plain(codes, layout, block_len, lmax, headers)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    return _pack_segments_cuda(codes.contiguous(), layout, block_len, lmax, headers)


def _pack_segments_cuda(codes, layout: SegmentLayout, block_len, lmax, headers):
    dev = codes.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _pack_segments_cuda(codes, layout, block_len, lmax, headers)
    num_dest = layout.dest_begin.shape[0] - 1
    nw = block_len // 16
    send = torch.empty((num_dest, 1, nw + lmax * (3 if headers else 1)),
                       dtype=torch.int32, device=dev)
    rows = [r.contiguous() for r in (layout.src, layout.off, layout.bases,
                                     layout.dest_begin, *headers)]
    rid0, pos0 = (rows[4].data_ptr(), rows[5].data_ptr()) if headers else (None, None)
    lib = _build.lib()
    status = lib.hk_supermer_pack(
        codes.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        rid0, pos0, rows[3].data_ptr(), num_dest, nw, lmax, int(bool(headers)),
        send.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "supermer pack launch")
    _build.launches["supermer_pack"] += 1
    return send
