"""Merge of pre-sorted equal-length runs: the other kernel of the streaming
merge.

The port of hysortk_tpu/ops/merge.py merge_sorted_runs and of the kernel it
reaches on the TPU, pallas_sort.merge_runs. Per-batch partial lists arrive
as S already-sorted runs of length L (sentinel-padded); re-sorting them would
repeat work the batches already paid for. On a CUDA tensor the wrapper runs
the hand-written kernels of csrc/merge_runs.cu in ceil(log_F(S)) passes,
each merging groups of F = FAN_IN neighbouring runs in one read and one
write of every row (one pass for S <= F); on a CPU tensor it runs the plain
version, a stable sort of the concatenation (radix_sort.sort_words_plain).

Both versions are stable (on equal keys the earlier run's rows come first),
so they compare exactly, payloads included. The JAX merge is a bitonic
network and unstable: against it, key rows compare exactly and payloads as
per-key sums. The network's run orientation (`flip_odd_runs`) has no
counterpart here.

Requirements, as in the JAX package: run length L and run count S are powers
of two; runs are ascending with the all-ones sentinel (ops/sort.py) in their
tail slots. The kernel itself takes run boundaries (merge_plan), so runs of
unequal length need no other kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build
from . import radix_sort

MAX_KEY_WORDS = radix_sort.MAX_KEY_WORDS
MAX_ROWS = radix_sort.MAX_ROWS
FAN_IN = 8  # runs merged into one per pass (the kernel takes 2..32)
TILE = 2048  # output slots per tile of csrc/merge_runs.cu (its entry point checks)


class MergePass(NamedTuple):
    """One pass of the kernel: runs [g * fan_in, (g + 1) * fan_in) of
    `bounds` become one run each. bounds: the n_runs + 1 run boundaries;
    group_tiles: prefix sums (n_groups + 1) of each group's output tiles."""

    bounds: np.ndarray
    group_tiles: np.ndarray

    @property
    def n_runs(self) -> int:
        return self.bounds.shape[0] - 1

    @property
    def n_groups(self) -> int:
        return self.group_tiles.shape[0] - 1

    @property
    def num_tiles(self) -> int:
        return int(self.group_tiles[-1])


def merge_plan(bounds: Sequence[int], tile: int, fan_in: int = FAN_IN) -> list[MergePass]:
    """The passes that merge the runs between `bounds` (S + 1 ascending slot
    offsets, from 0 to N) into one, fan_in runs at a time: ceil(log_fan_in(S))
    passes, the last one of fan-in S / fan_in^(passes - 1) or less."""
    b = np.asarray(bounds, dtype=np.int64)
    if b.ndim != 1 or b.shape[0] < 2 or b[0] != 0 or np.any(np.diff(b) < 0):
        raise ValueError("bounds must ascend from 0 and hold at least one run")
    passes = []
    while b.shape[0] > 2:
        n_runs = b.shape[0] - 1
        first = np.arange(0, n_runs, fan_in)
        sizes = b[np.minimum(first + fan_in, n_runs)] - b[first]
        tiles = -(-sizes // tile)
        passes.append(MergePass(b, np.concatenate([[0], np.cumsum(tiles)])))
        b = np.append(b[first], b[-1])
    return passes


def merge_sorted_runs_plain(
    arrays: Sequence[torch.Tensor], n_words: int, run_len: int
) -> list[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    words, payloads = radix_sort.sort_words_plain(
        list(arrays[:n_words]), list(arrays[n_words:])
    )
    return words + payloads


def merge_sorted_runs(
    arrays: Sequence[torch.Tensor], n_words: int, run_len: int
) -> list[torch.Tensor]:
    """Merge S = N/run_len ascending sorted runs into one ascending array.

    arrays: W key-word tensors (lexicographic, unsigned) followed by payload
    tensors, all 1-D int32 of the same length N. Returns the merged tensors;
    the inputs are not modified. On the card only the first pass reads them:
    a caller that holds no other reference to them (a list built in the
    call) gives their memory back as soon as that pass has been queued.
    """
    arrays = list(arrays)
    if not 1 <= n_words <= MAX_KEY_WORDS or not n_words <= len(arrays) <= MAX_ROWS:
        raise ValueError(f"need 1..{MAX_KEY_WORDS} key words and at most "
                         f"{MAX_ROWS} rows, got {n_words} of {len(arrays)}")
    n = arrays[0].shape[0]
    for a in arrays:
        if a.dtype != torch.int32 or a.dim() != 1 or a.shape[0] != n:
            raise ValueError("every row must be a 1-D int32 tensor of one length")
        if a.device != arrays[0].device:
            raise ValueError("every row must lie on one device")
    assert n % run_len == 0, (n, run_len)
    s = n // run_len
    assert run_len & (run_len - 1) == 0, run_len
    assert s & (s - 1) == 0, s
    if s == 1:
        return arrays
    if arrays[0].device.type == "cpu":
        return merge_sorted_runs_plain(arrays, n_words, run_len)
    if arrays[0].device.type != "cuda":
        raise ValueError(f"unsupported device {arrays[0].device}")
    if n >= 2**31:
        raise ValueError(f"merge takes n < 2^31, got {n}")
    del a  # the loop's reference to the last row
    return _merge_cuda(arrays, n_words, run_len)


@functools.lru_cache(maxsize=16)
def _plan_on_device(
    dev: torch.device, n: int, run_len: int, tile: int, fan_in: int
) -> tuple[list[MergePass], torch.Tensor, list[int]]:
    """The passes over n / run_len runs, and every pass's bounds and
    group_tiles in one device tensor with each array's offset in it. Kept
    per shape: a call of a shape met before uploads nothing."""
    passes = merge_plan(np.arange(0, n + 1, run_len), tile, fan_in)
    parts = [a for p in passes for a in (p.bounds, p.group_tiles)]
    table = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    offsets = np.cumsum([0] + [a.shape[0] for a in parts]).tolist()
    return passes, table, offsets


def _merge_cuda(
    arrays: list[torch.Tensor], n_words: int, run_len: int
) -> list[torch.Tensor]:
    """Takes `arrays` over: the list is emptied, so that this frame's `rows`
    is the port's last reference to the first pass's input."""
    rows = [a.contiguous() for a in arrays]
    arrays.clear()
    dev = rows[0].device
    n = rows[0].shape[0]
    n_rows = len(rows)
    passes, table, offsets = _plan_on_device(dev, n, run_len, TILE, FAN_IN)
    lib = _build.lib()
    # Each tile boundary's split: one int32 per run of its group.
    part = torch.empty(
        max((p.num_tiles + p.n_groups) * min(FAN_IN, p.n_runs) for p in passes),
        dtype=torch.int32, device=dev,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    src, spare = rows, None
    del rows
    base = table.data_ptr()
    with torch.cuda.device(dev):
        for i, p in enumerate(passes):
            # The first pass reads the caller's rows; later passes ping-pong
            # between two buffers.
            dst = spare if spare is not None else list(
                torch.empty((n_rows, n), dtype=torch.int32, device=dev).unbind(0)
            )
            status = lib.hk_merge_pass(
                _build.pointer_array(src), _build.pointer_array(dst),
                n_words, n_rows,
                base + 4 * offsets[2 * i], p.n_runs,
                base + 4 * offsets[2 * i + 1], p.n_groups,
                FAN_IN, TILE, p.num_tiles, part.data_ptr(), stream,
            )
            _build.check(status, "merge pass launch")
            spare = src if i > 0 else None
            src = dst
    _build.launches["merge_runs"] += 1
    return src
