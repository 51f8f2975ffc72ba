"""Merge of pre-sorted equal-length runs: the other kernel of the streaming
merge.

The port of hysortk_tpu/ops/merge.py merge_sorted_runs and of the kernel it
reaches on the TPU, pallas_sort.merge_runs. Per-batch partial lists arrive
as S already-sorted runs of length L (sentinel-padded); re-sorting them would
repeat work the batches already paid for. On a CUDA tensor the wrapper runs
log2(S) passes of the hand-written merge-path kernels of csrc/merge_runs.cu,
each merging neighbouring pairs of runs; on a CPU tensor it runs the plain
version, a stable sort of the concatenation (radix_sort.sort_words_plain).

Both versions are stable (on equal keys the earlier run's rows come first),
so they compare exactly, payloads included. The JAX merge is a bitonic
network and unstable: against it, key rows compare exactly and payloads as
per-key sums. The network's run orientation (`flip_odd_runs`) has no
counterpart here.

Requirements, as in the JAX package: run length L and run count S are powers
of two; runs are ascending with the all-ones sentinel (ops/sort.py) in their
tail slots.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from . import radix_sort

MAX_KEY_WORDS = radix_sort.MAX_KEY_WORDS
MAX_ROWS = radix_sort.MAX_ROWS


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


def _merge_cuda(
    arrays: list[torch.Tensor], n_words: int, run_len: int
) -> list[torch.Tensor]:
    """Takes `arrays` over: the list is emptied, so that this frame's `rows`
    is the port's last reference to the first pass's input."""
    rows = [a.contiguous() for a in arrays]
    arrays.clear()
    dev = rows[0].device
    n = rows[0].shape[0]
    lib = _build.lib()
    scratch = torch.empty(
        lib.hk_merge_pass_scratch(n, run_len), dtype=torch.int32, device=dev
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_rows = len(rows)
    src, spare = rows, None
    del rows
    length = run_len
    with torch.cuda.device(dev):
        while length < n:
            # The first pass reads the caller's rows; later passes ping-pong
            # between two buffers.
            dst = spare if spare is not None else list(
                torch.empty((n_rows, n), dtype=torch.int32, device=dev).unbind(0)
            )
            status = lib.hk_merge_pass(
                _build.pointer_array(src), _build.pointer_array(dst),
                n_words, n_rows, n, length, scratch.data_ptr(), stream,
            )
            _build.check(status, "merge pass launch")
            spare = src if length > run_len else None
            src = dst
            length *= 2
    _build.launches["merge_runs"] += 1
    return src
