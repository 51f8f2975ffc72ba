"""Lexicographic sort of multiword keys with payloads: kernel 2 of the slice.

The port of hysortk_tpu/ops/pallas_sort.py sort_words (the member-tile
bitonic sort: pallas_msort.block_sort_member + pallas_sort.merge_levels).
On a CUDA tensor the wrapper launches the hand-written stable LSD radix sort
csrc/radix_sort.cu (8-bit digits, 4W passes, each a tile histogram, a scan
and a stable scatter); on a CPU tensor it runs the plain version, a chain of
stable torch.sort passes, last word first.

Words are int32 tensors holding uint32 bit patterns and sort as unsigned, so
the all-ones sentinel sorts last. Both versions are stable, so equal keys
keep their payloads in input order. The JAX sort is unstable; for a
keys-only sort, as on the counting path, the sorted keys are fully
determined and compare bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from .kmer import widen

MAX_KEY_WORDS = 6
MAX_ROWS = 8  # key words + payload words


def sort_words_plain(
    words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = ()
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The plain PyTorch version of the kernel, on any device."""
    n = words[0].shape[0]
    perm = torch.arange(n, device=words[0].device)
    for w in reversed(words):
        order = torch.sort(widen(w)[perm], stable=True).indices
        perm = perm[order]
    return [w[perm] for w in words], [p[perm] for p in payloads]


def sort_words(
    words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = ()
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Sort (N,) int32 key words lexicographically (unsigned, word 0 most
    significant), ascending and stable, carrying (N,) int32 payload words.
    Returns (sorted_words, sorted_payloads); the inputs are not modified."""
    words, payloads = list(words), list(payloads)
    rows = words + payloads
    if not 1 <= len(words) <= MAX_KEY_WORDS or len(rows) > MAX_ROWS:
        raise ValueError(f"need 1..{MAX_KEY_WORDS} key words and at most "
                         f"{MAX_ROWS} rows, got {len(words)} + {len(payloads)}")
    n = words[0].shape[0]
    for r in rows:
        if r.dtype != torch.int32 or r.dim() != 1 or r.shape[0] != n:
            raise ValueError("every word must be a 1-D int32 tensor of one length")
        if r.device != words[0].device:
            raise ValueError("every word must lie on one device")
    if words[0].device.type == "cpu":
        return sort_words_plain(words, payloads)
    if words[0].device.type != "cuda":
        raise ValueError(f"unsupported device {words[0].device}")
    return _sort_words_cuda(words, payloads)


def _sort_words_cuda(
    words: list[torch.Tensor], payloads: list[torch.Tensor]
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    n_keys = len(words)
    a = torch.stack(words + payloads)  # owned copy, sorted in place
    n = a.shape[1]
    if n == 0:
        rows = list(a.unbind(0))
        return rows[:n_keys], rows[n_keys:]
    if n >= 2**31:
        raise ValueError(f"radix sort takes n < 2^31, got {n}")
    lib = _build.lib()
    b = torch.empty_like(a)
    scratch = torch.empty(
        lib.hk_radix_sort_scratch(n), dtype=torch.int32, device=a.device
    )
    rows_a, rows_b = list(a.unbind(0)), list(b.unbind(0))
    with torch.cuda.device(a.device):
        status = lib.hk_radix_sort(
            _build.pointer_array(rows_a), _build.pointer_array(rows_b),
            n_keys, len(rows_a), n, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "radix sort launch")
    _build.launches["radix_sort"] += 1
    return rows_a[:n_keys], rows_a[n_keys:]
