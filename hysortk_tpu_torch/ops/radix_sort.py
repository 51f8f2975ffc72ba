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

`formulation="roll"` is the port of the JAX sort's other formulation
(pallas_sort.sort_words(formulation="roll"): block_bitonic_sort, then the
merge levels): the rows are padded with the sentinel to B * 2^m slots, every
B-slot block is sorted by ops/block_sort.block_bitonic_sort, the sorted
blocks are merged by ops/merge.merge_sorted_runs, and the pad is cut off.
Both steps are stable, so it returns what "member" returns, payloads too.
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
    words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = (),
    formulation: str = "member", block: int | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Sort (N,) int32 key words lexicographically (unsigned, word 0 most
    significant), ascending and stable, carrying (N,) int32 payload words.
    Returns (sorted_words, sorted_payloads); the inputs are not modified.

    formulation: "member" is the radix sort, "roll" the block sort followed
    by the run merge, in blocks of `block` slots (block_sort.DEFAULT_BLOCK
    when None; "member" has no blocks)."""
    if formulation not in ("member", "roll"):
        raise ValueError(f"formulation must be 'member' or 'roll', got "
                         f"{formulation!r}")
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
    if formulation == "roll":
        return _sort_words_roll(words, payloads, block)
    if words[0].device.type == "cpu":
        return sort_words_plain(words, payloads)
    if words[0].device.type != "cuda":
        raise ValueError(f"unsupported device {words[0].device}")
    return _sort_words_cuda(words, payloads)


def _sort_words_roll(
    words: list[torch.Tensor], payloads: list[torch.Tensor], block: int | None
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Block sort + run merge; each step takes its kernel on a CUDA tensor
    and its plain version on a CPU tensor."""
    from . import block_sort, merge

    n_keys = len(words)
    n = words[0].shape[0]
    if n == 0:
        return words, payloads
    if block is None:
        block = block_sort.DEFAULT_BLOCK
    # Pad with the sentinel to block * 2^m: the merge wants a power-of-two
    # count of runs. The pad sorts last, and after every real sentinel slot
    # since both steps are stable, so cutting it off is exact.
    n_blocks = -(-n // block)
    n_pad = block * (1 << (n_blocks - 1).bit_length())
    rows = words + payloads
    if n_pad != n:
        pad = torch.full((n_pad - n,), -1, dtype=torch.int32, device=rows[0].device)
        rows = [torch.cat([r, pad]) for r in rows]
    rows = block_sort.block_bitonic_sort(rows, n_keys, block, descending_odd=False)
    rows = merge.merge_sorted_runs(rows, n_keys, block)
    rows = [r[:n] for r in rows]
    return rows[:n_keys], rows[n_keys:]


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
