"""Sort of every fixed-size block of multiword keys with payloads: phase A of
the block-sort-then-merge formulation of the sort.

The port of hysortk_tpu/ops/pallas_sort.py block_bitonic_sort. On a CUDA
tensor the wrapper launches the hand-written kernel csrc/block_sort.cu (one
thread block per tile, a bitonic network over (key, source index) pairs in
shared memory); on a CPU tensor it runs the plain version, a chain of stable
torch.sort passes along each block, last word first.

Words are int32 tensors holding uint32 bit patterns and sort as unsigned.
Both versions are stable, and a descending block is the reverse of its
stable ascending order, so they compare exactly, payload rows included. The
JAX kernel is an unstable network: against it key rows compare exactly and
(key, payload) pairs as per-block multisets.

With `descending_odd` the blocks alternate ascending and descending, which
is what the JAX kernel computes (the orientation its bitonic merge levels
expect). The port's merge (ops/merge.py) is a merge-path merge and wants
ascending runs, so the sort path (radix_sort.sort_words, formulation="roll")
passes False.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from .kmer import widen

MAX_KEY_WORDS = 6
MAX_ROWS = 8  # key words + payload words
# What a thread block may use of an H100's shared memory (227 KB); the
# kernel keeps W + 1 words per slot of a tile there.
SHARED_BYTES = 232_448
DEFAULT_BLOCK = 2048


def max_block(n_words: int) -> int:
    """The largest block (a power of two) whose tile the kernel can hold."""
    slots = SHARED_BYTES // (4 * (n_words + 1))
    return 1 << (slots.bit_length() - 1)


def block_bitonic_sort_plain(
    arrays: Sequence[torch.Tensor], n_words: int, block: int,
    descending_odd: bool = True,
) -> list[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    n = arrays[0].shape[0]
    n_blocks = n // block
    dev = arrays[0].device
    perm = torch.arange(block, device=dev).repeat(n_blocks, 1)
    for w in reversed(arrays[:n_words]):
        keys = torch.gather(widen(w).view(n_blocks, block), 1, perm)
        order = torch.sort(keys, dim=1, stable=True).indices
        perm = torch.gather(perm, 1, order)
    if descending_odd:
        perm[1::2] = perm[1::2].flip(1)
    return [
        torch.gather(a.view(n_blocks, block), 1, perm).view(n) for a in arrays
    ]


def block_bitonic_sort(
    arrays: Sequence[torch.Tensor], n_words: int, block: int,
    descending_odd: bool = True,
) -> list[torch.Tensor]:
    """Sort every `block`-slot block of the rows by its first n_words rows.

    arrays: n_words key-word tensors (lexicographic, unsigned, word 0 most
    significant) followed by payload tensors, all 1-D int32 of one length N,
    a multiple of `block`; `block` is a power of two of at most
    max_block(n_words) slots. Block b comes out ascending and stable, or,
    when b is odd and `descending_odd` is set, as the reverse of that.
    Returns new tensors; the inputs are not modified.
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
    if block < 2 or block & (block - 1) or n % block:
        raise ValueError(f"block must be a power of two >= 2 that divides the "
                         f"length, got block {block} for length {n}")
    if block > max_block(n_words):
        raise ValueError(f"a block of {block} slots of {n_words} key words does "
                         f"not fit the kernel's shared memory (at most "
                         f"{max_block(n_words)})")
    if arrays[0].device.type == "cpu":
        return block_bitonic_sort_plain(arrays, n_words, block, descending_odd)
    if arrays[0].device.type != "cuda":
        raise ValueError(f"unsupported device {arrays[0].device}")
    if n >= 2**31:
        raise ValueError(f"block sort takes n < 2^31, got {n}")
    return _block_sort_cuda(
        [a.contiguous() for a in arrays], n_words, block, descending_odd
    )


def _block_sort_cuda(
    rows: list[torch.Tensor], n_words: int, block: int, descending_odd: bool
) -> list[torch.Tensor]:
    dev = rows[0].device
    n = rows[0].shape[0]
    out = list(
        torch.empty((len(rows), n), dtype=torch.int32, device=dev).unbind(0)
    )
    if n == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(dev):
        status = lib.hk_block_sort(
            _build.pointer_array(rows), _build.pointer_array(out),
            n_words, len(rows), n, block, int(descending_odd),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "block sort launch")
    _build.launches["block_sort"] += 1
    return out
