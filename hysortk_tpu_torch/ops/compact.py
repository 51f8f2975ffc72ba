"""The result stage on the device: the kept rows of a sorted, counted block
compacted in slot order, unmixed, narrowed and binned in one pass
(`compact_kept`), a histogram of a row of counts (`counts_histogram`), and
the kept runs' occurrences laid end to end (`gather_runs`).

No TPU kernel: the JAX package compacts on the host and in XLA
(hysortk_tpu/pipeline.py compact_keys, host_histogram, device_compact,
assemble_ext_result; ops/mixkey.py unmix_keys_np). On a CUDA tensor each
function launches csrc/kept_rows.cu (`_build.launches["kept_rows"]`,
`["gather_runs"]`); on a CPU tensor it runs its plain version
(`compact_kept_plain`, `counts_histogram_plain`, `gather_runs_plain`: the
torch.nonzero, index gather, stack, cast, bincount and repeat_interleave
chains the port ran before the kernels). Nothing moves between devices by
itself, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from .. import _build
from . import mixkey

# The counts' bound where they are not narrowed (cfg.unfiltered's, and the
# streams' unfiltered passes).
UNBOUNDED = 2**31 - 1


@dataclasses.dataclass
class Kept:
    """The kept rows of a compaction, where they lie.

    keys     (length, W) int32 rows, or W (length,) int32 rows (`rows=True`):
             the kept rows' key words in slot order (unmixed where asked),
             then the sentinel tail (-1) up to the output length
    counts   (length,) their counts, narrowed to `upper` (narrow_dtype),
             then 0s
    m        the kept rows: an int, or a 0-d int64 device tensor where the
             compaction did not sync
    hist     (hist_upper + 1,) int64 histogram of the kept counts, or None
    slots    (m,) int32 the kept slots, or None
    offsets  (m,) int32 each kept run's first occurrence among the kept
             runs' occurrences end to end (the exclusive prefix sum of the
             counts), or None
    occ      the kept counts' sum where offsets were asked, else 0
    """

    keys: torch.Tensor | list[torch.Tensor]
    counts: torch.Tensor
    m: int | torch.Tensor
    hist: torch.Tensor | None = None
    slots: torch.Tensor | None = None
    offsets: torch.Tensor | None = None
    occ: int = 0


def narrow_dtype(upper: int) -> torch.dtype:
    """The narrowest dtype FILTERED counts bounded by `upper` fit, for the
    host copy: uint8 for U <= 255, uint16 for U <= 65535 (the reference's
    own count bound, compiletime.h:21), else int32. Every kept count is <=
    upper by the frequency filter, so the cast is exact; a caller widens
    back to int32 on the host."""
    if upper <= 0xFF:
        return torch.uint8
    if upper <= 0xFFFF:
        return torch.uint16
    return torch.int32


def counts_histogram_plain(counts: torch.Tensor, upper: int) -> torch.Tensor:
    """hist[c] = the number of counts equal to c, c in [0, upper]: (upper +
    1,) int64 by one torch.bincount. A count above upper (cfg.unfiltered's
    results) is clamped to upper + 1, a bin the slice drops, so the bincount
    is sized by upper, never by the unfiltered bound."""
    kept = counts.to(torch.int64).clamp(max=upper + 1)
    return torch.bincount(kept, minlength=upper + 2)[: upper + 1]


def counts_histogram(counts: torch.Tensor, upper: int) -> torch.Tensor:
    """`counts_histogram_plain` where the counts lie: on the card the
    histogram-only launch of csrc/kept_rows.cu (every count binned, no row
    written)."""
    _check_upper(upper)
    if counts.device.type == "cpu":
        return counts_histogram_plain(counts, upper)
    _require_cuda(counts)
    counts = counts.to(torch.int32).contiguous()
    hist = torch.empty(upper + 1, dtype=torch.int64, device=counts.device)
    with torch.cuda.device(counts.device):
        status = _build.lib().hk_count_histogram(
            counts.data_ptr(), counts.shape[0], hist.data_ptr(), upper,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "kept_rows histogram launch")
    _build.launches["kept_rows"] += 1
    return hist


def _check_upper(upper: int) -> None:
    if not 0 <= upper < UNBOUNDED:
        raise ValueError(f"a histogram's bound must lie in [0, 2^31 - 1), got {upper}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def _check(words, cnt, keep, hist_upper, slots, offsets, pad, sync) -> None:
    if not 1 <= len(words) <= mixkey.MAX_WORDS:
        raise ValueError(f"need 1..{mixkey.MAX_WORDS} key words, got {len(words)}")
    n = keep.shape[0]
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise ValueError("keep must be a 1-D bool tensor")
    if n >= 2**31:
        raise ValueError(f"a compaction takes fewer than 2^31 slots, got {n}")
    for t in (*words, cnt):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError("every key word and the counts must be (n,) int32 tensors")
    if len({t.device for t in (*words, cnt, keep)}) > 1:
        raise ValueError("the key words, counts and keep must lie on one device")
    if hist_upper is not None:
        _check_upper(hist_upper)
    if pad < 1:
        raise ValueError(f"pad must be at least 1, got {pad}")
    if not sync and (slots or offsets or pad != 1):
        raise ValueError("a compaction that does not sync has no slots, offsets or pad")


def _length(m: int, pad: int, n: int) -> int:
    length = -(-m // pad) * pad
    if length > n:
        raise ValueError(f"{m} kept rows padded to {pad} exceed the block's {n} slots")
    return length


def compact_kept_plain(words: Sequence[torch.Tensor], cnt: torch.Tensor, keep: torch.Tensor,
                       *, upper: int = UNBOUNDED, mixed: bool = False,
                       hist_upper: int | None = None, slots: bool = False,
                       offsets: bool = False, rows: bool = False, pad: int = 1,
                       sync: bool = True) -> Kept:
    """The plain version of `compact_kept`, on any device: torch.nonzero,
    an index gather a word (mixkey.unmix_keys where `mixed`), the narrowing
    cast, counts_histogram_plain, a cumsum for the offsets."""
    words = list(words)
    _check(words, cnt, keep, hist_upper, slots, offsets, pad, sync)
    n = keep.shape[0]
    idx = torch.nonzero(keep).squeeze(1)
    m = int(idx.shape[0])
    kept_cnt = cnt[idx]
    key_rows = [w[idx] for w in words]
    if mixed:
        key_rows = mixkey.unmix_keys(key_rows)
    length = _length(m, pad, n) if sync else n
    if length > m:
        tail = length - m
        key_rows = [torch.cat([r, r.new_full((tail,), -1)]) for r in key_rows]
        counts = torch.cat([kept_cnt, kept_cnt.new_zeros(tail)])
    else:
        counts = kept_cnt
    wide = kept_cnt.to(torch.int64)
    return Kept(
        keys=key_rows if rows else torch.stack(key_rows, dim=-1),
        counts=counts.to(narrow_dtype(upper)),
        m=m if sync else torch.tensor(m, dtype=torch.int64, device=keep.device),
        hist=None if hist_upper is None else counts_histogram_plain(kept_cnt, hist_upper),
        slots=idx.to(torch.int32) if slots else None,
        offsets=(torch.cumsum(wide, 0) - wide).to(torch.int32) if offsets else None,
        occ=int(wide.sum()) if offsets else 0,
    )


def compact_kept(words: Sequence[torch.Tensor], cnt: torch.Tensor, keep: torch.Tensor,
                 *, upper: int = UNBOUNDED, mixed: bool = False,
                 hist_upper: int | None = None, slots: bool = False,
                 offsets: bool = False, rows: bool = False, pad: int = 1,
                 sync: bool = True) -> Kept:
    """The rows where `keep` holds, of W (n,) int32 sorted key words (uint32
    bit patterns) and their (n,) int32 counts, in slot order, as a Kept:
    the keys unmixed where `mixed` (range routing: mixkey.unmix_keys), the
    counts narrowed to `upper`, their histogram over [0, hist_upper] where
    asked, the kept slots and the runs' occurrence offsets where asked.
    The output is as long as the kept rows, rounded up to a multiple of
    `pad` with the sentinel tail; with sync=False it is n long and the kept
    rows' number stays on the device (nothing is read on the host).

    On the card two launches of csrc/kept_rows.cu, one host read of the
    kept rows' number between them (none with sync=False); the kept counts'
    sum must stay below 2^31 where offsets are asked (so it does for the
    runs of one block: the counts of its distinct runs)."""
    words = list(words)
    if keep.device.type == "cpu":
        return compact_kept_plain(words, cnt, keep, upper=upper, mixed=mixed,
                                  hist_upper=hist_upper, slots=slots, offsets=offsets,
                                  rows=rows, pad=pad, sync=sync)
    _require_cuda(keep)
    _check(words, cnt, keep, hist_upper, slots, offsets, pad, sync)
    return _compact_cuda([w.contiguous() for w in words], cnt.contiguous(),
                         keep.contiguous(), upper, mixed, hist_upper, slots, offsets,
                         rows, pad, sync)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _compact_cuda(words, cnt, keep, upper, mixed, hist_upper, slots, offsets, rows, pad,
                  sync) -> Kept:
    dev = keep.device
    n = keep.shape[0]
    n_words = len(words)
    lib = _build.lib()
    # The head holds the header (the kept rows and their occurrences) and the
    # histogram, which are returned as views of it (the kept rows' number
    # where the call does not sync); the scratch the count launch's
    # look-back and the tiles' prefixes. Every piece of host work but the
    # outputs' allocation comes before the host read, which the count's
    # entry point makes itself.
    bins = -1 if hist_upper is None else hist_upper
    head = torch.empty(2 + bins + 1, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.hk_kept_rows_scratch(n), dtype=torch.uint8, device=dev)
    mask = torch.empty(lib.hk_kept_mask_bytes(n), dtype=torch.uint8, device=dev)
    word_ptrs = _build.pointer_array(words)
    rc, rounds, fix = mixkey.kernel_consts(n_words) if mixed else (None, 0, None)
    header = (ctypes.c_int64 * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hk_kept_count(keep.data_ptr(), cnt.data_ptr() if offsets else None, n,
                                   head.data_ptr(), bins, scratch.data_ptr(), mask.data_ptr(),
                                   stream, header if sync else None)
        _build.check(status, "kept_rows count launch")
        if sync:
            m, occ = header
            length = _length(m, pad, n)
        else:
            m, occ, length = head[0], 0, n
        keys = torch.empty((n_words, length) if rows else (length, n_words),
                           dtype=torch.int32, device=dev)
        counts = torch.empty(length, dtype=narrow_dtype(upper), device=dev)
        slot_t = torch.empty(m, dtype=torch.int32, device=dev) if slots else None
        offs_t = torch.empty(m, dtype=torch.int32, device=dev) if offsets else None
        row_stride, word_stride = (1, length) if rows else (n_words, 1)
        status = lib.hk_kept_write(
            mask.data_ptr(), word_ptrs, n_words, cnt.data_ptr(), n, head.data_ptr(),
            scratch.data_ptr(), keys.data_ptr(), row_stride, word_stride, length,
            counts.data_ptr(), counts.element_size(), _ptr(slot_t), _ptr(offs_t), rc, rounds,
            fix, bins, stream)
    _build.check(status, "kept_rows write launch")
    _build.launches["kept_rows"] += 1
    return Kept(keys=list(keys.unbind(0)) if rows else keys, counts=counts, m=m,
                hist=None if hist_upper is None else head[2:], slots=slot_t, offsets=offs_t,
                occ=occ)


def gather_runs_plain(starts: torch.Tensor, lengths: torch.Tensor, *arrays: torch.Tensor
                      ) -> list[torch.Tensor]:
    """The plain version of `gather_runs`: one index gather an array, the
    index by cumsum, repeat_interleave and arange (one device sync for the
    total)."""
    lengths = lengths.to(torch.int64)
    starts = starts.to(torch.int64)
    ends = torch.cumsum(lengths, 0)
    total = int(ends[-1]) if lengths.shape[0] else 0
    # Element j of the runs laid end to end sits at starts[run] + (j - the
    # first j of the run).
    slot = torch.repeat_interleave(starts - (ends - lengths), lengths, output_size=total)
    slot += torch.arange(total, device=slot.device)
    return [a[slot] for a in arrays]


def gather_runs(starts: torch.Tensor, lengths: torch.Tensor, *arrays: torch.Tensor,
                offsets: torch.Tensor | None = None, total: int | None = None
                ) -> list[torch.Tensor]:
    """The runs a[starts[j]:starts[j] + lengths[j]] of each of one or two
    int32 arrays, laid end to end in j order. `offsets` ((m,) int32, the
    exclusive prefix sum of the lengths) and `total` (their sum), where the
    caller has them (compact_kept's offsets and occ), save the card a scan
    and a host read; else the wrapper takes them (one sync). Fewer than 2^31
    occurrences in all. On the card one launch of csrc/kept_rows.cu."""
    if not 1 <= len(arrays) <= 2:
        raise ValueError(f"gather_runs takes one or two arrays, got {len(arrays)}")
    if starts.shape != lengths.shape or starts.dim() != 1:
        raise ValueError("starts and lengths must be 1-D tensors of one length")
    if starts.device.type == "cpu":
        return gather_runs_plain(starts, lengths, *arrays)
    _require_cuda(starts)
    dev = starts.device
    for a in arrays:
        if a.dtype != torch.int32 or a.dim() != 1 or a.device != dev:
            raise ValueError("gather_runs' arrays must be 1-D int32 tensors on the runs' "
                             "device")
    m = starts.shape[0]
    if offsets is None:
        wide = lengths.to(torch.int64)
        ends = torch.cumsum(wide, 0)
        total = int(ends[-1]) if m else 0
        offsets = (ends - wide).to(torch.int32)
    elif total is None or offsets.shape != (m,):
        raise ValueError("offsets come with their total, one a run")
    if not 0 <= total < 2**31:
        raise ValueError(f"gather_runs takes fewer than 2^31 occurrences, got {total}")
    outs = [torch.empty(total, dtype=torch.int32, device=dev) for _ in arrays]
    if total == 0:
        return outs
    srcs = [a.contiguous() for a in arrays]
    starts32 = starts.to(torch.int32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        status = _build.lib().hk_gather_runs(
            starts32.data_ptr(), offsets.data_ptr(), m, total, _build.pointer_array(srcs),
            _build.pointer_array(outs), len(srcs), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "gather_runs launch")
    _build.launches["gather_runs"] += 1
    return outs
