"""The single-device wire feed and result of the port against the JAX
package, on the CPU: the host library's 2-bit pack into a caller's buffer
(a count of codes and a count of words), the feed helper
(`pipeline.feed_wire`, `wire_batch`) against the inputs the JAX count_reads
builds, the histogram computed on the device (`device_histogram`) against
`host_histogram` and the JAX one, the streaming step whose kept row count
stays on the device, and the host-held streaming merge laid out on the
device against the JAX merge. Exact equality throughout. The tests marked
`cuda` run the same on the card: the feed staged through pinned memory and
the step making no host read."""

import dataclasses
import tracemalloc

import numpy as np
import pytest
import torch

import hysortk_tpu
from hysortk_tpu import pipeline as jpipeline
from hysortk_tpu import testing as oracle
from hysortk_tpu.io import supermer as jsupermer
from hysortk_tpu.runtime import scheduler as jsched
from hysortk_tpu_torch import config, pipeline
from hysortk_tpu_torch.io import fasta as fasta_io
from hysortk_tpu_torch.io import native, supermer
from hysortk_tpu_torch.ops import compact
from hysortk_tpu_torch.runtime import scheduler

THREADS = [1, 2, 7]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def binned(monkeypatch):
    """The histograms the port's result stage bins, one entry each: its
    plain version (ops/compact.counts_histogram_plain), which CPU tensors
    take."""
    calls = []
    real = compact.counts_histogram_plain

    def spy(counts, upper):
        calls.append(upper)
        return real(counts, upper)

    monkeypatch.setattr(compact, "counts_histogram_plain", spy)
    return calls


def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    return before


def _cfgs(k=31, **kw):
    fields = dict(k=k, m=min(17, k - 1), lower=2, upper=50, pad_multiple=256)
    fields.update(kw)
    j = hysortk_tpu.KmerConfig(**fields)
    return config.from_jax_fields(dataclasses.asdict(j)), j


def _reads(seed, n=30, lo=0, hi=120, repeat=12):
    rng = np.random.default_rng(seed)
    reads = oracle.random_reads(rng, n, lo, hi, "ACGTNacgt")
    return reads + reads[:repeat]


def _jax_words(codes: np.ndarray, words: int) -> np.ndarray:
    """The JAX package's pack of the codes zero-padded to `words` words."""
    buf = np.zeros(16 * words, np.int8)
    buf[: codes.size] = codes
    return jsupermer.pack_codes_2bit(buf)


# ---------------------------------------------------------------------------
# The library's pack into a caller's buffer


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", list(range(101)) + [1 << 20])
def test_pack_into_buffer_matches_plain_and_jax(n, threads):
    """Any count of codes into ceil(n/16) words and into three more: the
    codes packed, every word past them zero (a partial last word too),
    whatever the buffer held before; int8 and uint8 codes, uint32 and int32
    buffers."""
    rng = np.random.default_rng(1000 * n + threads)
    codes = rng.integers(0, 4, n).astype(np.int8)
    before = _threads(threads)
    try:
        for words in (-(-n // 16), -(-n // 16) + 3):
            want = _jax_words(codes, words)
            plain = supermer.pack_codes_2bit_plain(codes)
            assert np.array_equal(want[: plain.size], plain) and not want[plain.size:].any()
            for src, dtype in ((codes, np.uint32), (codes.view(np.uint8), np.int32)):
                out = np.full(words, -0x55555556 if dtype == np.int32 else 0xAAAAAAAA, dtype)
                got = native.pack_2bit(src, out)
                assert got is out
                assert np.array_equal(out.view(np.uint32), want)
                routed = np.full(words, 7, dtype)
                supermer.pack_codes_2bit_into(src, routed)
                assert np.array_equal(routed.view(np.uint32), want)
    finally:
        torch.set_num_threads(before)


def test_pack_into_buffer_reads_the_codes_in_place():
    """int8 and uint8 codes are read where they lie: the pack allocates
    nothing near the size of the codes."""
    codes = np.random.default_rng(3).integers(0, 4, 1 << 22).astype(np.int8)
    out = np.empty((1 << 22) // 16 + 1, np.uint32)
    native.pack_2bit(codes, out)  # the library loaded before measuring
    for src in (codes, codes.view(np.uint8)):
        tracemalloc.start()
        native.pack_2bit(src, out)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert peak < 1 << 16, peak
    assert np.array_equal(out, _jax_words(codes, out.size))


def test_pack_into_buffer_refuses_a_short_or_odd_buffer():
    codes = np.zeros(33, np.int8)
    with pytest.raises(ValueError):
        native.pack_2bit(codes, np.empty(2, np.uint32))
    with pytest.raises(ValueError):
        native.pack_2bit(codes, np.empty(3, np.int64))
    with pytest.raises(ValueError):
        native.pack_2bit(codes, np.empty((3, 1), np.uint32))
    with pytest.raises(ValueError):
        native.pack_2bit(codes)  # without a buffer: a multiple of 16 only


# ---------------------------------------------------------------------------
# The feed helper


@pytest.mark.parametrize("route", ["native", "plain"])
@pytest.mark.parametrize("kind", ["reads", "ragged", "empty", "zero_length"])
@pytest.mark.parametrize("pad", [16, 256])
def test_feed_matches_jax_count_reads_inputs(monkeypatch, route, kind, pad):
    """wire_batch's (packed, lens, n) against what the JAX count_reads
    builds: the codes zero-padded to n = ceil((total + 16) / pad) * pad,
    packed, and the lengths as int32."""
    if route == "plain":
        monkeypatch.setattr(native, "available", lambda: False)
    if kind == "empty":
        reads = []
    elif kind == "zero_length":
        reads = ["", "ACGT" * 9, "", ""]
    else:
        reads = _reads(5 if kind == "reads" else 6)
    codes, lengths = fasta_io.reads_to_codes(reads)
    if kind == "ragged":
        assert codes.size % 16
    cfg, _ = _cfgs(pad_multiple=pad)
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, "cpu")
    total = int(codes.size)
    assert n == -(-(total + 16) // pad) * pad
    assert packed.dtype == torch.int32 and packed.shape == (n // 16,)
    assert np.array_equal(packed.numpy().view(np.uint32), _jax_words(codes, n // 16))
    assert lens.dtype == torch.int32
    assert np.array_equal(lens.numpy(), np.asarray(lengths).astype(np.int32))


def test_feed_pads_the_lengths_and_refuses_short_blocks():
    codes, lengths = fasta_io.reads_to_codes(_reads(7))
    n = -(-(codes.size + 16) // 16) * 16
    packed, lens = pipeline.feed_wire(codes, lengths, n, torch.device("cpu"),
                                      lmax=lengths.size + 5)
    assert lens.shape == (lengths.size + 5,)
    assert np.array_equal(lens.numpy()[: lengths.size], lengths)
    assert not lens.numpy()[lengths.size:].any()
    assert np.array_equal(packed.numpy().view(np.uint32), _jax_words(codes, n // 16))
    for bad in (n - 16, n + 8):
        with pytest.raises(ValueError):
            pipeline.feed_wire(codes, lengths, bad, torch.device("cpu"))


@pytest.mark.cuda
def test_feed_stages_through_pinned_memory(cuda, monkeypatch):
    """On the card the words and lengths cross from pinned staging, and
    arrive equal to the CPU device's feed."""
    staged = []
    real = pipeline.host_staging
    monkeypatch.setattr(pipeline, "host_staging",
                        lambda *a: staged.append(real(*a)) or staged[-1])
    codes, lengths = fasta_io.reads_to_codes(_reads(8))
    cfg, _ = _cfgs()
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, cuda)
    assert len(staged) == 2 and all(t.is_pinned() for t in staged)
    cpu_packed, cpu_lens, cpu_n = pipeline.wire_batch(codes, lengths, cfg, "cpu")
    assert n == cpu_n and torch.equal(packed.cpu(), cpu_packed)
    assert torch.equal(lens.cpu(), cpu_lens)


# ---------------------------------------------------------------------------
# The histogram on the device


@pytest.mark.parametrize("unfiltered", [False, True])
@pytest.mark.parametrize("upper", [1, 50, 255, 65535])
def test_device_histogram_matches_host_and_jax(upper, unfiltered, binned):
    """Random counts, kept by a mask, binned in kept_result's compaction;
    under `unfiltered` many exceed upper (up to 2**31 - 1) and fall outside
    the histogram, as host_histogram's slice drops them."""
    rng = np.random.default_rng(upper + unfiltered)
    n = 5000
    hi = 2**31 - 1 if unfiltered else upper + 1
    cnt = rng.integers(1, hi, n, dtype=np.int64).astype(np.int32)
    cnt[:40] = min(upper, 3)
    if unfiltered:
        cnt[40:80] = upper + 1
        cnt[80:90] = 2**31 - 1
    keep = rng.random(n) < 0.7
    words = [torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))]
    cfg, _ = _cfgs(lower=1, upper=upper)
    kl, got = pipeline.kept_result(words, torch.from_numpy(cnt), torch.from_numpy(keep),
                                   cfg, pipeline.UNFILTERED[1])
    assert len(binned) == 1
    assert np.array_equal(kl.counts, cnt[keep])
    want = pipeline.host_histogram(cnt[keep], upper)
    assert got.dtype == np.int32 and got.shape == (upper + 1,)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpipeline.host_histogram(cnt[keep], upper))
    _, empty = pipeline.kept_result(words, torch.from_numpy(cnt),
                                    torch.zeros(n, dtype=torch.bool), cfg,
                                    pipeline.UNFILTERED[1])
    assert empty.shape == (upper + 1,) and not empty.any()


@pytest.mark.parametrize("upper", [1, 50, 255, 65535])
def test_count_reads_histogram_comes_from_the_device(upper, binned):
    """count_reads and count_reads_ext (filtered and under cfg.unfiltered)
    return device_histogram's histogram, equal to the JAX package's."""
    codes, lengths = fasta_io.reads_to_codes(_reads(9, repeat=25))
    cfg, jcfg = _cfgs(lower=1, upper=upper)
    kl, hist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert len(binned) == 1
    jkl, jhist = jpipeline.count_reads(codes, lengths, jcfg)
    assert np.array_equal(kl.keys, jkl.keys) and np.array_equal(kl.counts, jkl.counts)
    assert np.array_equal(hist, jhist)
    for unfiltered in (False, True):
        ecfg = dataclasses.replace(cfg, extension=True, unfiltered=unfiltered)
        jecfg = dataclasses.replace(jcfg, extension=True, unfiltered=unfiltered)
        ekl, ehist = pipeline.count_reads_ext(codes, lengths, ecfg, 3, device="cpu")
        jekl, jehist = jpipeline.count_reads_ext(codes, lengths, jecfg, 3)
        assert np.array_equal(ehist, jehist)
        assert np.array_equal(ehist, pipeline.host_histogram(ekl.counts, upper))
        assert ekl.as_dict() == jekl.as_dict()
    assert len(binned) == 3


# ---------------------------------------------------------------------------
# The streaming step and the host-held merge


@pytest.mark.parametrize("k", [15, 31, 55])
def test_compact_step_keeps_n_kept_on_the_device(k):
    """_count_device_packed_compact: the kept rows as an ascending prefix,
    the sentinel (counts 0) after it, n_kept a 0-d tensor; equal to the JAX
    package's step."""
    codes, lengths = fasta_io.reads_to_codes(_reads(k, repeat=20))
    cfg, jcfg = _cfgs(k, lower=2, upper=9)
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, "cpu")
    words, counts, n_kept = pipeline._count_device_packed_compact(
        packed, lens, k, n, cfg.lower, cfg.upper)
    assert isinstance(n_kept, torch.Tensor) and n_kept.dim() == 0
    m = int(n_kept)
    assert 0 < m < n and all(w.shape == (n,) for w in words) and counts.shape == (n,)
    jwords, jcounts, jn = jpipeline._count_device_packed_compact(
        jpipeline.jnp.asarray(packed.numpy().view(np.uint32)),
        jpipeline.jnp.asarray(lens.numpy()), k, n, cfg.lower, cfg.upper,
        jcfg.sort_backend)
    assert int(jn) == m
    for w, jw in zip(words, jwords):
        assert np.array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    # The JAX tail carries the dropped runs' counts; the port's is zero.
    assert np.array_equal(counts.numpy()[:m], np.asarray(jcounts)[:m].astype(np.int32))
    assert all((w[m:] == -1).all() for w in words) and not counts[m:].any()
    pulled = pipeline.pull_prefix(list(words) + [counts], n_kept)
    kl, _ = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert np.array_equal(np.stack(pulled[:-1], axis=-1).view(np.uint32), kl.keys)
    assert np.array_equal(pulled[-1], kl.counts)


@pytest.mark.cuda
def test_compact_step_makes_no_host_read_on_cuda(cuda):
    """The same step on the card under torch's sync debug mode "error": a
    host read of a device value would raise."""
    codes, lengths = fasta_io.reads_to_codes(_reads(31, repeat=20))
    cfg, _ = _cfgs()
    packed, lens, n = pipeline.wire_batch(codes, lengths, cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words, counts, n_kept = pipeline._count_device_packed_compact(
            packed, lens, cfg.k, n, 1, 2**31 - 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = pipeline._count_device_packed_compact(
        packed.cpu(), lens.cpu(), cfg.k, n, 1, 2**31 - 1)
    assert int(n_kept) == int(want[2])
    assert all(torch.equal(w.cpu(), v) for w, v in zip(words, want[0]))
    assert torch.equal(counts.cpu(), want[1])


def _jax_partials(codes, lengths, jcfg, batch_bases):
    """The JAX package's per-batch unfiltered partial lists, as its
    scheduler makes them (host keys (M, W) uint32, counts uint32)."""
    batch_bases = jsched.snap_batch_to_pow2_flat(batch_bases, jcfg.pad_multiple)
    keys_out, cnts_out = [], []
    for b_codes, b_lengths in jsched.iter_read_batches(codes, lengths, batch_bases):
        n = -(-(max(b_codes.size, batch_bases) + 16) // jcfg.pad_multiple) \
            * jcfg.pad_multiple
        keys, cnt, keep = jpipeline._count_device_packed(
            jpipeline.jnp.asarray(_jax_words(b_codes, n // 16)),
            jpipeline.jnp.asarray(b_lengths.astype(np.int32)),
            jcfg.k, n, 1, 2**31 - 1, jcfg.sort_backend,
        )
        keep_np = np.asarray(keep)
        keys_out.append(jpipeline.compact_keys(keys, keep_np))
        cnts_out.append(np.asarray(cnt)[keep_np].astype(np.uint32))
    return keys_out, cnts_out


@pytest.mark.parametrize("upper", [50, 65535])
@pytest.mark.parametrize("k", [31, 55])
def test_host_list_merge_lays_out_on_the_device(monkeypatch, k, upper):
    """merge_partial_lists, single shot and key-range chunked, on the JAX
    package's partials (one of them empty): keys and counts equal to the
    JAX merge, its histogram to host_histogram's, and no numpy array of
    the padded (runs x run_len) layout built (np.full refused)."""
    codes, lengths = fasta_io.reads_to_codes(_reads(k + upper, n=40))
    cfg, jcfg = _cfgs(k, lower=1, upper=upper)
    parts_k, parts_c = _jax_partials(codes, lengths, jcfg, 700)
    parts_k.insert(2, np.zeros((0, cfg.words), np.uint32))
    parts_c.insert(2, np.zeros(0, np.uint32))
    assert len(parts_k) > 4
    want_k, want_c = jsched.merge_partial_lists(parts_k, parts_c, jcfg, 1 << 30)

    def refuse(*a, **kw):
        raise AssertionError("np.full called by the merge")

    for budget in (1 << 30, 256):
        with monkeypatch.context() as m:
            m.setattr(np, "full", refuse)
            got_k, got_c, got_h = scheduler.merge_partial_lists(
                parts_k, parts_c, cfg, budget, device="cpu")
        assert got_k.dtype == np.uint32 and got_c.dtype == np.int32
        assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
        assert got_h.dtype == np.int32
        assert np.array_equal(got_h, pipeline.host_histogram(want_c, upper))


def test_host_held_stream_equals_jax_with_device_histograms(binned):
    """count_reads_streaming on host-held partials: every batch's rows out
    through `to_host`, the merge's histogram from the device; equal to the
    JAX stream and to one-shot."""
    codes, lengths = fasta_io.reads_to_codes(_reads(13, n=40))
    cfg, jcfg = _cfgs(lower=1, upper=20)
    kl, hist = scheduler.count_reads_streaming(codes, lengths, cfg, 700, device="cpu")
    assert len(binned) == 1
    jkl, jhist = jsched.count_reads_streaming(codes, lengths, jcfg, 700)
    assert np.array_equal(kl.keys, jkl.keys) and np.array_equal(kl.counts, jkl.counts)
    assert np.array_equal(hist, jhist)
    one, one_hist = pipeline.count_reads(codes, lengths, cfg, device="cpu")
    assert np.array_equal(kl.keys, one.keys) and np.array_equal(hist, one_hist)
