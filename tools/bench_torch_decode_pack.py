#!/usr/bin/env python3
"""Check and time the wire decode (ops/wire.decode_block[_ext],
csrc/wire_decode.cu) and the supermer segment pack
(ops/supermer.pack_segments, csrc/supermer_pack.cu) on one CUDA card, for
one or more trees of the repository in turns.

    python3 tools/bench_torch_decode_pack.py [--tree DIR ...] [--rounds N]
                                             [--profile] [--reps N]

Run from the repository root on a machine with an sm_90 card and the CUDA
toolkit. Each `--tree` is a checkout of the repository (default: this
one), for example a parent commit unpacked with `git archive` into a
git-ignored directory; the turns run in the order given, that order
`--rounds` times (`--tree P --tree C --tree C --tree P` for parent,
change, change, parent). Each turn is a fresh process that imports the
tree's own package and builds its kernels first (the build is not timed).

A turn's inputs are those of `chip_smoke.py` phases 2 and 11(a), made from
a seed: 2^26 positions of random packed words under 447,392 reads of 150
bases (phase 2's wire); the decoded codes and validity under one
destination (the run layout of one bucket: 447,392 runs, one a read), and
under four (the minimizer scan's 12 buckets at m = 17, round robin over the
ranks). It prints one JSON line a turn with CUDA-event means of `--reps`
calls after one warm-up of:

  decode       the wrapper on phase 2's wire (codes and validity)
  decode_ext   the same in extension mode (read ids and positions too)
  pack         the pack of the one-destination layout (11(a)'s)
  received     the decode of that send tensor's segment, as the receive
               side reads it (strided rows, supermer lengths as reads)
  pack4 / pack4_ext  the pack at four destinations, without and with the
               extension-mode columns
  block_sort   csrc/block_sort.cu on the key build of the decode (2^26
               slots, W = 2, B = 2048: PERF.md's row 7)

each result checked exactly equal to its plain version first (any mismatch
raises), and beside each the host's microseconds a call (`*_host_us`: the
wrapper's time to return, launches queued, the card idle first). With
`--profile`, the turn also prints each measured call's device kernels by
torch.profiler (name, mean microseconds a call).
The card's name and power limit come first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 26
READS, READ_LEN, K, M = 447_392, 150, 31, 17
RID0 = 1_000_000


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds a call of fn takes to return (the card idle
    first, no synchronisation inside): what a caller pays before the
    launches are queued."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernels_us(fn, reps: int) -> dict:
    """Mean device microseconds a call of each kernel (and memset) fn runs,
    by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if dev_us:
            out[ev.key[:60]] = round(dev_us / reps, 2)
    return out


def child(reps: int, profile: bool) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.ops import block_sort, keybuild, minimizer, wire
    from hysortk_tpu_torch.ops import supermer as sm

    _build.lib()
    rng = np.random.default_rng(21)
    dev = torch.device("cuda")
    packed = torch.from_numpy(rng.integers(-2**31, 2**31, N // 16, dtype=np.int64)
                              .astype(np.int32)).to(dev)
    lens = torch.full((READS,), READ_LEN, dtype=torch.int32, device=dev)
    out: dict = {"tree": os.getcwd()}
    prof: dict = {}

    def measure(name, fn, plain, reps_=reps):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: differs from its plain version")
        out[name] = round(cuda_ms(fn, reps_), 5)
        out[f"{name}_host_us"] = round(host_us(fn, reps_), 1)
        if profile:
            prof[name] = kernels_us(fn, reps_)

    def decode():
        return wire.decode_block(packed, lens, K, N)

    def decode_ext():
        return wire.decode_block_ext(packed, lens, K, N, RID0)

    measure("decode", decode, lambda: wire.decode_block_plain(packed, lens, K, N))
    measure("decode_ext", decode_ext,
            lambda: wire.decode_block_ext_plain(packed, lens, K, N, RID0))
    codes, valid = decode()

    mk = sm.max_kmers(K)
    one = torch.zeros(N, dtype=torch.int32, device=dev)
    layout = sm.run_layout(valid, one, torch.zeros(1, dtype=torch.int32, device=dev), mk,
                           K, 1)
    dims = sm.segment_dims(layout.cmax, layout.smax, 1024)
    out["runs"] = layout.src.numel()
    measure("pack", lambda: [sm.pack_segments(codes, layout, *dims)],
            lambda: [sm.pack_segments_plain(codes, layout, *dims)])
    send = sm.pack_segments(codes, layout, *dims)
    block_len, lmax = dims
    nw = block_len // 16
    words, seg_lens = send[:, 0, :nw], send[:, 0, nw: nw + lmax]
    measure("received", lambda: wire.decode_block(words, seg_lens, K, block_len),
            lambda: wire.decode_block_plain(words, seg_lens, K, block_len))
    del send, words, seg_lens

    buckets = minimizer.kmer_destinations(codes, K, M, 12)
    assign = (torch.arange(12, dtype=torch.int32, device=dev) % 4)
    layout4 = sm.run_layout(valid, buckets, assign, mk, K, 4)
    dims4 = sm.segment_dims(layout4.cmax, layout4.smax, 1024)
    out["runs4"] = layout4.src.numel()
    headers = sm.run_headers(layout4.src, lens, RID0)
    measure("pack4", lambda: [sm.pack_segments(codes, layout4, *dims4)],
            lambda: [sm.pack_segments_plain(codes, layout4, *dims4)])
    measure("pack4_ext", lambda: [sm.pack_segments(codes, layout4, *dims4, headers)],
            lambda: [sm.pack_segments_plain(codes, layout4, *dims4, headers)])
    del layout4, headers, buckets

    marked = keybuild.canonical_keys_fused(codes, valid, K)
    w, block = len(marked), block_sort.DEFAULT_BLOCK
    measure("block_sort", lambda: block_sort.block_bitonic_sort(marked, w, block, False),
            lambda: block_sort.block_bitonic_sort_plain(marked, w, block, False), 5)
    out["launches"] = {k: v for k, v in _build.launches.items() if v}
    print(json.dumps(out), flush=True)
    if profile:
        print(json.dumps({"profile": prof}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps, args.profile)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--reps", str(args.reps)]
    if args.profile:
        cmd.append("--profile")
    for _ in range(args.rounds):
        for tree in trees:
            run = subprocess.run(cmd, cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
                                 capture_output=True, text=True)
            sys.stdout.write(run.stdout)
            if run.returncode:
                sys.stdout.write(run.stderr[-4000:])
                return run.returncode
            sys.stdout.flush()
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
