"""Command-line interface: `python -m hysortk_tpu_torch.cli <fasta> [output_dir]`.

The port of hysortk_tpu/cli.py. Mirrors the reference standalone binary
(reference: standalone/main.cpp:9-72): prints the parameter block, runs
read -> count -> histogram -> output files, on one device, or across the
ranks of a process group, one device a rank: one-shot, streamed
(--stream-batch-bases), in extension mode, by any routing (--routing
supermer ships supermers; on one device it changes nothing, as in the JAX
CLI, and with --single-device it is an error).

Two ways to run across ranks:

  * under torchrun (WORLD_SIZE > 1) every rank reads the whole FASTA and
    counts its share of it; rank 0 prints the histogram and writes the one
    output file, as the JAX CLI's multi-device run writes one:

        torchrun --nproc-per-node 2 -m hysortk_tpu_torch.cli reads.fa out/ --device cpu

  * as the JAX CLI's multi-process run, one command a process joined at
    --coordinator (parallel/multihost.py; at any process count, one
    included): each process reads only its own records, keeps its own share
    of the result and writes it to <outdir>/<process id>.out; rank 0 prints
    the global histogram, and every rank's stage times are printed by rank
    0 in rank order:

        python -m hysortk_tpu_torch.cli reads.fa out/ --coordinator 127.0.0.1:29500 \
            --num-processes 2 --process-id 0 &
        python -m hysortk_tpu_torch.cli reads.fa out/ --coordinator 127.0.0.1:29500 \
            --num-processes 2 --process-id 1
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hysortk_tpu_torch",
        description="Sorting-based k-mer counter in PyTorch + CUDA",
    )
    p.add_argument("fasta", help="input FASTA file (a .fai is built if absent)")
    p.add_argument(
        "output_dir",
        nargs="?",
        default=None,
        help="directory for per-shard {kmer}\\t{count} files (omit to skip)",
    )
    p.add_argument("-k", type=int, default=31, help="k-mer size (default 31)")
    p.add_argument("-m", type=int, default=17, help="minimizer size (default 17)")
    p.add_argument("-l", "--lower", type=int, default=15,
                   help="lower frequency bound (default 15)")
    p.add_argument("-u", "--upper", type=int, default=40,
                   help="upper frequency bound (default 40)")
    p.add_argument("--device", default="cuda",
                   help="torch device to count on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a torch.profiler trace of the counting stage")
    p.add_argument("--device-compact", action="store_true",
                   help="when streaming, keep per-batch partial counts on "
                        "the device and copy only the final result out")
    p.add_argument("--single-device", action="store_true",
                   help="accepted for parity; this package counts on one "
                        "device")
    p.add_argument("--stream-batch-bases", type=int, default=0,
                   help="stream the input in device batches of this many "
                        "bases (0 = one shot unless the input does not fit); "
                        "bounds device memory usage")
    p.add_argument("--no-histogram", action="store_true")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the counting stage N times in one process "
                        "(timing: later runs measure the steady state "
                        "with the kernel build amortized)")
    p.add_argument(
        "--validate", action="store_true",
        help="after counting, cross-check the result against a brute-force "
             "host oracle (runtime sanitizer; inputs up to ~4 Mb)")
    p.add_argument("--extension", action="store_true",
                   help="EXT mode: track (ReadId, PosInRead) per occurrence")
    p.add_argument("--combiner", action="store_true",
                   help="across ranks, pre-aggregate local duplicates "
                        "before the exchange (no effect on one rank)")
    p.add_argument("--routing",
                   choices=("range", "kmer_hash", "minimizer", "supermer"),
                   default="range",
                   help="multi-device destination rule (supermer ships "
                        "supermers, the reference's exchange; no effect on "
                        "one rank)")
    p.add_argument("--classifier", choices=("heavy_hitter", "plain"),
                   default="heavy_hitter",
                   help="across ranks, heavy_hitter re-runs a skewed input "
                        "through the combiner; plain does not (no effect on "
                        "one rank)")
    p.add_argument("--dispatcher", choices=("balanced", "round_robin"),
                   default="balanced",
                   help="bucket placement under minimizer routing (no "
                        "effect on one rank)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process run: the address process 0 listens on "
                        "(with --num-processes and --process-id); each "
                        "process reads its own records and writes "
                        "<process id>.out")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process run: the number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process run: this process's rank")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        p.error("--coordinator needs --num-processes and --process-id")
    if args.routing == "supermer" and args.single_device:
        p.error("--routing supermer is a sharded dispatch path; it does not "
                "combine with --single-device (use the default range routing "
                "there)")

    # HYSORTK_LOG=info (or debug) surfaces the internal stage logs: the
    # streaming scheduler stamps drain / consolidation / merge spans.
    lvl = os.environ.get("HYSORTK_LOG")
    if lvl:
        logging.basicConfig(
            level=getattr(logging, lvl.upper(), logging.INFO),
            format="%(asctime)s %(name)s %(message)s",
        )

    import torch.distributed as dist

    from .config import KmerConfig

    cfg = KmerConfig(
        k=args.k, m=args.m, lower=args.lower, upper=args.upper,
        device_compact=args.device_compact, extension=args.extension,
        combiner=args.combiner, classifier=args.classifier,
        routing=args.routing, dispatcher=args.dispatcher,
    )
    multiproc = args.coordinator is not None
    sharded = not multiproc and int(os.environ.get("WORLD_SIZE", "1")) > 1
    owns_group = (sharded or multiproc) and not dist.is_initialized()
    try:
        return _run(args, p, cfg, sharded, multiproc)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, p, cfg, sharded: bool, multiproc: bool) -> int:
    import torch
    import torch.distributed as dist

    from . import _build
    from . import kmer_count, print_kmer_histogram, read_dna_buffer, write_output_file
    from .parallel import pipeline as sharded_pipeline
    from .pipeline import resolve_device
    from .runtime import memcheck
    from .runtime import timer as timer_mod
    from .runtime.logger import Logger
    from .runtime.scheduler import count_reads_streaming, count_reads_streaming_ext
    from .runtime.timer import Timer

    if multiproc:
        from .parallel import multihost

        dev = multihost.initialize_distributed(args.coordinator, args.num_processes,
                                               args.process_id, args.device)
        rank, ranks = dist.get_rank(), dist.get_world_size()
    elif sharded:
        from .parallel import group

        dev = group.init_from_env(args.device)
        rank, ranks = dist.get_rank(), dist.get_world_size()
    else:
        dev = resolve_device(args.device)
        rank, ranks = 0, 1

    log = Logger(rank=rank)
    log.root(f"hysortk_tpu_torch | k={cfg.k} m={cfg.m} L={cfg.lower} "
             f"U={cfg.upper}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.root(f"device: {dev} ({kind})" + (f", {ranks} ranks" if sharded else "")
             + (f", {ranks} processes ({dist.get_backend()})" if multiproc else ""))
    log.root(f"input: {args.fasta}")

    # Synchronized spans: the device, and across ranks a barrier, like the
    # reference Timer's barrier + MPI_Wtime (include/timer.hpp:24-68); so
    # every rank enters every span below.
    timer = Timer(synchronized=dev.type == "cuda" or ranks > 1)
    with timer.span("read_fasta"):
        if multiproc:
            # The index of this rank's records only: the count reads them.
            records, _ = multihost.my_records(args.fasta, None)
            n_reads, n_bases = len(records), int(records.length.sum())
        else:
            codes, lengths = read_dna_buffer(args.fasta)
            n_reads, n_bases = lengths.size, codes.size
    log.root(("rank 0's records: " if multiproc else "")
             + f"{n_reads} reads, {n_bases} bases "
             f"({n_bases / max(timer.last('read_fasta'), 1e-9) / 1e6:.1f} Mb/s)")

    profile_cm = contextlib.ExitStack()
    if args.profile:
        from .runtime.profiling import trace as profile_trace

        # The stage spans recorded, so that each is a range of the trace.
        profile_cm.enter_context(profile_trace(args.profile))
        profile_cm.enter_context(timer_mod.record_stages())

    stages = {}  # the last count's stage seconds, multi-process runs only

    def _do_count():
        batch = args.stream_batch_bases
        _build.reset_launches()
        if multiproc:
            # The JAX CLI's multi-process branches; each entry hands
            # routing="supermer" to its supermer_route counterpart.
            if batch:
                entry = functools.partial(
                    multihost.count_fasta_multihost_ext_streaming if args.extension
                    else multihost.count_fasta_multihost_streaming,
                    batch_bases=batch)
            else:
                entry = (multihost.count_fasta_multihost_ext if args.extension
                         else multihost.count_fasta_multihost)
            with timer_mod.record_stages() as seconds:
                result = entry(args.fasta, cfg, device=dev)
            stages.clear()
            stages.update(seconds)
            return result
        if args.extension and batch:
            # Bounded-memory EXT: per-batch unfiltered occurrence partials
            # held and merged on the device.
            if sharded:
                return sharded_pipeline.count_reads_sharded_ext_streaming(
                    codes, lengths, cfg, batch, device=dev)
            return count_reads_streaming_ext(codes, lengths, cfg, batch, device=dev)
        if batch:
            if sharded:
                return sharded_pipeline.count_reads_sharded_streaming(
                    codes, lengths, cfg, batch, device=dev)
            return count_reads_streaming(codes, lengths, cfg, batch, device=dev)
        # One shot; inside a group the facade takes the sharded path
        # (extension mode included).
        return kmer_count(codes, lengths, cfg, device=dev)

    with profile_cm, timer.span("kmer_count"):
        kmerlist, hist = _do_count()
    # --repeat N: run the counting stage again in the SAME process; the
    # first pass builds and loads the kernels, the repeats time the steady
    # state.
    for r in range(1, args.repeat):
        kmerlist = hist = None
        with timer.span(f"kmer_count_rep{r}"):
            kmerlist, hist = _do_count()
    last_span = (
        f"kmer_count_rep{args.repeat - 1}" if args.repeat > 1 else "kmer_count"
    )
    log.root(f"{len(kmerlist)} filtered kmers in "
             f"{timer.last(last_span):.3f}s ({last_span})")

    if args.validate:
        # Runtime sanitizer (the role ASan/UBSan builds play for the
        # reference): recount on the host with the brute-force oracle and
        # require exact {kmer: count} equality; a process of a
        # multi-process run checks that its share is contained in it.
        if multiproc:
            codes, lengths = read_dna_buffer(args.fasta)
        if codes.size > 4 * 1024 * 1024:
            p.error("--validate is for inputs up to ~4 Mb")
        import numpy as np

        from . import testing as _oracle

        offs = np.concatenate([[0], np.cumsum(lengths)])
        b2c = np.frombuffer(b"ACGT", dtype=np.uint8)
        reads = [
            b2c[codes[offs[i]: offs[i + 1]]].tobytes().decode()
            for i in range(lengths.size)
        ]
        want = {
            km.encode(): c
            for km, c in _oracle.oracle_filtered(
                reads, cfg.k, cfg.lower, cfg.upper
            ).items()
        }
        got = kmerlist.as_dict()
        if args.extension:  # (count, occurrences) per k-mer: the counts
            got = {km: entry[0] for km, entry in got.items()}
        ok = got == want
        if multiproc:  # every rank returns together
            ok = all(want.get(km) == c for km, c in got.items())
            ok = bool(sharded_pipeline._all_reduce_host(
                [int(ok)], dist.ReduceOp.MIN, dev, None)[0])
        if not ok:
            log.root("VALIDATE FAILED: device result != host oracle")
            return 1
        log.root(f"validate OK ({len(got)} kmers vs host oracle)")

    if not args.no_histogram and rank == 0:
        print_kmer_histogram(hist)

    if args.output_dir:
        # A multi-process run writes each process's share to <rank>.out,
        # like the reference (src/hysortk.cpp:138-164); under torchrun rank
        # 0 writes the whole list. Every rank enters the span.
        with timer.span("write_output"):
            path = (write_output_file(kmerlist, args.output_dir,
                                      shard=rank if multiproc else 0)
                    if multiproc or rank == 0 else None)
        log.root(f"wrote {path}")

    if multiproc:
        log.log(_rank_line(kmerlist, timer, last_span, dev, stages))
        log.flush("per rank")
    log.root(timer.report())
    log.root(memcheck.gathered_memory_report())
    return 0


def _rank_line(kmerlist, timer, last_span: str, dev, stages: dict) -> str:
    """One rank's line of a multi-process run: its share, the wall of its
    count, the seconds of each stage of it (runtime/timer.record_stages)
    and of the output file, its peak device memory and its kernels'
    launches in the count (_build.launches)."""
    import json

    import torch

    from ._build import launches

    stages = dict(stages, write=timer.total("write_output"))
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "not measured (cpu)")
    return (f"{len(kmerlist)} kmers, wall {timer.last(last_span):.4f} s, stages s: "
            + ", ".join(f"{name} {sec:.4f}" for name, sec in stages.items())
            + f", peak device memory {peak}, launches {json.dumps(launches)}")


if __name__ == "__main__":
    sys.exit(main())
