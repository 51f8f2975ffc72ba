"""Command-line interface: `python -m hysortk_tpu_torch.cli <fasta> [output_dir]`.

The port of hysortk_tpu/cli.py. Mirrors the reference standalone binary
(reference: standalone/main.cpp:9-72): prints the parameter block, runs
read -> count -> histogram -> output files, on one device, or under
torchrun (WORLD_SIZE > 1) across its ranks, one device a rank (rank 0
prints the histogram and writes the one output file, as the JAX CLI's
multi-device run writes one): one-shot, streamed (--stream-batch-bases),
in extension mode, by any routing (--routing supermer ships supermers; on
one device it changes nothing, as in the JAX CLI, and with --single-device
it is an error). The JAX multi-process flags (--coordinator,
--num-processes, --process-id) are not ported yet: they are accepted and
end the run with an error.

    torchrun --nproc-per-node 2 -m hysortk_tpu_torch.cli reads.fa out/ --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
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
    # Paths that are not ported yet: accepted, then refused.
    p.add_argument("--coordinator", default=None,
                   help="multi-process coordinator address (not ported yet; "
                        "run under torchrun instead)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def unported_flags(args: argparse.Namespace) -> list[str]:
    """The flags of `args` that ask for a path this package does not have."""
    asked = {
        "--coordinator": args.coordinator is not None,
        "--num-processes": args.num_processes is not None,
        "--process-id": args.process_id is not None,
    }
    return [flag for flag, on in asked.items() if on]


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    refused = unported_flags(args)
    if refused:
        print(f"hysortk_tpu_torch: {', '.join(refused)}: not ported yet",
              file=sys.stderr)
        return 2
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
    sharded = int(os.environ.get("WORLD_SIZE", "1")) > 1
    owns_group = sharded and not dist.is_initialized()
    try:
        return _run(args, p, cfg, sharded)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, p, cfg, sharded: bool) -> int:
    import torch
    import torch.distributed as dist

    from . import kmer_count, print_kmer_histogram, read_dna_buffer, write_output_file
    from .parallel import pipeline as sharded_pipeline
    from .pipeline import resolve_device
    from .runtime import memcheck
    from .runtime.logger import Logger
    from .runtime.scheduler import count_reads_streaming, count_reads_streaming_ext
    from .runtime.timer import Timer

    if sharded:
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
    log.root(f"device: {dev} ({kind})" + (f", {ranks} ranks" if sharded else ""))
    log.root(f"input: {args.fasta}")

    timer = Timer(synchronized=dev.type == "cuda")
    with timer.span("read_fasta"):
        codes, lengths = read_dna_buffer(args.fasta)
    log.root(f"{lengths.size} reads, {codes.size} bases "
             f"({codes.size / max(timer.last('read_fasta'), 1e-9) / 1e6:.1f} Mb/s)")

    if args.profile:
        from .runtime.profiling import trace as profile_trace

        profile_cm = profile_trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    def _do_count():
        batch = args.stream_batch_bases
        if args.extension and batch:
            # Bounded-memory EXT: per-batch unfiltered occurrence partials
            # merged on the host.
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
        # require exact {kmer: count} equality.
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
        if got != want:
            log.root("VALIDATE FAILED: device result != host oracle")
            return 1
        log.root(f"validate OK ({len(got)} kmers vs host oracle)")

    if not args.no_histogram and rank == 0:
        print_kmer_histogram(hist)

    if args.output_dir and rank == 0:
        with timer.span("write_output"):
            path = write_output_file(kmerlist, args.output_dir)
        log.root(f"wrote {path}")

    log.root(timer.report())
    log.root(memcheck.gathered_memory_report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
