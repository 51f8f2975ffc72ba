#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, at a cell's own size.

    python3 kmerbench/readings.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

In one process (one a card where the cell has several): for each of
--seeds, the cell's reads, one call of the program, and the comparison's
numbers; for each of --control-seeds, the control (the reference with every
key narrowed to a 32-bit fingerprint, reference/counter.fingerprint_counts)
in the program's place, on the first rank, and its numbers. One JSON line a
reading on standard output. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@dataclasses.dataclass
class Plan:
    """The readings a run makes (run_ranks hands it to every rank)."""

    cell: object
    seeds: list
    control_seeds: list
    device: str = "cuda"
    bases: int | None = None

    @property
    def total_bases(self) -> int:
        return int(self.bases or self.cell.traffic["bases"])


def control_numbers(cell, codes, lengths, dev, bits: int = 32) -> dict:
    """The control's result over (codes, lengths) against the reference."""
    import torch

    from kmerbench.reference import compare, counter

    c = cell.config
    ext = bool(cell.traffic["extension"])
    codes_d = torch.from_numpy(codes).to(dev)
    keys, counts, rows, starts = counter.fingerprint_counts(
        codes_d, lengths, c["k"], c["lower"], c["upper"], ext, bits)
    res = compare.Result(keys, counts, counter.histogram(counts, c["upper"]), dev, rows,
                         starts)
    del keys, counts, rows, starts
    return compare.compare(res, codes_d, lengths, c["k"], c["lower"], c["upper"], ext)


def readings_rank(rank: int, world: int, plan: Plan, dev) -> list:
    import torch

    import hysortk_tpu_torch as ht
    from kmerbench import harness
    from kmerbench.gen import reads as gen

    cell = plan.cell
    cfg = cell.kmer_config()
    out = []
    for kind, seed in ([("program", s) for s in plan.seeds]
                       + [("control", s) for s in plan.control_seeds]):
        codes, lengths = gen.host_reads(cell.config["reads"], plan.total_bases,
                                        cell.config["coverage"], seed, dev)
        record = {"kind": kind, "seed": seed, "rank": rank}
        if kind == "program":
            harness.barrier(world)
            t = time.monotonic()
            result = ht.kmer_count(codes, lengths, cfg, str(dev))
            record["call_s"] = time.monotonic() - t
            if dev.type == "cuda":
                record["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
                torch.cuda.empty_cache()
            record["checks"] = harness.check_result(result, codes, lengths, cell, dev)
            del result
        elif rank == 0:
            record["checks"] = control_numbers(cell, codes, lengths, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        harness.barrier(world)
        out.append(record)
        print(json.dumps(record), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    from kmerbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bases", type=int, default=None)
    args = p.parse_args(argv)
    for var, path in harness.CACHE_DIRS.items():
        os.environ[var] = path
    import torch

    cell = harness.Cell.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    plan = Plan(cell, seeds, control, args.device, args.bases)
    if cell.chips == 1:
        dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
        ranks = [readings_rank(0, 1, plan, dev)]
    else:
        ranks = harness.run_ranks(cell.chips, plan, readings_rank)
    for records in ranks:
        for record in records:
            if "checks" in record:
                print(json.dumps({"workload": cell.name, **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
