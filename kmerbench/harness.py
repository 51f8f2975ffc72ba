"""The benchmark's run: one cell, one seed, one measured window.

    python3 kmerbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is comes from files found by name: BENCHMARK.json names
the cell's configuration and traffic; kmerbench/configs/<config>.json holds
the counter's settings and the read profile, kmerbench/traffic/<traffic>.json
the size and kind of each call, kmerbench/workloads/<cell>.json what the
cell expects of the program's path, kmerbench/metrics/<metric>.py the
reader of each metric. The program is hysortk_tpu_torch; nothing here
imports jax or hysortk_tpu.

A run (on each rank of a cell of several cards, one process a card):
  set-up (setup_s): imports, the reads made on the card from the seed and
    copied to the host (the card freed), one warm-up call;
  the window: calls to hysortk_tpu_torch.kmer_count back to back by one
    caller until --seconds have passed; it closes at the end of the first
    call that ends after that;
  the check: the window's last result against the plain reference
    (kmerbench/reference), run on the card once the program's memory is
    given back.
The last line of standard output is the result's JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names a run may not hold: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "hysortk_tpu")
# The program's build caches and any library's kernel cache stay inside the
# checkout, at fixed paths.
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
    "CUDA_CACHE_PATH": os.path.join(ROOT, "build", "cuda_cache"),
}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell as the files describe it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    expect: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, spec: dict | None = None) -> "Cell":
        """The cell `name` of BENCHMARK.json (or of `spec`, a dict of its
        form)."""
        spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        config = load_json(os.path.join(ROOT, conf["file"]))
        traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        expect = load_json(os.path.join(HERE, "workloads", f"{name}.json"))

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        return cls(name, int(w["chips"]), config, traffic, expect,
                   [m for m in spec["end_to_end"] if mine(m)],
                   [m for m in spec["per_layer"] if mine(m)])

    def kmer_config(self):
        import hysortk_tpu_torch as ht

        c = self.config
        return ht.KmerConfig(k=c["k"], m=c["m"], lower=c["lower"], upper=c["upper"],
                             extension=bool(self.traffic["extension"]),
                             routing=c["routing"])


@dataclasses.dataclass
class Options:
    """What a rank is asked to do. `device` is "cuda" in every benchmark
    run; the CPU tests pass "cpu" (the program's plain versions) and may
    shrink the traffic (`bases`) and plant a fault (`hook`, a function
    called in each rank before set-up ends)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    bases: int | None = None
    hook: object = None

    @property
    def total_bases(self) -> int:
        return int(self.bases or self.cell.traffic["bases"])


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# One rank's run.


class SpanLog(dict):
    """The dict the program's stage spans write their seconds to
    (runtime/timer.record_stages), which also opens a profiler range for
    each span while it runs: a span enters by setdefault and leaves by a
    store."""

    def __init__(self):
        super().__init__()
        self._open: dict[str, list] = {}

    def setdefault(self, name, default=None):
        import torch

        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._open.setdefault(name, []).append(rf)
        return super().setdefault(name, default)

    def __setitem__(self, name, value):
        super().__setitem__(name, value)
        stack = self._open.get(name)
        if stack:
            stack.pop().__exit__(None, None, None)


class CopyOutClock:
    """Times every copy-out of a result (the program's pipeline.RING, which
    every to_host on a card goes through), from a synchronize on entry to
    its return, as a profiler range "copy_out"."""

    def __init__(self, dev):
        from hysortk_tpu_torch import pipeline

        self.ring = pipeline.RING
        self.dev = dev
        self.seconds = 0.0

    def __enter__(self):
        import torch

        inner = self.ring.copy_out

        def timed(tensors, dtypes, out=None):
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t = time.perf_counter()
            with torch.profiler.record_function("copy_out"):
                arrays = inner(tensors, dtypes, out)
            self.seconds += time.perf_counter() - t
            return arrays

        self.ring.copy_out = timed
        return self

    def __exit__(self, *exc):
        del self.ring.copy_out


def call_sizes(result) -> dict:
    """The sizes of a result that the roofline's bytes count."""
    lst = result[0]
    out = {"rows": int(lst.keys.shape[0]), "words": int(lst.keys.shape[1])}
    if hasattr(lst, "occ_rid"):
        out["occurrences"] = int(lst.occ_rid.shape[0])
    return out


def check_result(result, codes: np.ndarray, lengths: np.ndarray, cell: Cell, dev) -> dict:
    """The comparison's numbers for one result (reference.compare)."""
    import torch

    from kmerbench.reference import compare

    lst, hist = result
    c = cell.config
    ext = bool(cell.traffic["extension"])
    kw = {}
    if ext:
        kw = dict(lengths=lengths, occ_rid=lst.occ_rid, occ_pos=lst.occ_pos,
                  offsets=lst.offsets)
    res = compare.Result.from_arrays(lst.keys, lst.counts, hist, c["k"], dev, **kw)
    codes_d = torch.from_numpy(codes).to(dev)
    return compare.compare(res, codes_d, lengths, c["k"], c["lower"], c["upper"], ext)


def path_wrong(launches: dict, calls: int, expect: dict) -> int:
    """How many of the cell's expected launch counts (per call, [least,
    most]) the window's counters fall outside."""
    wrong = 0
    for name, (least, most) in expect.get("launches_per_call", {}).items():
        if not least * calls <= launches.get(name, 0) <= most * calls:
            wrong += 1
    return wrong


def agree_done(done: bool, world: int, dev) -> bool:
    """Whether any rank's window is over (every rank makes the same calls)."""
    if world == 1:
        return done
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(done)], dtype=torch.int32,
                        device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def barrier(world: int) -> None:
    if world > 1:
        import torch.distributed as dist

        dist.barrier()


def run_rank(rank: int, world: int, opts: Options, dev) -> dict:
    """One rank's run; its summary for the result line."""
    import torch

    import hysortk_tpu_torch as ht
    from hysortk_tpu_torch import _build
    from hysortk_tpu_torch.runtime import timer

    from kmerbench.gen import reads as gen
    from kmerbench import trace as trace_mod

    cell = opts.cell
    cfg = cell.kmer_config()
    codes, lengths = gen.host_reads(cell.config["reads"], opts.total_bases,
                                    cell.config["coverage"], opts.seed, dev)
    if opts.hook is not None:
        opts.hook()
    result = ht.kmer_count(codes, lengths, cfg, str(dev))
    del result
    profiler = None
    if opts.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):  # the profiler's own first start
            torch.zeros(1, device=dev).add_(1)
        profiler = profile(activities=activities)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    barrier(world)
    _build.reset_launches()
    spans, copy_out = [], []
    t_start = time.monotonic()
    setup_s = t_start - opts.t0
    if profiler is not None:
        profiler.__enter__()
        window = torch.profiler.record_function(trace_mod.WINDOW)
        window.__enter__()
    calls = 0
    ends = []
    while True:
        if opts.trace:
            log = SpanLog()
            with timer.record_stages(), CopyOutClock(dev) as clock:
                # record_stages holds a plain dict there; the log takes its
                # place for the call, so each span also opens a profiler range.
                timer._recording = log
                with torch.profiler.record_function("kmer_count"):
                    result = ht.kmer_count(codes, lengths, cfg, str(dev))
            spans.append(dict(log))
            copy_out.append(clock.seconds)
        else:
            result = ht.kmer_count(codes, lengths, cfg, str(dev))
        calls += 1
        t_end = time.monotonic()
        ends.append(t_end - t_start)
        if agree_done(t_end - t_start >= opts.seconds, world, dev):
            break
        del result
    if profiler is not None:
        window.__exit__(None, None, None)
        profiler.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = dict(_build.launches)
    summary = {
        "rank": rank, "calls": calls, "setup_s": setup_s, "window_s": t_end - t_start,
        "peak_bytes": int(peak), "launches": launches, "call_ends": ends,
        # The counters count launches on a card; the CPU runs plain versions.
        "path_wrong": path_wrong(launches, calls, cell.expect) if dev.type == "cuda" else 0,
        "sizes": call_sizes(result), "spans": spans, "copy_out_s": copy_out,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if profiler is not None:
        summary["trace"] = trace_mod.reduce_profile(profiler)
        del profiler
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary["checks"] = check_result(result, codes, lengths, cell, dev)
    summary["forbidden"] = forbidden_modules()
    return summary


# --------------------------------------------------------------------------
# Ranks of a cell on several cards: one process a card, NCCL, a file
# rendezvous under TMPDIR.


def _rank_entry(rank: int, world: int, opts: Options, tmp: str, fn) -> None:
    import torch
    import torch.distributed as dist

    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    # The host's cores shared out among its ranks, as a deployment sets
    # OMP_NUM_THREADS; the program's host library takes this count.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cuda = opts.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    kw = {}
    if cuda:
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=world, **kw)
    try:
        out = fn(rank, world, opts, dev)
        barrier(world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_ranks(world: int, opts: Options, fn=run_rank) -> list:
    """fn(rank, world, opts, device) in `world` spawned processes; their
    returns, by rank."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="kmerbench-")
    try:
        mp.start_processes(_rank_entry, args=(world, opts, tmp, fn), nprocs=world,
                           join=True, start_method="spawn")
        return [load_json(os.path.join(tmp, f"rank{r}.json")) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# The result line.


class Context:
    """What the metric readers (kmerbench/metrics/<name>.py) read."""

    def __init__(self, cell: Cell, opts: Options, ranks: list):
        self.cell = cell
        self.ranks = ranks
        self.chips = len(ranks)
        self.calls = ranks[0]["calls"]
        self.window_s = ranks[0]["window_s"]
        self.setup_s = ranks[0]["setup_s"]
        self.peak_bytes = max(r["peak_bytes"] for r in ranks)
        self.kind = ranks[0]["kind"]
        from kmerbench.gen.reads import read_lengths

        lens = read_lengths(cell.config["reads"], opts.total_bases)
        self.reads = int(lens.size)
        self.bases = int(lens.sum())
        self.kmers_per_call = int(np.maximum(lens - cell.config["k"] + 1, 0).sum())
        self.sizes = ranks[0]["sizes"]

    def traced(self) -> list:
        return [r["trace"] for r in self.ranks if r.get("trace")]

    def per_call(self, values: list) -> float | None:
        return sum(values) / len(values) if values else None


def read_metric(name: str, ctx: Context):
    """The metric's value from its reader (None: nothing to read)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"kmerbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def result_line(cell: Cell, opts: Options, ranks: list) -> tuple[dict, list[str]]:
    """The result's JSON object and the check lines for standard error."""
    from kmerbench import trace as trace_mod
    from kmerbench.reference.compare import LIMITS

    ctx = Context(cell, opts, ranks)
    metrics = {}
    for m in cell.per_layer if opts.trace else cell.end_to_end:
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    for name in ranks[0]["checks"]:
        checks[name] = {"value": max(r["checks"][name] for r in ranks), "limit": LIMITS[name]}
    checks["path_wrong"] = {"value": max(r["path_wrong"] for r in ranks), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if opts.device == "cuda" else "cpu", "kind": ctx.kind,
              "count": ctx.chips, "memory_peak_bytes": ctx.peak_bytes}
    line = {"correct": correct, "attempted": ctx.calls, "failed": 0 if correct else 1,
            "metrics": metrics, "device": device}
    traced = ctx.traced()
    if traced:
        device["busy_s"] = sum(t["busy_s"] for t in traced) / len(traced)
        device["window_s"] = sum(t["window_s"] for t in traced) / len(traced)

        def mean(key):
            out: dict[str, float] = {}
            for t in traced:
                for name, s in t[key].items():
                    out[name] = out.get(name, 0.0) + s / len(traced)
            return out

        line["breakdown"] = {"device_ops": trace_mod.top(mean("ops")),
                             "idle_gaps": trace_mod.top(mean("idle"))}
    line["checks"] = checks
    notes = [f"calls {ctx.calls}, window {ctx.window_s} s, setup {ctx.setup_s} s, "
             f"result {json.dumps(ctx.sizes)}"]
    for r in ranks:
        walls = np.diff([0.0] + r["call_ends"])
        notes.append(f"rank {r['rank']} call seconds {json.dumps([round(w, 4) for w in walls])}")
        per_call = {k: v / max(1, r["calls"]) for k, v in r["launches"].items() if v}
        notes.append(f"rank {r['rank']} launches per call {json.dumps(per_call)}")
        if r.get("trace"):
            notes.append(f"rank {r['rank']} trace kinds {json.dumps(r['trace']['kinds'])}")
    notes += [f"check {name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
    return line, notes


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    for var, path in CACHE_DIRS.items():
        os.environ[var] = path
    cell = Cell.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kmerbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    opts = Options(cell, args.seed, args.seconds, bool(args.trace), t0)
    if cell.chips == 1:
        ranks = [run_rank(0, 1, opts, torch.device("cuda", 0))]
    else:
        ranks = run_ranks(cell.chips, opts)
    return finish(cell, opts, ranks)


def finish(cell: Cell, opts: Options, ranks: list) -> int:
    """Print the check lines and the result line; non-zero, and no result,
    where a rank or this process (the metric readers included) held a
    forbidden module."""
    line, notes = result_line(cell, opts, ranks)
    found = sorted(set(forbidden_modules()).union(*(r["forbidden"] for r in ranks)))
    if found:
        print(f"kmerbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
