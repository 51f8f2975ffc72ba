#!/usr/bin/env python3
"""Time a fresh process's supermer-routed count through the port's CLI, for
one or more trees of the repository, in turns.

    python3 tools/bench_torch_fresh_process.py [--tree DIR[@NAME=VALUE,...] ...]
                                               [--rounds N]

Run on a machine with an sm_90 card and the CUDA toolkit. Each `--tree`
names a checkout whose hysortk_tpu_torch the CLI runs (default: this one),
optionally with variables set in its processes' environment after an `@`
(for example `--tree .@CUDA_MODULE_LOADING=EAGER`); the turns run in the
order given, that order `--rounds` times (for example `--tree P --tree C
--tree C --tree P` for parent, change, change, parent).
Each run is `python -m hysortk_tpu_torch.cli reads.fa out --routing
supermer` as two processes joined at `--coordinator`, both on the card
(gloo), each a fresh process: its first launches of torch's ops and of the
port's kernel library fall inside the stage spans it prints. Each tree's
libraries are built once, before its first run, by a process of their own.

The reads are made from a seed into a FASTA under a temporary directory: a
2^22-base genome sampled into 447,392 150-base reads (2^26 bases), half
reverse-complemented, 0.5% substitutions. K=31, M=17, L=2, U=50.

Prints, per run and process, the wall of the count and the spans of its
pack (feed, wire decode, plan, scan, the sizes' all-reduce, encode, the run
layout; a tree from before the run layout prints its sizes, destination
ranks, run table and layout spans instead) and of the kernel library's
first load, in seconds, as one JSON line each, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
GENOME_BASES = 1 << 22
READ_LEN = 150
BASES = 1 << 26
SPANS = ("pack", "feed", "wire decode", "kernel library load", "plan", "scan", "sizes",
         "sizes all_reduce", "encode", "destination ranks", "run table", "layout",
         "run layout", "dims all_reduce", "segment pack", "step", "result")


def write_reads(path: str) -> None:
    """BASES // 150 seeded reads as a FASTA of 60-column lines."""
    rng = np.random.default_rng(SEED)
    n_reads = BASES // READ_LEN
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    starts = rng.integers(0, GENOME_BASES - READ_LEN + 1, n_reads)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[reads]
    with open(path, "wb") as f:
        for i in range(n_reads):
            row = text[i].tobytes()
            f.write(b">r%07d\n%s\n%s\n%s\n" % (i, row[:60], row[60:120], row[120:]))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build(tree: str) -> None:
    """The tree's kernel and host libraries, built by a process of their
    own before its first timed run."""
    subprocess.run([sys.executable, "-c",
                    "from hysortk_tpu_torch import _build; _build.lib(); "
                    "from hysortk_tpu_torch.io import native; native.library_path()"],
                   cwd=tree, env=dict(os.environ, PYTHONPATH=tree), check=True)


def parse_turn(arg: str) -> tuple[str, dict]:
    """`DIR[@NAME=VALUE,...]` -> (absolute DIR, {NAME: VALUE})."""
    tree, _, extra = arg.partition("@")
    env = dict(item.split("=", 1) for item in extra.split(",") if item)
    return os.path.abspath(tree), env


def run(tree: str, fasta: str, out_dir: str, n: int = 2, extra_env=None) -> list[dict]:
    """One two-process CLI run: each process's wall and spans."""
    env = dict(os.environ, PYTHONPATH=tree, OMP_NUM_THREADS=str(max(1, os.cpu_count() // n)),
               **(extra_env or {}))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hysortk_tpu_torch.cli", fasta, out_dir, "-k", "31", "-m",
         "17", "-l", "2", "-u", "50", "--device", "cuda", "--routing", "supermer",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(r)],
        cwd=tree, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = []
    for r, proc in enumerate(procs):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"process {r} exited {proc.returncode}:\n{err[-3000:]}")
        outs.append(out)
    lines = [line for line in outs[0].splitlines() if line.startswith("[proc ")]
    if len(lines) != n:
        raise RuntimeError(f"{len(lines)} rank lines of {n}")
    ranks = []
    for line in lines:
        rec = {"wall": float(re.search(r"wall ([0-9.]+) s", line).group(1))}
        for name in SPANS:
            m = re.search(rf"[:,;] {re.escape(name)} ([0-9.]+)", line)
            rec[name] = float(m.group(1)) if m else None
        ranks.append(rec)
    return ranks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    turns = [parse_turn(t) for t in (args.tree or [ROOT])]
    trees = [tree for tree, _ in turns]
    with tempfile.TemporaryDirectory(prefix="fresh_process_", dir=os.path.join(ROOT, "build")
                                     if os.path.isdir(os.path.join(ROOT, "build")) else None) as tmp:
        fasta = os.path.join(tmp, "reads.fa")
        write_reads(fasta)
        for tree in dict.fromkeys(trees):
            build(tree)
        for rnd in range(args.rounds):
            for i, (tree, extra_env) in enumerate(turns):
                ranks = run(tree, fasta, os.path.join(tmp, f"out{rnd}_{i}"),
                            extra_env=extra_env)
                for r, rec in enumerate(ranks):
                    print(json.dumps({"round": rnd, "turn": i, "tree": tree,
                                      "env": extra_env, "process": r, **rec}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
