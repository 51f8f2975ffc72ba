"""A whole run on the CPU (the program's plain versions, the card's check
skipped), sound and with the timed path broken underneath: `correct` has to
come out true, then false for each fault the cell can have. A counter keeps
no state from call to call, so the fault of a step that returns its state
unchanged has no place here."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

import hysortk_tpu_torch as ht
from hysortk_tpu_torch import pipeline
from hysortk_tpu_torch.parallel import exchange, supermer_route

from kmerbench import harness
from kmerbench.reference.compare import LIMITS

SIZES = {"hifi.oneshot": 1 << 21, "short150.oneshot": 1 << 21, "hifi.ext": 1 << 21,
         "hifi.supermer.4chip": 1 << 22}


# Cells whose files are ready but which are not in BENCHMARK.json (PERF.md,
# Open questions): their entries, as the tests run them.
PARKED = {
    "configs": [{"name": "hifi_k31_supermer4",
                 "file": "kmerbench/configs/hifi_k31_supermer4.json"}],
    "workloads": [{"name": "hifi.ext", "config": "hifi_k31", "traffic": "ext_512m", "chips": 1},
                  {"name": "hifi.supermer.4chip", "config": "hifi_k31_supermer4",
                   "traffic": "global_2g", "chips": 4}],
}


def load(cell_name: str) -> harness.Cell:
    """A cell of BENCHMARK.json, or a parked one."""
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for key, entries in PARKED.items():
        spec[key] = spec[key] + entries
    return harness.Cell.load(cell_name, spec)


def run_ranks(cell_name: str, seed: int = 2**31 + 5, hook=None):
    cell = load(cell_name)
    opts = harness.Options(cell, seed, 0.2, False, time.monotonic(), device="cpu",
                           bases=SIZES[cell_name], hook=hook)
    if cell.chips == 1:
        ranks = [harness.run_rank(0, 1, opts, torch.device("cpu"))]
    else:
        ranks = harness.run_ranks(cell.chips, opts)
    return cell, opts, ranks


def run(cell_name: str, seed: int = 2**31 + 5, hook=None) -> dict:
    line, _ = harness.result_line(*run_ranks(cell_name, seed, hook))
    return line


def half_batch(inner):
    """Half of the reads left out."""
    def broken(codes, lengths, *args, **kw):
        keep = np.size(lengths) // 2
        return inner(codes[: int(np.sum(lengths[:keep]))], lengths[:keep], *args, **kw)
    return broken


def altered_count(inner):
    """One count of the result changed where it is produced."""
    def broken(*args, **kw):
        lst, hist = inner(*args, **kw)
        lst.counts[len(lst.counts) // 2] += 1
        return lst, hist
    return broken


def altered_occurrence(inner):
    """One occurrence's position changed where it is produced."""
    def broken(*args, **kw):
        lst, hist = inner(*args, **kw)
        lst.occ_pos[len(lst.occ_pos) // 2] += 1
        return lst, hist
    return broken


@pytest.mark.parametrize("cell", ["hifi.oneshot", "short150.oneshot", "hifi.ext"])
def test_kmerbench_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and set(line["metrics"]) == {
        "kmers_per_s", "peak_device_gib", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,target,fault", [
    ("hifi.oneshot", (ht, "count_reads"), half_batch),
    ("short150.oneshot", (ht, "count_reads"), half_batch),
    ("hifi.ext", (ht, "count_reads_ext"), half_batch),
    ("hifi.oneshot", (pipeline, "kept_result"), altered_count),
    ("short150.oneshot", (pipeline, "kept_result"), altered_count),
    ("hifi.ext", (pipeline, "ext_result"), altered_count),
    ("hifi.ext", (pipeline, "ext_result"), altered_occurrence),
])
def test_kmerbench_fault_is_not_correct(monkeypatch, cell, target, fault):
    module, name = target
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    line = run(cell)
    assert not line["correct"], line["checks"]


def drop_exchange():
    """Each rank keeps what it would send: the exchange between ranks left
    out."""
    def local(send, send_counts, group=None):
        n = send.shape[0]
        return (send.clone(), torch.as_tensor(np.asarray(send_counts, np.int32)),
                torch.ones(n, send.shape[2], dtype=torch.bool))
    exchange.all_to_all_exchange = local


def alter_rank_result():
    supermer_route._supermer_one_shot = altered_count(supermer_route._supermer_one_shot)


def drop_half_batch():
    supermer_route.count_reads_supermer = half_batch(supermer_route.count_reads_supermer)


def test_kmerbench_four_ranks_sound_and_broken():
    assert run("hifi.supermer.4chip")["correct"]
    for hook in (drop_exchange, alter_rank_result, drop_half_batch):
        line = run("hifi.supermer.4chip", hook=hook)
        assert not line["correct"], (hook.__name__, line["checks"])


@pytest.mark.parametrize("cell,bases", [("hifi.oneshot", 1 << 22), ("short150.oneshot", 1 << 22),
                                        ("hifi.ext", 1 << 22), ("hifi.supermer.4chip", 1 << 22)])
def test_kmerbench_control_is_not_correct(cell, bases):
    """The control (the reference with 32-bit fingerprints for keys, in the
    program's place) fails a number at a size a test run holds."""
    from kmerbench.gen import reads as gen
    from kmerbench.readings import control_numbers

    c = load(cell)
    codes, lengths = gen.host_reads(c.config["reads"], bases, c.config["coverage"],
                                    2**31 + 99, "cpu")
    numbers = control_numbers(c, codes, lengths, torch.device("cpu"))
    assert any(v > LIMITS[name] for name, v in numbers.items()), numbers


@pytest.mark.parametrize("loads_jax", [False, True])
def test_kmerbench_reader_that_loads_jax_prints_no_result(tmp_path, monkeypatch, capsys,
                                                           loads_jax):
    """A metric reader that pulls in jax (here a stub of that name) after
    the window: the run exits non-zero and prints no result line."""
    assert "jax" not in sys.modules
    cell, opts, ranks = run_ranks("hifi.oneshot")
    shutil.copytree(os.path.join(harness.HERE, "metrics"), tmp_path / "metrics")
    if loads_jax:
        (tmp_path / "stub" / "jax").mkdir(parents=True)
        (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
        monkeypatch.syspath_prepend(str(tmp_path / "stub"))
        (tmp_path / "metrics" / "setup_s.py").write_text(
            "import jax\n\n\ndef read(ctx):\n    return ctx.setup_s\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    capsys.readouterr()
    try:
        rc = harness.finish(cell, opts, ranks)
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and out == "" and "jax" in err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]
