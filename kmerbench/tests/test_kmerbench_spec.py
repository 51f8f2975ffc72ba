"""BENCHMARK.json against the benchmark's rules, the files it names, and
what the benchmark imports."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from kmerbench import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_kmerbench_spec_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    for section, keys in KEYS.items():
        for entry in SPEC[section]:
            assert set(entry) <= keys and set(entry) >= keys - {"workloads"}, entry


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_kmerbench_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_kmerbench_cells_and_metrics_cohere():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert {w["config"] for w in cells.values()} == set(configs)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    for name in cells:
        assert any(name in m["workloads"] for m in SPEC["per_layer"])


def test_kmerbench_every_name_has_its_file():
    here = harness.HERE
    for c in SPEC["configs"]:
        conf = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("kmerbench/") and c["source"] == conf["source"]
        assert set(c["reduced"]) == set(conf["reduced"]) <= set(conf)
    for w in SPEC["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(here, "workloads", f"{w['name']}.json"))
        cell = harness.Cell.load(w["name"])
        assert cell.chips == cell.config["ranks"] == w["chips"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics", f"{m['name']}.py"))
    assert SPEC["paths"] == ["kmerbench"] and SPEC["command"][1] == "kmerbench/run.py"


def sources(sub: str = ""):
    top = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_kmerbench_imports_no_jax_and_the_reference_nothing_of_the_program():
    for path in sources():
        assert not imported_tops(path) & set(harness.FORBIDDEN), path
    for path in sources("reference"):
        assert "hysortk_tpu_torch" not in imported_tops(path), path


def test_kmerbench_loaded_modules_in_a_fresh_process():
    """What importing the harness, the reference and the program loads,
    compared by whole top-level names (hysortk_tpu_torch starts with
    hysortk_tpu)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import kmerbench.reference.compare, kmerbench.reference.counter\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import kmerbench.harness, kmerbench.readings, kmerbench.trace, hysortk_tpu_torch\n"
        "import hysortk_tpu_torch.parallel.supermer_route\n"
        "from kmerbench.harness import forbidden_modules\n"
        "import json; print(json.dumps([ref, forbidden_modules()]))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    ref, forbidden = json.loads(out.stdout.splitlines()[-1])
    assert "hysortk_tpu_torch" not in ref and not set(ref) & set(harness.FORBIDDEN)
    assert forbidden == []
