"""The port's command line (python -m hysortk_tpu_torch.cli) against the
JAX package's (hysortk_tpu.cli, --single-device) on the CPU: the same output
lines and the same histogram text, one-shot and streaming. (The JAX
one-shot facade takes its sharded path under the tests' 8 virtual devices
and writes its lines in another order, so the lines compare sorted.)"""

import os
import subprocess
import sys

import numpy as np
import pytest

from hysortk_tpu import cli as jcli
from hysortk_tpu import testing as oracle
from hysortk_tpu_torch import cli
from hysortk_tpu_torch.io import writer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = ["-l", "2", "-u", "50"]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(44)
    reads = oracle.random_reads(rng, 30, 35, 120, "ACGTNacgt")
    reads += reads[:15]
    path = tmp_path_factory.mktemp("cli") / "reads.fa"
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            for j in range(0, len(r), 60):
                f.write(r[j: j + 60] + "\n")
    return str(path), reads


def _histogram(text):
    """The histogram block of a run's standard output."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("#count"))
    end = next(i for i, line in enumerate(lines) if line.startswith("wrote "))
    return lines[start:end]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("k", [15, 31, 55])
@pytest.mark.parametrize("stream", [[], ["--stream-batch-bases", "700"],
                                    ["--stream-batch-bases", "700", "--device-compact"]],
                         ids=["one_shot", "stream", "stream_compact"])
def test_cli_matches_jax_cli(fasta, tmp_path, capsys, k, stream):
    path, reads = fasta
    args = [path, "-k", str(k), "-m", str(min(17, k - 1)), *BOUNDS, *stream]
    assert cli.main(args[:1] + [str(tmp_path / "port")] + args[1:]
                    + ["--device", "cpu", "--validate"]) == 0
    ours = capsys.readouterr().out
    assert "validate OK" in ours and "-- timing --" in ours and "-- memory --" in ours
    assert jcli.main(args[:1] + [str(tmp_path / "jax")] + args[1:]
                     + ["--single-device"]) == 0
    theirs = capsys.readouterr().out
    lines = _read(tmp_path / "port" / "0.out").splitlines()
    assert lines and lines == sorted(_read(tmp_path / "jax" / "0.out").splitlines())
    assert _histogram(ours) == _histogram(theirs)
    got = {km.decode(): c
           for km, c in writer.parse_output_files(str(tmp_path / "port")).items()}
    assert got == oracle.oracle_filtered(reads, k, 2, 50)


@pytest.mark.parametrize("flags", [
    ["--extension"], ["--combiner"], ["--routing", "supermer"],
    ["--routing", "minimizer"], ["--classifier", "plain"],
    ["--dispatcher", "round_robin"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"],
    ["--extension", "--stream-batch-bases", "700"],
])
def test_unported_paths_exit_nonzero(fasta, tmp_path, capsys, monkeypatch, flags):
    """Flags of paths that are not ported end the run with an error.
    --extension is ported: one-shot it goes through count_reads_ext,
    with --stream-batch-bases through count_reads_streaming_ext, and the
    output and the validated counts are those of the run without it."""
    if flags[0] != "--extension":
        assert cli.main([fasta[0], "--device", "cpu", *flags]) != 0
        err = capsys.readouterr().err
        assert "not ported yet" in err and flags[0] in err
        return
    import hysortk_tpu_torch
    from hysortk_tpu_torch import pipeline
    from hysortk_tpu_torch.runtime import scheduler

    results = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            out = real(*a, **k)
            results.append((name, out[0]))
            return out
        monkeypatch.setattr(module, name, wrapped)

    spy(scheduler, "count_reads_streaming_ext")
    spy(pipeline, "count_reads_ext")
    monkeypatch.setattr(hysortk_tpu_torch, "count_reads_ext", pipeline.count_reads_ext)
    path, reads = fasta
    out_dir = str(tmp_path / "ext")
    assert cli.main([path, out_dir, *BOUNDS, "--device", "cpu", "--validate",
                     *flags]) == 0
    out = capsys.readouterr()
    assert "not ported yet" not in out.err and "validate OK" in out.out
    want_entry = ("count_reads_streaming_ext" if len(flags) > 1
                  else "count_reads_ext")
    assert [name for name, _ in results] == [want_entry]
    kl = results[0][1]
    assert isinstance(kl, hysortk_tpu_torch.KmerListExt)
    want = oracle.oracle_filtered(reads, 31, 2, 50)
    got = {km.decode(): c
           for km, c in writer.parse_output_files(out_dir).items()}
    assert got == want and want
    occ = kl.as_dict()
    assert {km.decode(): c for km, (c, _) in occ.items()} == want
    assert all(len(pairs) == c for c, pairs in occ.values())


@pytest.mark.parametrize("flag", ["--sort", "--fuse-keybuild", "--fuse-count"])
def test_tpu_only_flags_are_gone(fasta, flag):
    with pytest.raises(SystemExit) as exc:
        cli.main([fasta[0], flag])
    assert exc.value.code == 2


def test_module_entry_point_runs_without_jax(fasta, tmp_path):
    """python -m hysortk_tpu_torch.cli, streaming with --repeat, in a fresh
    process that must import neither jax nor hysortk_tpu."""
    code = (
        "import sys, runpy; sys.argv = ['cli'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('hysortk_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'jax' not in sys.modules and 'hysortk_tpu' not in sys.modules\n"
    )
    out_dir = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", code, fasta[0], out_dir, *BOUNDS, "--device", "cpu",
         "--stream-batch-bases", "700", "--repeat", "2", "--single-device",
         "--no-histogram"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "kmer_count_rep1" in proc.stdout and "#count" not in proc.stdout
    got = {km.decode(): c for km, c in writer.parse_output_files(out_dir).items()}
    assert got == oracle.oracle_filtered(fasta[1], 31, 2, 50)


def test_cuda_device_is_the_default_and_raises_without_a_card(fasta):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([fasta[0], *BOUNDS])
