"""The port's command line (python -m hysortk_tpu_torch.cli) against the
JAX package's (hysortk_tpu.cli, --single-device) on the CPU: the same output
lines and the same histogram text, one-shot and streaming; and across 2
gloo ranks (as under torchrun) against the JAX CLI's multi-device run. (The
JAX one-shot facade takes its sharded path under the tests' 8 virtual
devices and writes its lines in another order, so the lines compare
sorted.)"""

import os
import subprocess
import sys

import numpy as np
import pytest

from hysortk_tpu import cli as jcli
from hysortk_tpu import testing as oracle
from hysortk_tpu_torch import cli
from hysortk_tpu_torch import testing
from hysortk_tpu_torch.io import writer
from hysortk_tpu_torch.parallel.spawn import spawn_ranks

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
    --combiner, --classifier, --routing minimizer, --routing supermer and
    --dispatcher round_robin are ported (they steer the sharded path): on
    one device they change nothing, and the output file and histogram are
    those of the run without them, as the JAX CLI gives on one device;
    --routing supermer with --single-device is an error, as there.
    --extension is ported: one-shot it
    goes through count_reads_ext, with --stream-batch-bases through
    count_reads_streaming_ext, and the output and the validated counts are
    those of the run without it."""
    if flags[0] in ("--combiner", "--classifier", "--routing", "--dispatcher"):
        outs = []
        for extra in ([], flags):
            out_dir = tmp_path / ("with" if extra else "without")
            assert cli.main([fasta[0], str(out_dir), *BOUNDS, "--device", "cpu",
                             "--validate", *extra]) == 0
            text = capsys.readouterr()
            assert "not ported yet" not in text.err and "validate OK" in text.out
            outs.append((_read(out_dir / "0.out"), _histogram(text.out)))
        assert outs[0] == outs[1] and outs[0][0]
        if flags == ["--routing", "supermer"]:
            with pytest.raises(SystemExit) as exc:
                cli.main([fasta[0], "--device", "cpu", "--single-device", *flags])
            assert exc.value.code == 2
            assert "--single-device" in capsys.readouterr().err
        return
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


@pytest.mark.parametrize("flags", [
    [], ["--combiner"], ["--extension"], ["--stream-batch-bases", "700"],
    ["--extension", "--stream-batch-bases", "700"], ["--routing", "minimizer"],
    ["--routing", "supermer"], ["--routing", "supermer", "--stream-batch-bases", "700"],
], ids=["default", "combiner", "extension", "stream", "extension_stream", "minimizer",
        "supermer", "supermer_stream"])
def test_cli_across_two_ranks_matches_jax_cli(fasta, tmp_path, capsys, flags):
    """The port's CLI on 2 gloo ranks (WORLD_SIZE=2, as torchrun sets it)
    against the JAX CLI's multi-device run over the 8 virtual devices, with
    the same flags (extension mode, sharded streaming, both, a routing):
    rank 0 writes the one output file, whose lines equal the JAX file's
    sorted, and prints the histogram, equal to the JAX CLI's; rank 1 prints
    neither.
    """
    _two_ranks_match_jax_cli(fasta, tmp_path, capsys, flags)


def _two_ranks_match_jax_cli(fasta, tmp_path, capsys, flags):
    path, reads = fasta
    args = [path, "-k", "31", "-m", "17", *BOUNDS]
    out_dir = tmp_path / "port"
    inputs = str(tmp_path / "none.npz")
    np.savez(inputs)
    job = dict(name="cli", kind="cli", inputs=inputs,
               argv=args[:1] + [str(out_dir)] + args[1:] + ["--device", "cpu", *flags])
    spawn_ranks(testing.run_rank_jobs, 2, ([job], str(tmp_path)),
                workdir=str(tmp_path), device="cpu", timeout=240)
    for r in range(2):
        assert int(np.load(tmp_path / f"cli.{r}.npz")["rc"]) == 0
    with open(tmp_path / "cli.0.txt") as f:
        ours = f.read()
    with open(tmp_path / "cli.1.txt") as f:
        assert "#count" not in f.read()
    assert "2 ranks" in ours
    assert sorted(os.listdir(out_dir)) == ["0.out"]
    assert jcli.main(args[:1] + [str(tmp_path / "jax")] + args[1:] + flags) == 0
    theirs = capsys.readouterr().out
    lines = sorted(_read(out_dir / "0.out").splitlines())
    assert lines and lines == sorted(_read(tmp_path / "jax" / "0.out").splitlines())
    assert _histogram(ours) == _histogram(theirs)
    got = {km.decode(): c for km, c in writer.parse_output_files(str(out_dir)).items()}
    assert got == oracle.oracle_filtered(reads, 31, 2, 50)


def test_cli_across_ranks_refuses_unported_modes(tmp_path, fasta, monkeypatch, capsys):
    """The JAX multi-process flags are not ported: the CLI under
    WORLD_SIZE > 1 exits 2 before it joins a group. The supermer routing
    is: on 2 ranks in extension mode (one-shot, through the facade) it
    gives the JAX CLI's output and histogram."""
    with monkeypatch.context() as m:
        m.setenv("WORLD_SIZE", "2")
        assert cli.main([fasta[0], "--device", "cpu", "--coordinator",
                         "localhost:1234"]) == 2
        assert "not ported yet" in capsys.readouterr().err
    _two_ranks_match_jax_cli(fasta, tmp_path, capsys,
                             ["--routing", "supermer", "--extension"])
