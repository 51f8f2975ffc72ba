"""The port's command line (python -m hysortk_tpu_torch.cli) against the
JAX package's (hysortk_tpu.cli, --single-device) on the CPU: the same output
lines and the same histogram text, one-shot and streaming; across 2 gloo
ranks (as under torchrun) against the JAX CLI's multi-device run; and as a
multi-process run joined at --coordinator, in-process on one rank and as 2
processes, each writing its own share to <rank>.out. (The JAX one-shot
facade takes its sharded path under the tests' 8 virtual devices and writes
its lines in another order, so the lines compare sorted.)"""

import os
import socket
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# With the multi-process flags, the modes the in-process one-rank run takes.
COORDINATOR_MODES = {"--coordinator": [],
                     "--num-processes": ["--stream-batch-bases", "700"],
                     "--process-id": ["--extension"]}


@pytest.mark.parametrize("flags", [
    ["--extension"], ["--combiner"], ["--routing", "supermer"],
    ["--routing", "minimizer"], ["--classifier", "plain"],
    ["--dispatcher", "round_robin"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"],
    ["--extension", "--stream-batch-bases", "700"],
])
def test_unported_paths_exit_nonzero(fasta, tmp_path, capsys, monkeypatch, flags):
    """Every path is ported now: no flag ends the run with an error.
    --combiner, --classifier, --routing minimizer, --routing supermer and
    --dispatcher round_robin steer the sharded path: on one device they
    change nothing, and the output file and histogram are those of the run
    without them, as the JAX CLI gives on one device; --routing supermer
    with --single-device is an error, as there. --extension one-shot goes
    through count_reads_ext, with --stream-batch-bases through
    count_reads_streaming_ext, and the output and the validated counts are
    those of the run without it. The multi-process flags join a group at
    --coordinator and count: here one process, in this one (one-shot,
    streamed or in extension mode, by the flag), whose 0.out and histogram
    are those of the run without them; two processes are
    test_cli_coordinator_two_processes."""
    if flags[0] in COORDINATOR_MODES:
        import torch.distributed as dist

        mode = COORDINATOR_MODES[flags[0]]
        outs = []
        for extra in ([], ["--coordinator", f"127.0.0.1:{_free_port()}",
                           "--num-processes", "1", "--process-id", "0"]):
            out_dir = tmp_path / ("with" if extra else "without")
            assert cli.main([fasta[0], str(out_dir), *BOUNDS, "--device", "cpu",
                             "--validate", *mode, *extra]) == 0
            text = capsys.readouterr()
            assert "validate OK" in text.out
            assert ("1 processes (gloo)" in text.out) == bool(extra)
            lines = sorted(_read(out_dir / "0.out").splitlines())
            outs.append((lines, _histogram(text.out)))
        assert outs[0] == outs[1] and outs[0][0]
        assert "[proc 0] " in text.out and "stages s: read_shard" in text.out
        assert not dist.is_initialized()  # the CLI leaves the group it joined
        return
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
    neither. Across ranks the CLI's timer is synchronized, so every span
    waits at a barrier: both ranks enter the write span, rank 0 alone
    writes.
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
    assert "2 ranks" in ours and "  write_output: " in ours
    assert sorted(os.listdir(out_dir)) == ["0.out"]
    assert jcli.main(args[:1] + [str(tmp_path / "jax")] + args[1:] + flags) == 0
    theirs = capsys.readouterr().out
    lines = sorted(_read(out_dir / "0.out").splitlines())
    assert lines and lines == sorted(_read(tmp_path / "jax" / "0.out").splitlines())
    assert _histogram(ours) == _histogram(theirs)
    got = {km.decode(): c for km, c in writer.parse_output_files(str(out_dir)).items()}
    assert got == oracle.oracle_filtered(reads, 31, 2, 50)


def test_cli_across_ranks_refuses_unported_modes(tmp_path, fasta, monkeypatch, capsys):
    """No mode is refused across ranks now. With WORLD_SIZE=2 in the
    environment (as torchrun sets it), --coordinator still takes the
    multi-process run: two processes join there, each writes its share, and
    the union of 0.out and 1.out is the oracle's list. The supermer routing
    on 2 torchrun ranks in extension mode (one-shot, through the facade)
    gives the JAX CLI's output and histogram."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    _two_processes(fasta, tmp_path / "coordinator", [])
    monkeypatch.delenv("WORLD_SIZE")
    _two_ranks_match_jax_cli(fasta, tmp_path, capsys,
                             ["--routing", "supermer", "--extension"])


def _two_processes(fasta, out_dir, flags) -> str:
    """The CLI as two processes joined at --coordinator, each validating its
    share; rank 0's standard output. The shares are disjoint and their
    union is the oracle's list."""
    path, reads = fasta
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hysortk_tpu_torch.cli", path, str(out_dir), *BOUNDS,
         "--device", "cpu", "--validate", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r), *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert "validate OK" in outs[0] and "2 processes (gloo)" in outs[0]
    assert "#count" not in outs[1] and "[proc 1] " in outs[0]
    assert sorted(os.listdir(out_dir)) == ["0.out", "1.out"]
    shares = []
    for r in range(2):
        lines = _read(out_dir / f"{r}.out").splitlines()
        shares.append({line.split(b"\t")[0]: int(line.split(b"\t")[1]) for line in lines})
    assert shares[0] and shares[1] and not set(shares[0]) & set(shares[1])
    want = oracle.oracle_filtered(reads, 31, 2, 50)
    assert {km.decode(): c for share in shares for km, c in share.items()} == want
    return outs[0]


@pytest.mark.parametrize("flags", [
    [], ["--stream-batch-bases", "700"], ["--extension"], ["--routing", "minimizer"],
    ["--routing", "supermer"],
    ["--routing", "supermer", "--extension", "--stream-batch-bases", "700"],
], ids=["default", "stream", "extension", "minimizer", "supermer",
        "supermer_extension_stream"])
def test_cli_coordinator_two_processes(fasta, tmp_path, capsys, flags):
    """python -m hysortk_tpu_torch.cli as two processes joined at
    --coordinator (gloo on the CPU): each reads its own records, validates
    its share against the oracle and writes it to <rank>.out; rank 0
    prints the global histogram, equal to the JAX CLI's, and every rank's
    stage line in rank order."""
    ours = _two_processes(fasta, tmp_path / "port", flags)
    assert ours.index("[proc 0] ") < ours.index("[proc 1] ")
    assert "across 2 procs" in ours
    path = fasta[0]
    jflags = [f for f in flags if f not in ("--routing", "supermer", "minimizer")]
    assert jcli.main([path, str(tmp_path / "jax"), "-k", "31", "-m", "17", *BOUNDS,
                      "--single-device", *jflags]) == 0
    assert _histogram(ours) == _histogram(capsys.readouterr().out)
