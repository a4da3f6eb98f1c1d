"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU.

Each case runs ``main`` for 2 epochs on a small workload and checks the
lines it prints: the per-epoch table, then the engine report (policy and
slots, the queue, the replicas when there are any, durability, latency
percentiles).  Cases: a single index, 2 shards, 2 shards × 2 copies, and
a durable service reopened with ``--recover``.

The training launcher (``repro_torch.launch.train``) trains each ported
recsys arch 3 steps on the CPU with ``--ckpt`` and a second run resumes
from the saved step; it trains an LM's smoke cell 2 steps; an arch that
is not ported exits naming ``ROADMAP.md``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import serve
from repro_torch.launch import train

COMMON = ["--n", "2000", "--epochs", "2", "--device", "cpu"]


def run(capsys, *args):
    serve.main(COMMON + list(args))
    return capsys.readouterr().out.splitlines()


def epochs(lines, header):
    i = lines.index(header)
    return [line.split() for line in lines[i + 1:i + 3]]


def report(lines, key):
    return [line for line in lines if line.startswith(key)]


def test_launcher_serves_a_single_index(capsys):
    lines = run(capsys)
    rows = epochs(lines, "epoch recall@10 p99_ms postings splits reassigned")
    assert [r[0] for r in rows] == ["0", "1"]
    assert all(float(r[1]) > 0.8 for r in rows), rows
    assert report(lines, "policy=ratio") and report(lines, "queue: batches=")
    assert report(lines, "search: p50=") and report(lines, "insert: p50=")
    assert not report(lines, "replicas:")


@pytest.mark.parametrize("replicas", [1, 2])
def test_launcher_serves_two_shards(capsys, replicas):
    lines = run(capsys, "--shards", "2", "--replicas", str(replicas))
    assert "serving 2000 vectors over 2 shards on cpu" in lines
    rows = epochs(lines, "epoch  p99_ms postings splits deletes")
    assert [r[0] for r in rows] == ["0", "1"]
    assert all(int(r[4]) > 0 for r in rows), rows          # deletes by handle
    assert report(lines, "delete: p50=")
    rep = report(lines, "replicas:")
    if replicas == 1:
        assert not rep
    else:
        fields = dict(f.split("=") for f in rep[0].split()[1:])
        assert fields["n"] == "2" and int(fields["published"]) > 0
        assert int(fields["routed"]) + int(fields["fallback"]) > 0


def test_launcher_durable_then_recover(capsys, tmp_path):
    root = str(tmp_path / "svc")
    lines = run(capsys, "--durable", root, "--checkpoint-every", "1000")
    assert any(line.startswith(f"durable service at {root}") for line in lines)
    assert f"service checkpointed under {root}" in lines
    dur = report(lines, "durability: recovered=False")
    assert dur, lines
    lines = run(capsys, "--durable", root, "--recover")
    assert any(line.startswith(f"recovered service from {root}") for line in lines)
    assert report(lines, "durability: recovered=True")
    with pytest.raises(SystemExit):
        serve.main(COMMON + ["--recover"])


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "deepfm", "bert4rec", "mind"])
def test_train_launcher_trains_and_resumes(capsys, tmp_path, arch):
    ckpt = str(tmp_path / "ck")
    train.main(["--arch", arch, "--steps", "3", "--device", "cpu", "--ckpt", ckpt,
                "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"training {arch}/train_batch (smoke-scale config on cpu)"
    assert [line.split()[1] for line in lines if line.startswith("step")] == ["0", "1", "2"]
    assert lines[-1] == "done" and sorted(os.listdir(ckpt)) == ["step_3"]
    train.main(["--arch", arch, "--steps", "5", "--device", "cpu", "--ckpt", ckpt,
                "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert "resumed from step 3" in lines
    assert [line.split()[1] for line in lines if line.startswith("step")] == ["3", "4"]
    assert sorted(os.listdir(ckpt)) == ["step_3", "step_5"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen1.5-110b"])
def test_train_launcher_trains_an_lm_smoke_cell(capsys, arch):
    train.main(["--arch", arch, "--steps", "2", "--device", "cpu", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"training {arch}/train_4k (smoke-scale config on cpu)"
    losses = [float(line.split()[3]) for line in lines if line.startswith("step")]
    assert len(losses) == 2 and all(0 < x < 10 for x in losses)
    assert lines[-1] == "done"


@pytest.mark.parametrize("shape", ["minibatch_lg", "molecule"])
def test_train_launcher_trains_a_gat_cora_cell(capsys, shape, tmp_path):
    """``--arch gat-cora --shape minibatch_lg`` (the reference's usage line):
    the sampled smoke batch trains a few steps, checkpoints and resumes."""
    ckpt = str(tmp_path / "ck")
    train.main(["--arch", "gat-cora", "--shape", shape, "--steps", "3", "--device", "cpu",
                "--log-every", "1", "--ckpt", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"training gat-cora/{shape} (smoke-scale config on cpu)"
    losses = [float(line.split()[3]) for line in lines if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses)) and lines[-1] == "done"
    train.main(["--arch", "gat-cora", "--shape", shape, "--steps", "4", "--device", "cpu",
                "--ckpt", ckpt])
    assert "resumed from step 3" in capsys.readouterr().out.splitlines()


def test_train_launcher_refuses_an_arch_not_ported():
    # every arch is ported; one without a train cell, or an unknown one, exits
    with pytest.raises(SystemExit, match="no train cell for spfresh-1b"):
        train.main(["--arch", "spfresh-1b", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no cells for no-such-arch"):
        train.main(["--arch", "no-such-arch", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no train cell"):
        train.main(["--arch", "mind", "--shape", "serve_p99", "--device", "cpu"])


def test_train_launcher_runs_as_a_module():
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepfm",
                           "--steps", "2", "--device", "cpu"], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "done"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "spfresh-1b", "--device", "cpu"], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and "no train cell for spfresh-1b" in proc.stderr
