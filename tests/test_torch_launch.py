"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU.

Each case runs ``main`` for 2 epochs on a small workload and checks the
lines it prints: the per-epoch table, then the engine report (policy and
slots, the queue, the replicas when there are any, durability, latency
percentiles).  Cases: a single index, 2 shards, 2 shards × 2 copies, and
a durable service reopened with ``--recover``.
"""
import pytest

from repro_torch.launch import serve

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
