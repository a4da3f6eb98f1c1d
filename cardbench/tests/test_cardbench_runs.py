"""Whole runs of small cells on the CPU: the last line's schema, the
comparison that decides ``correct`` coming out true for the program and
false for the TF32 control and for each fault planted under the timed
path, and the command line refusing to run without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_small

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _schema(out, traced):
    assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] >= 0
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}, name
    json.loads(json.dumps(out))


def test_program_is_correct_and_the_line_has_its_schema(mix_run):
    out = {k: v for k, v in mix_run.items() if k != "controls"}
    _schema(out, True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"dist_err", "bad_rows", "stale", "unanswered", "unfound",
                                  "recall"}
    names = set(out["metrics"])
    assert {"build_s", "drain_s", "round_ms.mix", "reassign_per_split.mix"} <= names
    assert not names & {"search_p95_ms", "setup_s"}      # end-to-end ones only untraced


def test_tf32_control_fails_the_distance_check(mix_run):
    from cardbench import check, spec

    cfg = spec.Benchmark(ROOT).config("spacev-shard")
    ctrl = mix_run["controls"]["tf32"]
    ok, checks = check.verdict(ctrl, cfg["limits"])
    assert not ok and checks["dist_err"]["value"] > cfg["limits"]["dist_err"]
    assert checks["dist_err"]["value"] > 30 * mix_run["checks"]["dist_err"]["value"]


def test_search_cell_end_to_end_metrics():
    out = run_small("spacev.search_sat")
    _schema(out, False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"search_qps", "search_p95_ms", "recall_at_10", "setup_s"}
    assert "unfound" not in out["checks"]


@pytest.mark.parametrize("workload, fault", [
    ("spacev.update_mix", "unchanged"),
    ("spacev.search_sat", "half_batch"),
    ("spacev.search_sat", "altered"),
    ("spacev-q8.search_sat", "altered"),
])
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault):
    out = run_small(workload, fault=fault)
    assert out["correct"] is False, out["checks"]


def test_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    """Here there is no CUDA device; a directory with only BENCHMARK.json
    and the harness (no program) fails the same way."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "cardbench/run.py", "--workload", "spacev.search_sat", "--seed",
           str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "cardbench/run.py", "--workload", "spacev.search_sat",
                        "--seed", "7", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
