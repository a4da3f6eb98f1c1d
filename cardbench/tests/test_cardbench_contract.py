"""BENCHMARK.json against the benchmark's contract, and the harness found
by name: a cell, a configuration, a traffic mix and a metric added as
files and entries only."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_keys_names_and_units():
    assert set(DOC) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[group]]
        assert len(names) == len(set(names)), group
        for e in DOC[group]:
            assert set(e) <= KEYS[group], (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in DOC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cardbench/")
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_bounds_sources_and_cells():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in DOC["workloads"]]
    layers = {}
    for m in DOC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", cells):
            assert cell in cells
            # the metric it moves is reported in every cell it lists
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m.get("workloads", cells) for m in DOC["per_layer"]), cell


def test_every_name_has_its_files():
    home = ROOT / DOC["paths"][0]
    for w in DOC["workloads"]:
        assert (home / "traffic" / f"{w['traffic']}.json").is_file()
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert (home / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert DOC["command"][1].startswith(DOC["paths"][0] + "/")


def test_the_int8_cell_reads_its_search_tail_per_layer():
    """Its tail follows the host's speed, so it is no end-to-end metric
    there; the traced run still reads it."""
    from cardbench import spec

    b = spec.Benchmark(ROOT)
    e2e = [m["name"] for m in b.metrics("spacev-q8.search_sat", False)]
    layer = [m["name"] for m in b.metrics("spacev-q8.search_sat", True)]
    assert "search_p95_ms" not in e2e and "search_qps" in e2e
    assert "search_p95_ms.q8" in layer
    assert "search_p95_ms" in [m["name"] for m in b.metrics("spacev.search_sat", False)]
    assert "search_p95_ms.q8" not in [m["name"] for m in b.metrics("spacev.search_sat", True)]


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


def test_a_cell_config_mix_and_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new entries only, and the
    harness finds each by name."""
    from cardbench import spec

    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "cardbench").rglob("*") if p.is_file()}
    doc = json.loads(json.dumps(DOC))
    cfg = json.loads((ROOT / "cardbench/configs/spacev-shard.json").read_text())
    cfg["name"] = "spacev-small"
    (tmp_path / "cardbench/configs/spacev-small.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "cardbench/traffic/closed_search.json").read_text())
    mix["search"]["clients"] = 2
    (tmp_path / "cardbench/traffic/two_clients.json").write_text(json.dumps(mix))
    (tmp_path / "cardbench/metrics/answered.small.py").write_text(
        "def read(ctx):\n    return float(len(ctx['log']))\n")
    doc["configs"].append({"name": "spacev-small", "source": "x", "why": "x", "reduced": [],
                           "file": "cardbench/configs/spacev-small.json"})
    doc["workloads"].append({"name": "spacev.small", "config": "spacev-small",
                             "traffic": "two_clients", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "answered.small", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "engine", "moves": "search_p95_ms",
                             "workloads": ["spacev.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    b = spec.Benchmark(tmp_path)
    assert b.config(b.cell("spacev.small")["config"])["name"] == "spacev-small"
    assert b.traffic("two_clients")["search"]["clients"] == 2
    assert [m["name"] for m in b.metrics("spacev.small", True)] == ["build_s", "drain_s",
                                                                   "answered.small"]
    assert b.reader("answered.small")({"log": [1, 2, 3]}) == 3.0
    assert "answered.small" not in [m["name"] for m in b.metrics("spacev.search_sat", True)]
    after = {p: p.read_bytes() for p in before}
    assert after == before          # no file that was there changed


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core.lire", "numpy", "cardbench.guard"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["reprox", "jax_utils", "flaxen"], []),
])
def test_import_guard_compares_whole_top_level_names(names, found):
    from cardbench import guard

    assert guard.loaded(names) == found
