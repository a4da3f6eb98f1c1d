"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its entry's ``file``), its traffic mix
(``cardbench/traffic/<traffic>.json``) and each metric's reader
(``cardbench/metrics/<name>.py``).  Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Benchmark:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / self.doc["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or its per-layer
        ones: every metric whose ``workloads`` lists the cell, or that has
        no such key."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The ``read(ctx)`` of ``cardbench/metrics/<name>.py``."""
        return _load_read(self.home / "metrics" / f"{name}.py", name)


def _load_read(path: Path, name: str):
    """``read`` of the module at ``path``, loaded by its file name (a
    metric's name may hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(f"cardbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
