"""spflint for the port: static analysis enforcing the replay / locking /
kernel-resource invariants of ``repro_torch`` in their CUDA forms.

Pure-stdlib passes — importing this package must stay cheap and free of
``torch`` so the CLI can run before the environment can even build an
index, and on a machine without a card:

    python -m repro_torch.analysis src
"""
from __future__ import annotations

from pathlib import Path

from repro_torch.analysis import locks, replay, smem
from repro_torch.analysis.common import Finding, parse_tree
from repro_torch.analysis.config import DEFAULT_SPEC, AnalysisSpec

__all__ = ["run_all", "Finding", "AnalysisSpec", "DEFAULT_SPEC"]


def run_all(root: Path, spec: AnalysisSpec = DEFAULT_SPEC) -> dict:
    """Run all three passes over the tree at ``root``; returns
    ``{"findings", "smem_table", "smem_limit_bytes"}`` with findings
    sorted by (file, line, rule) and the table one row per launch entry,
    payload and geometry."""
    modules = parse_tree(Path(root))
    findings: list[Finding] = []
    findings += replay.run(modules, spec.replay)
    findings += locks.run(modules, spec.locks)
    smem_findings, rows = smem.run(modules, spec.smem, Path(root))
    findings += smem_findings
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return {
        "findings": findings,
        "smem_table": [r.as_dict() for r in rows],
        "smem_limit_bytes": spec.smem.limit_bytes,
    }
