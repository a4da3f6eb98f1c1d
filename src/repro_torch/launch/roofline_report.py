"""The roofline table over the dry run's JSONs (``launch/dryrun.py``), one
mesh at a time: the port's twin of ``benchmarks/roofline_report.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [--mesh card]
        [--out build/dryrun_torch]

Each row: the three roofline terms in seconds a device (the collective term
``n/a`` where the mesh's collectives are unknown), the dominant one, the
argument bytes a device in GB, whether they fit 80 GB, the model FLOPs over
the counted FLOPs (LM cells), the seconds the count took and where the card
runs the cell today.  The times are bounds from counts on the ``meta``
device against the H100's published peaks, not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT


def load(out_dir: str = DEFAULT_OUT) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as fh:
            rows.append(json.load(fh))
    return rows


def _s(x) -> str:
    return "n/a" if x is None else f"{x:.3e}"


def table(rows: list[dict], mesh: str = "card") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | args/dev GB | fits 80 GB"
        " | model/counted | count_s | card run |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        head = f"| {r['arch']} | {r['shape']} |"
        if r.get("status") == "skipped":
            lines.append(f"{head} — | — | — | skipped: {r.get('skip_reason', '')[:70]} | — | — | "
                         f"— | — | {r.get('card_run', '')} |")
            continue
        if r.get("status") != "ok":
            lines.append(f"{head} — | — | — | {r.get('status')} | — | — | — | — | — |")
            continue
        t = r["roofline"]
        ratio = r.get("model_to_hlo_flops")
        lines.append(
            f"{head} {_s(t['compute_s'])} | {_s(t['memory_s'])} | {_s(t['collective_s'])} | "
            f"{t['dominant'].replace('_s', '')} | {r['bytes_per_device'] / 1e9:.2f} | "
            f"{'yes' if r['fits_80gb'] else 'no'} | "
            f"{'n/a' if ratio is None else f'{ratio:.2f}'} | {r.get('count_s', 0):.1f} | "
            f"{r['card_run']} |")
    return "\n".join(lines)


def counts(rows: list[dict]) -> dict:
    """Records by status."""
    out: dict = {}
    for r in rows:
        out[r.get("status")] = out.get(r.get("status"), 0) + 1
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="roofline table over the dry run's JSONs")
    ap.add_argument("--mesh", choices=["single", "multi", "card"], default="card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rows = load(args.out)
    print(f"## {args.mesh} ({counts([r for r in rows if r.get('mesh') == args.mesh])})\n")
    print(table(rows, args.mesh))


if __name__ == "__main__":
    main()
