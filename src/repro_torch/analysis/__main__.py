"""spflint CLI for the port: ``python -m repro_torch.analysis src``.

Runs the three passes over a source tree, prints findings, and exits
nonzero on any finding not covered by the baseline — the CI ratchet.

    python -m repro_torch.analysis src                  # check (exit 1 on new)
    python -m repro_torch.analysis src --json out.json  # + machine report
    python -m repro_torch.analysis src --write-baseline # accept current findings
    python -m repro_torch.analysis --rules              # rule table
    python -m repro_torch.analysis src --table          # shared-memory table
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import run_all
from repro_torch.analysis.common import (
    RULES, load_baseline, split_by_baseline, write_baseline,
)


def _print_rules() -> None:
    for rule, desc in sorted(RULES.items()):
        print(f"{rule}  {desc}")


def _print_table(table: list[dict], limit: int) -> None:
    print(f"dynamic shared memory per launch entry, payload and geometry "
          f"(a block may take {limit} bytes; blocks an SM by shared memory "
          "and threads):")
    for r in table:
        print(f"  {r['entry']:<24} {r['payload']:<9} {r['geometry']:<15} "
              f"{r['bytes']:>7} B  {r['shape']:<7} {r['warps']} warps "
              f"{r['stages']} stages  {r['blocks_per_sm']} blocks/SM"
              f"{'' if r['used'] else '  (payload not stored there)'}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("root", nargs="?", default="src",
                    help="source tree to analyze (default: src)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full JSON report here")
    ap.add_argument("--baseline", metavar="PATH",
                    default="tools/spflint_torch_baseline.json",
                    help="suppression file (default: "
                         "tools/spflint_torch_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--table", action="store_true",
                    help="print the shared-memory table")
    args = ap.parse_args(argv)

    if args.rules:
        _print_rules()
        return 0

    root = Path(args.root)
    if not root.is_dir():
        print(f"spflint: no such source tree: {root}", file=sys.stderr)
        return 2

    result = run_all(root)
    findings = result["findings"]
    baseline = load_baseline(Path(args.baseline))
    new, suppressed = split_by_baseline(findings, baseline)

    if args.write_baseline:
        write_baseline(Path(args.baseline), findings)
        print(f"spflint: wrote {len(findings)} suppression(s) to "
              f"{args.baseline}")
        return 0

    if args.table:
        _print_table(result["smem_table"], result["smem_limit_bytes"])

    for f in new:
        print(f.render())

    n_e = len({r["entry"] for r in result["smem_table"]})
    if args.json:
        report = {
            "findings": [
                {"rule": f.rule, "file": f.file, "line": f.line,
                 "symbol": f.symbol, "message": f.message}
                for f in new
            ],
            "suppressed": [
                {"rule": f.rule, "file": f.file, "line": f.line,
                 "symbol": f.symbol}
                for f in suppressed
            ],
            "smem_table": result["smem_table"],
            "smem_limit_bytes": result["smem_limit_bytes"],
            "rules": RULES,
            "summary": {
                "new": len(new),
                "suppressed": len(suppressed),
                "entries_analyzed": n_e,
            },
        }
        Path(args.json).write_text(json.dumps(report, indent=2) + "\n")

    if new:
        print(f"spflint: {len(new)} new finding(s) "
              f"({len(suppressed)} baselined, {n_e} launch entries analyzed)")
        return 1
    print(f"spflint: clean ({len(suppressed)} baselined, "
          f"{n_e} launch entries analyzed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
