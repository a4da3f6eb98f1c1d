#!/usr/bin/env python3
"""``chip_smoke.py``'s ``sharded`` main path alone, on the card.

Builds the CUDA kernels, then runs ``chip_smoke.sharded_path`` (a
4-shard, 2-copy durable service at the update cell's per-shard geometry)
once at N rows (default: the smoke's own), with the smoke's recall floors,
and prints the kernels' launches on the path and the path's report.  The
exit code is 1 if a check failed.  Needs one NVIDIA GPU; run from the
root of a checkout:

    python3 scripts/sharded_path_on_card.py [N]
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from chip_smoke import log
    from repro_torch.kernels import build
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    if not torch.cuda.is_available():
        print("sharded_path_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.UPDATE_N
    report, failed = {}, False
    t0 = time.perf_counter()
    try:
        chip_smoke.sharded_path(torch, np, 0, report, n=n)
    except chip_smoke.Fail as e:
        failed = True
        log(f"FAILED at N={n}: {e}")
    launches = {**LK.LAUNCHES, **SK.LAUNCHES}
    log(f"N={n}: {time.perf_counter() - t0:.1f} s; kernel launches on the path {launches}")
    log("report: " + json.dumps(report, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
