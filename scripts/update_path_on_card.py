#!/usr/bin/env python3
"""``chip_smoke.py``'s ``update`` main path at other sizes, on the card.

Builds the CUDA kernels, then runs ``chip_smoke.update_path`` once per N
given (default: the smoke's own), each with the smoke's recall floors,
logging the drain's progress every 250 rounds.  A failed check is
printed and the next N still runs; the exit code is 1 if any failed.
Needs one NVIDIA GPU; run from the root of a checkout:

    python3 scripts/update_path_on_card.py 250000 1000000
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
    from repro_torch.core import lire
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("update_path_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    progress = {"rounds": 0, "t0": 0.0}
    round_fn = lire.maintenance_round

    def logged_round(*a, **kw):
        progress["rounds"] += 1
        if progress["rounds"] % 250 == 0:
            log(f"  ... round {progress['rounds']} at "
                f"{time.perf_counter() - progress['t0']:.1f} s")
        return round_fn(*a, **kw)

    lire.maintenance_round = logged_round
    failed = False
    for n in [int(a) for a in sys.argv[1:]] or [chip_smoke.UPDATE_N]:
        progress.update(rounds=0, t0=time.perf_counter())
        report = {}
        try:
            chip_smoke.update_path(torch, np, 0, report, n=n)
        except chip_smoke.Fail as e:
            failed = True
            log(f"FAILED at N={n}: {e}")
        log(f"N={n}: {time.perf_counter() - progress['t0']:.1f} s")
        report.pop("stats", None)
        log("report: " + json.dumps(report, default=str))
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
