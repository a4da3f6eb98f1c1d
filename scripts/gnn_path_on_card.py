#!/usr/bin/env python3
"""``chip_smoke.py``'s ``gnn`` part alone, on the card.

Runs ``chip_smoke.gnn_path``: gat-cora's four training cells at their
published shapes through the cell's step (full_graph_sm, molecule,
minibatch_lg sampled 15-10 from ``CSRGraph.random``, ogb_products at
2,449,029 nodes and 61,859,140 edges), the first step against the CPU,
two forwards bit-identical, the minibatch_lg restart under deterministic
algorithms.  Prints the kernels' launches on the part (none), its report
and each cell's peak; the exit code is 1 if a check failed.  Needs one
NVIDIA GPU; run from the root of a checkout:

    python3 scripts/gnn_path_on_card.py
    python3 scripts/gnn_path_on_card.py cell=ogb_products
    python3 scripts/gnn_path_on_card.py cell=ogb_products edges=40000000

``cell=NAME[,NAME]`` runs only those cells; ``edges=E`` sets
ogb_products' edge count, to probe a cut.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    import chip_smoke
    from chip_smoke import log
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    if not torch.cuda.is_available():
        print("gnn_path_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    shapes = {k: dict(v) for k, v in GNN_SHAPES.items()}
    cells = chip_smoke.GNN_ORDER
    for arg in sys.argv[1:]:
        key, val = arg.split("=")
        if key == "cell":
            cells = tuple(val.split(","))
        else:
            shapes["ogb_products"]["n_edges"] = int(val)
    report, failed = {}, False
    t0 = time.perf_counter()
    try:
        chip_smoke.gnn_path(torch, np, 0, report, shapes=shapes, cells=cells)
    except chip_smoke.Fail as e:
        failed = True
        log(f"FAILED: {e}")
    except torch.cuda.OutOfMemoryError as e:
        failed = True
        log(f"FAILED: out of memory: {str(e).splitlines()[0]}")
    launches = {**LK.LAUNCHES, **SK.LAUNCHES}
    log(f"gnn: {time.perf_counter() - t0:.1f} s; kernel launches on the part {launches}; "
        f"peak {torch.cuda.max_memory_allocated()} bytes")
    log("report: " + json.dumps(report, default=str))
    return 1 if failed or any(launches.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
