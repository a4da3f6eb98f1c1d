#!/usr/bin/env python3
"""``chip_smoke.py``'s ``lm`` main path alone, on the card.

Runs ``chip_smoke.lm_path``: granite-moe-1b-a400m and deepseek-7b at their
published widths and depths in bf16 (prefill, decode, the prefill/decode
consistency, two prefills bit-identical, a sync-free decode step, layer 0
split into attention, MoE and the rest, the attention against
``scaled_dot_product_attention``), then both cut to 2 layers in f32 on the
card against the CPU.  Prints the kernels' launches on the path (none) and
the path's report; the exit code is 1 if a check failed.  Needs one NVIDIA
GPU; run from the root of a checkout:

    python3 scripts/lm_path_on_card.py
    python3 scripts/lm_path_on_card.py prefill=4 decode=48

``prefill=B`` and ``decode=B`` set granite-moe's prefill and decode
batches (``chip_smoke.LM_PREFILL``, ``LM_DECODE``) to probe what fits.
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
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    if not torch.cuda.is_available():
        print("lm_path_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    sizes = {"prefill": dict(chip_smoke.LM_PREFILL), "decode": dict(chip_smoke.LM_DECODE)}
    for arg in sys.argv[1:]:
        key, rows = arg.split("=")
        sizes[key]["batch"] = int(rows)
    report, failed = {}, False
    t0 = time.perf_counter()
    try:
        chip_smoke.lm_path(torch, np, 0, report, **sizes)
    except chip_smoke.Fail as e:
        failed = True
        log(f"FAILED: {e}")
    except torch.cuda.OutOfMemoryError as e:
        failed = True
        log(f"FAILED: out of memory at {sizes}: {str(e).splitlines()[0]}")
    launches = {**LK.LAUNCHES, **SK.LAUNCHES}
    log(f"lm path: {time.perf_counter() - t0:.1f} s; kernel launches on the path {launches}; "
        f"peak {torch.cuda.max_memory_allocated()} bytes")
    log("report: " + json.dumps(report, default=str))
    return 1 if failed or any(launches.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
