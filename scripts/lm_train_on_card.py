#!/usr/bin/env python3
"""``chip_smoke.py``'s ``lm_train`` part alone, on the card.

Runs ``chip_smoke.lm_train_path``: granite-moe-1b-a400m's ``train_4k`` cell
at its full ``CONFIG`` (24 layers, bf16 params, f32 AdamW state, the
nested remat) through the cell's step, then at 2 layers and full width
the first step against the CPU in f32, remat on against off (the loss
equal, each peak) and a restart under deterministic algorithms.  Prints
the kernels' launches on the part (none), its report and the peak memory;
the exit code is 1 if a check failed.  Needs one NVIDIA GPU; run from the
root of a checkout:

    python3 scripts/lm_train_on_card.py
    python3 scripts/lm_train_on_card.py batch=32 remat=16
    python3 scripts/lm_train_on_card.py probe=8,16,32

``batch=B`` sets the ``train_4k`` batch (``chip_smoke.LM_TRAIN_BATCH``) and
``remat=B`` the remat comparison's (``LM_REMAT``).  ``probe=B,...`` instead
runs one step of the full model at each batch and prints its peak, or the
allocation that failed: the batch that 80 GB holds is found so.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def probe(torch, np, chip_smoke, cfg, batch, seq):
    """One ``train_4k`` step of ``cfg`` at ``(batch, seq)``: its ms and the
    peak memory, or the allocation that failed."""
    from repro_torch.configs.common import lm_step
    from repro_torch.train.optimizer import adamw_init

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"batch": batch, "seq": seq}
    try:
        params = chip_smoke.lm_init(torch, cfg, 0, "cuda")
        opt = adamw_init(params)
        b = chip_smoke.on_device(torch, chip_smoke.lm_train_batch_fn(np, 0, cfg, batch, seq)(0),
                                 "cuda")
        _, s = chip_smoke.timed(torch, lambda: lm_step("train", cfg)(params, opt, b))
        out.update(ms=s * 1e3, peak_bytes=torch.cuda.max_memory_allocated())
    except torch.cuda.OutOfMemoryError as e:
        out.update(failed=str(e).splitlines()[0], peak_bytes=torch.cuda.max_memory_allocated())
    params = opt = b = None
    gc.collect()
    return out


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    import chip_smoke
    from chip_smoke import log
    from repro_torch.configs import granite_moe_1b_a400m
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    if not torch.cuda.is_available():
        print("lm_train_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    kw = {"batch": chip_smoke.LM_TRAIN_BATCH, "remat": dict(chip_smoke.LM_REMAT)}
    probes = []
    for arg in sys.argv[1:]:
        key, val = arg.split("=")
        if key == "probe":
            probes = [int(x) for x in val.split(",")]
        elif key == "remat":
            kw["remat"]["batch"] = int(val)
        else:
            kw[key] = int(val)
    if probes:
        cfg = granite_moe_1b_a400m.CONFIG
        for b in probes:
            log(f"probe: {json.dumps(probe(torch, np, chip_smoke, cfg, b, chip_smoke.LM_TRAIN_SEQ))}")
        return 0
    report, failed = {}, False
    t0 = time.perf_counter()
    try:
        chip_smoke.lm_train_path(torch, np, 0, report, **kw)
    except chip_smoke.Fail as e:
        failed = True
        log(f"FAILED: {e}")
    except torch.cuda.OutOfMemoryError as e:
        failed = True
        log(f"FAILED: out of memory at {kw}: {str(e).splitlines()[0]}")
    launches = {**LK.LAUNCHES, **SK.LAUNCHES}
    log(f"lm_train: {time.perf_counter() - t0:.1f} s; kernel launches on the part {launches}; "
        f"peak {torch.cuda.max_memory_allocated()} bytes")
    log("report: " + json.dumps(report, default=str))
    return 1 if failed or any(launches.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
