#!/usr/bin/env python3
"""``chip_smoke.py``'s ``train`` main path alone, on the card.

Builds the CUDA kernels, then runs ``chip_smoke.train_path``: each recsys
family's ``train_batch`` cell at its published width through ``Trainer``
(the first step held against the CPU, the step split into forward,
backward and AdamW), the trained towers served through
``IndexedRetriever``, and the MIND restart under deterministic
algorithms.  Prints the kernels' launches on the path and the path's
report; the exit code is 1 if a check failed.  Needs one NVIDIA GPU; run
from the root of a checkout:

    python3 scripts/train_path_on_card.py
    python3 scripts/train_path_on_card.py mind=65536 two-tower-retrieval=49152

With ``ARCH=ROWS`` arguments it instead probes whether those batches fit:
each family's steps alone (``chip_smoke.train_family``) at that many rows
a batch, reporting the peak memory, or the allocation that failed.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fit(torch, np, chip_smoke, arch, rows):
    """Two steps of ``arch``'s ``train_batch`` cell at its ``CONFIG`` and
    ``rows`` rows a batch through ``Trainer``: the peak memory, or the
    allocation that failed."""
    import gc

    from repro_torch.configs.common import OPT
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = chip_smoke.train_cells(arch)[0].CONFIG
    loss = chip_smoke.train_cells(arch)[1]
    torch.cuda.reset_peak_memory_stats()
    out = {"rows": rows}
    try:
        params = chip_smoke.train_init(torch, arch, cfg, 0, "cuda")
        Trainer(loss_fn=lambda p, b: loss(p, b, cfg), init_params_fn=lambda: params,
                batch_fn=chip_smoke.train_batch_fn(np, arch, cfg, rows, 0, "cuda"), opt_cfg=OPT,
                trainer_cfg=TrainerConfig(total_steps=2), device="cuda").run()
        out["fits"] = True
    except torch.cuda.OutOfMemoryError as e:
        out.update(fits=False, error=str(e).splitlines()[0])
    params = None
    gc.collect()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    chip_smoke.log(f"[fit] {arch} at {rows} rows a batch: {out}")
    return out


def main() -> int:
    # the MIND restart runs under deterministic algorithms: cuBLAS needs a
    # fixed workspace, read when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    import chip_smoke
    from chip_smoke import log
    from repro_torch.kernels import build
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    if not torch.cuda.is_available():
        print("train_path_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    probes = [a.split("=") for a in sys.argv[1:]]
    if probes:
        report = {arch: fit(torch, np, chip_smoke, arch, int(rows)) for arch, rows in probes}
        log("report: " + json.dumps(report))
        return 0
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    report, failed = {}, False
    t0 = time.perf_counter()
    try:
        chip_smoke.train_path(torch, np, 0, report)
    except chip_smoke.Fail as e:
        failed = True
        log(f"FAILED: {e}")
    launches = {**LK.LAUNCHES, **SK.LAUNCHES}
    log(f"train path: {time.perf_counter() - t0:.1f} s; kernel launches on the path {launches}")
    log("report: " + json.dumps(report, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
