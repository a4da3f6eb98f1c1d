#!/usr/bin/env python3
"""One checkout's kernels and two of its smoke paths on the card, for an
A/B of two commits.

Runs ``chip_smoke.py``'s d=100 kernel phases, then its ``update`` path
(N=250,000) and its ``retrieval`` path, all from the checkout at ROOT (its
``chip_smoke.py`` and ``src/``), and prints one ``AB {json}`` line: each
kernel's ms (and on the main path's page mix), the first maintenance
round's ms, aten ops, CUDA kernels and busy ms, the drain rounds' ms, and
the retrieval path's p50s and seconds.  Times vary from host to host, so
compare two commits only within one call, in turns:

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 scripts/ab_on_card.py $r; done
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    # as that checkout's chip_smoke.main does, before CUDA starts
    if "CUBLAS_WORKSPACE_CONFIG" in open(os.path.join(root, "chip_smoke.py")).read():
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [root, os.path.join(root, "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("ab_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    out = {"root": sys.argv[1] if len(sys.argv) > 1 else ".", "card": cs.card_line(),
           "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res: dict = {}
    cs.phase_l2_topk(torch, gen, res)
    blocks = cs.phase_scan_per_query(torch, gen, res)
    cs.phase_scan_batched(torch, gen, res, blocks)
    cs.phase_scan_unreduced(torch, gen, res, blocks)
    cs.phase_scan_q8(torch, gen, res, blocks)
    out["kernel_ms"] = {k: v["ms"] for k, v in res.items()}
    out["mix_ms"] = {k: v["main_mix"]["ms"] for k, v in res.items() if "main_mix" in v}
    del blocks, res
    gc.collect()
    torch.cuda.empty_cache()

    rep: dict = {}
    t0 = time.perf_counter()
    cs.update_path(torch, np, 0, rep)
    out["update_s"] = time.perf_counter() - t0
    for key in ("first_round_ms", "first_round_jobs", "round_aten_ops", "round_cuda_kernels",
                "round_device_ms", "drain_ms_per_round"):
        out[key] = rep[key]
    gc.collect()
    torch.cuda.empty_cache()

    rep = {}
    t0 = time.perf_counter()
    cs.retrieval_path(torch, np, 0, rep)
    out["retrieval_s"] = time.perf_counter() - t0
    for key in ("ann_p50_ms", "bruteforce_p50_ms", "build_s", "add_s", "engine_s"):
        out[key] = rep[key]
    print("AB " + json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
