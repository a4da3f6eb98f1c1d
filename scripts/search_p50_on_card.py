#!/usr/bin/env python3
"""The main path's search p50 at several base sizes, on the card.

For each N, builds ``chip_smoke.py``'s main-path index as
``chip_smoke.main_path`` does (``make_spacev_int8`` from seed 0,
``SPFreshIndex.build`` at ``path_config``), then times Q=1,024 searches:
first in the smoke's order (each schedule warmed, then 5 searches, as its
p50), then ``reps`` more of each schedule in turns.  It also times the
kernels inside one search by CUDA events, and profiles one search of each
schedule under ``torch.profiler``: the ops that took the most device time
and the most host time.  Prints one ``P50 {json}`` line per N, with the
card's name and power limit.  Needs one NVIDIA GPU; run from the root of
a checkout:

    python3 scripts/search_p50_on_card.py n=500000,1000000 reps=21 cell=fp32
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SCHEDULES = ("batched", "per_query")
TOP = 12


def profiled(torch, fn):
    """``fn()`` once under ``torch.profiler``: the ``TOP`` ops by device time
    and by host (self CPU) time, in ms, with their counts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e, kind="device_time_total"):
        return getattr(e, kind, None) or getattr(e, kind.replace("device", "cuda"), 0)

    by_device = sorted(events, key=device_us, reverse=True)[:TOP]
    by_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
    return {"device_ms": [(e.key, device_us(e) / 1e3, e.count) for e in by_device],
            "host_ms": [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in by_host],
            "device_ms_total": sum(device_us(e, "self_device_time_total") for e in events) / 1e3}


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    ns = [int(x) for x in args.get("n", "500000,1000000").split(",")]
    reps = int(args.get("reps", 21))
    cell = args.get("cell", "fp32")
    import torch

    import chip_smoke as cs
    from repro_torch.configs.spfresh import SEARCH_Q, UPDATE_B
    from repro_torch.core.index import SPFreshIndex
    from repro_torch.data.vectors import make_queries, make_spacev_int8
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("search_p50_on_card: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    card = cs.card_line()
    cfg = cs.path_config(cell)
    for n in ns:
        data = make_spacev_int8(n + 4 * UPDATE_B, cfg.dim, seed=0)
        base = data[:n]
        queries = make_queries(base, SEARCH_Q, seed=0)
        idx, build_s = cs.timed(torch, lambda: SPFreshIndex.build(cfg, base, seed=0,
                                                                  device="cuda"))

        def search(schedule):
            return idx.search_padded(queries, 10, nprobe=cfg.nprobe, use_pallas_scan=True,
                                     scan_schedule=schedule)

        smoke_order = {}
        for s in SCHEDULES:
            search(s)
            smoke_order[s] = [cs.timed(torch, lambda: search(s))[1] * 1e3 for _ in range(5)]
        turns = {s: [] for s in SCHEDULES}
        for _ in range(reps):
            for s in SCHEDULES:
                turns[s].append(cs.timed(torch, lambda: search(s))[1] * 1e3)
        inside = {}
        for s in SCHEDULES:
            _, kms, host_ms = cs.kernel_ms_in(torch, lambda: search(s))
            inside[s] = dict(kernel_ms={k: v for k, v in kms.items() if v}, host_ms=host_ms)
        st = idx.stats()
        out = dict(card=card, cell=cell, n=n, reps=reps, build_s=build_s,
                   n_postings=st["n_postings"], used_blocks=st["used_blocks"],
                   smoke_order_p50_ms={s: statistics.median(v) for s, v in smoke_order.items()},
                   smoke_order_ms=smoke_order,
                   p50_ms={s: statistics.median(v) for s, v in turns.items()},
                   min_ms={s: min(v) for s, v in turns.items()},
                   max_ms={s: max(v) for s, v in turns.items()},
                   inside=inside, profile={s: profiled(torch, lambda: search(s))
                                           for s in SCHEDULES})
        print("P50 " + json.dumps(out, default=str), flush=True)
        del idx, data, base
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
