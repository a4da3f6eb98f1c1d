"""The sweep that sets ``open_search_ingest``'s two rates (not run by the
benchmark).  Every step starts from a fresh service, from set-up on, as the
benchmark's runs do: a service that earlier trials have already split
reads a higher knee than the benchmark sustains.

1. ingestion alone, closed loop: one client sends an insert ticket and its
   delete ticket and waits for both, for ``--ingest-seconds``; ``R`` is the
   pairs a second it sustains;
2. for each share of ``R`` in ``--ingest-shares`` (highest first), the knee
   test at each rate of ``--search-rates`` (lowest first, up to the first
   that fails): open-loop ingestion at that share and Poisson searches at
   that rate, ``LEAD_S`` unmeasured, then ``--trial-seconds``;
3. the first share at which some search rate passes is the ingestion
   rate; the search rate is 4/5 of the highest rate that passed there.

The knee test (``knee``) holds searches, inserts and deletes alike: of
each kind's requests due in the trial (up to ``MARGIN_S`` before its
close), at least 99% resolved by the close, and of the rows of those
inserts at least 99% landed; and no kind has more requests outstanding at
the close than at the trial's middle plus ``SLACK``.  (Rows are counted,
not tickets: the engine drops a row now and then when its posting stays
full through every retry, on an idle index too.)

    python3 cardbench/sweep.py --config spacev-shard --traffic open_search_ingest --seed 7

prints a ``SWEEP`` JSON line a step and a last one with the two rates.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SLACK = 4           # requests a queue may gain from the middle to the close
LEAD_S = 5.0        # unmeasured lead-in of a trial (the benchmark's warm-up)
MARGIN_S = 1.0      # requests due this close to the close need not resolve by it
KINDS = ("search", "insert", "delete")


def outstanding(log, kind: str, t: float) -> int:
    """``kind`` requests sent by ``t`` and not resolved by it."""
    return sum(1 for r in log if r.kind == kind and r.sent <= t
               and (math.isnan(r.done) or r.done > t))


def knee(log, t0: float, t1: float) -> dict:
    """The knee test over the trial ``[t0, t1)`` of a traffic ``log``."""
    mid = (t0 + t1) / 2
    res = {}
    ok = True
    for kind in KINDS:
        due = [r for r in log if r.kind == kind and t0 <= r.due < t1 - MARGIN_S]
        if not due:
            continue
        good = [r for r in due if r.done <= t1 and r.error is None]
        lat = sorted((r.done - r.due) * 1e3 for r in due if not math.isnan(r.done))
        o_mid, o_end = outstanding(log, kind, mid), outstanding(log, kind, t1)
        res[kind] = {"due": len(due), "resolved": len(good), "outstanding_mid": o_mid,
                     "outstanding_end": o_end,
                     "p95_ms": lat[int(0.95 * (len(lat) - 1))] if lat else None}
        ok &= len(good) >= 0.99 * len(due) and o_end <= o_mid + SLACK
        if kind == "insert":
            landed = sum(int(np.asarray(r.out[1]).sum()) for r in good)
            res[kind]["landed_rows"], res[kind]["rows"] = landed, sum(r.rows for r in due)
            ok &= landed >= 0.99 * res[kind]["rows"]
    res["pass"] = bool(ok)
    return res


def fresh_service(torch, cfg, seed: int, device: str):
    from cardbench import bench

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return bench.set_up(torch, cfg, seed, device)


def ingest_alone(torch, cfg, mix, args) -> float:
    """Insert and delete pairs a second that one closed-loop client gets on
    a fresh service."""
    from cardbench import generator

    svc, dat, _ = fresh_service(torch, cfg, args.seed, args.device)
    tr = generator.Traffic(svc.engine, mix, dat, args.seed)
    ing = mix["ingest"]
    pairs, t0 = 0, time.perf_counter()
    while time.perf_counter() < t0 + args.ingest_seconds:
        r, dr = ing["insert_rows"], ing["delete_rows"]
        vids = (tr.n_base + pairs * r + np.arange(r)).astype(np.int32)
        gone = tr._victims[pairs * dr:(pairs + 1) * dr]
        t_i = svc.engine.submit_insert(dat["pool"][vids - tr.n_base], vids)
        t_d = svc.engine.submit_delete(gone)
        t_i.result(timeout=60.0)
        t_d.result(timeout=60.0)
        pairs += 1
    rate = pairs / (time.perf_counter() - t0)
    svc.close()
    return rate


def trial(torch, cfg, mix, args, search_rate: float, ingest_rate: float) -> dict:
    """The knee test at one pair of rates on a fresh service."""
    from cardbench import generator

    svc, dat, setup = fresh_service(torch, cfg, args.seed, args.device)
    m = json.loads(json.dumps(mix))
    m["search"]["rate_per_s"] = search_rate
    m["ingest"]["rate_per_s"] = ingest_rate
    tr = generator.Traffic(svc.engine, m, dat, args.seed)
    start = time.perf_counter() + 0.2
    t0, t1 = start + LEAD_S, start + LEAD_S + args.trial_seconds
    tr.start(start, t1)
    try:
        tr.finish()
    except RuntimeError as e:    # answers still missing a minute past the close
        print(f"SWEEP unfinished: {e}", flush=True)
    counters = svc.engine.report()["maintenance"]
    svc.close()
    res = {"search_rate": search_rate, "ingest_rate": ingest_rate,
           "setup_s": sum(setup.values()), **knee(tr.log, t0, t1),
           "maint_forced": counters.get("forced")}
    print("SWEEP " + json.dumps(res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ingest-seconds", type=float, default=10.0)
    ap.add_argument("--trial-seconds", type=float, default=30.0)
    ap.add_argument("--ingest-shares", default="0.5,0.25",
                    help="shares of the closed-loop ingestion rate to try, highest first")
    ap.add_argument("--search-rates", default="30,60,90,120",
                    help="search requests a second to try at each share, lowest first")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from cardbench import spec

    b = spec.Benchmark(ROOT)
    cfg, mix = b.config(args.config), b.traffic(args.traffic)
    alone = ingest_alone(torch, cfg, mix, args)
    print("SWEEP " + json.dumps({"ingest_alone_pairs_per_s": alone}), flush=True)
    for share in (float(s) for s in args.ingest_shares.split(",")):
        passed = []
        for rate in (float(r) for r in args.search_rates.split(",")):
            if not trial(torch, cfg, mix, args, rate, share * alone)["pass"]:
                break
            passed.append(rate)
        if passed:
            print("SWEEP " + json.dumps({"ingest_share": share, "ingest_rate": share * alone,
                                         "knee_rate": passed[-1],
                                         "search_rate": 0.8 * passed[-1]}), flush=True)
            return 0
    print("SWEEP " + json.dumps({"search_rate": None}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
