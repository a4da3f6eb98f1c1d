#!/usr/bin/env python3
"""A benchmark cell run with the port's span recorder on, and what its spans
say: where a search's dispatch, a request's wait in the queue and a
maintenance round spend their host time, and which program span the card
sat idle under.

Each run goes through ``cardbench``'s own ``bench.run``, unchanged, in this
one process; four hooks around it turn the recorder on as the traffic
starts (before the warm-up), off once the window has closed, keep the device
trace's busy runs and the harness's spans, and report the cell's
end-to-end metrics beside its per-layer ones.  Every run is traced
(``--trace 1``).  Runs go in turns, recorder off then on for the first
seed, on then off for the next, so that the recorder's cost reads off pairs
on one card.  Needs one NVIDIA GPU; from the root of a checkout:

    python3 scripts/spans_on_card.py --workload spacev.search_sat,spacev.update_mix \
        --seeds 11,12 --seconds 30 --warmup 5

The script stands in for the harness until ``cardbench``'s ``bench.run``
turns the recorder on and reads these numbers itself; it goes then.

The process first prints ``SPAN_COSTS``, a span site's host cost here.
Each run prints a ``SPANS`` JSON line and appends it to
``chiprun_out/spans/runs.jsonl``, and writes its window's spans to
``chiprun_out/spans/<cell>_<seed>_<on|off>.json.gz``.  Its numbers:

* ``search_enqueue_ms``: mean length of the ``search`` spans inside the
  window (as every reading but ``queue_wait_ms``: wholly inside);
* ``queue_wait_ms``: mean length of the search ``queue.wait`` spans whose
  batch formed in the window;
* ``round_enqueue_ms``: mean over the window's ``round`` spans of their
  length less their ``round.readback`` child (``round_readback_ms``);
* ``dispatch_idle``: idle seconds painted on ``search`` and its
  children, over the window;
* ``idle_by_span``: idle seconds by the innermost span open, the
  harness's and the program's (``queue.wait`` is another thread's and is
  not painted), and ``harness_idle_share``, the share left to harness-only
  names;
* ``self_s``: each span name's summed self time in the window, and
  ``count``.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the names the harness's own spans and its idle attribution use
HARNESS = ("search_dispatch", "readback_wait", "insert_dispatch", "delete_dispatch",
           "maintenance_round", "engine_other")
NOT_PAINTED = ("queue.wait",)


def _in(t_ns: int, window) -> bool:
    return window[0] * 1e9 <= t_ns < window[1] * 1e9


def _mean_ms(values):
    return 1e3 * statistics.fmean(values) if values else None


def program_numbers(spans, window, runs=None, harness_spans=(), lohi=None) -> dict:
    """What the spans of one run say about its window ``(w0, w1)`` (host
    seconds on ``perf_counter``); with the device trace's busy ``runs``
    (ns) and its ``lohi`` bounds, the idle time by span as well."""
    from repro_torch.utils import trace

    # spans wholly inside: one open as the window closes can run on for the
    # seconds the profiler takes to stop
    inside = [s for s in spans if _in(s.start_ns, window) and s.end_ns < window[1] * 1e9]
    search = [s.seconds for s in inside if s.name == "search"]
    waits = [s.seconds for s in spans
             if s.name == "queue.wait" and s.tag == "search" and _in(s.end_ns, window)]
    readback: dict[int, int] = {}
    for s in spans:
        if s.name == "round.readback" and s.parent is not None:
            readback[s.parent] = readback.get(s.parent, 0) + s.end_ns - s.start_ns
    rounds = [s for s in inside if s.name == "round"]
    own = trace.self_ns(spans)
    self_s: dict[str, float] = {}
    count: dict[str, int] = {}
    for s in inside:
        self_s[s.name] = self_s.get(s.name, 0.0) + own[s.id] / 1e9
        count[s.name] = count.get(s.name, 0) + 1
    out = {
        "search_enqueue_ms": _mean_ms(search),
        "queue_wait_ms": _mean_ms(waits),
        "round_enqueue_ms": _mean_ms([(s.end_ns - s.start_ns - readback.get(s.id, 0)) / 1e9
                                      for s in rounds]),
        "round_readback_ms": _mean_ms([readback.get(s.id, 0) / 1e9 for s in rounds]),
        "round_ms": _mean_ms([s.seconds for s in rounds]),
        "self_s": self_s,
        "count": count,
    }
    if runs is not None:
        idle = painted_idle(runs, harness_spans, spans, *lohi)
        total = sum(idle.values())
        out["idle_by_span"] = idle
        out["dispatch_idle"] = sum(v for n, v in idle.items()
                                   if n == "search" or n.startswith("search.")) \
            / ((lohi[1] - lohi[0]) / 1e9)
        out["harness_idle_share"] = (sum(idle.get(n, 0.0) for n in HARNESS) / total
                                     if total else None)
    return out


def painted_idle(runs, harness_spans, spans, lo_ns: int, hi_ns: int) -> dict:
    """Idle seconds by the innermost span open, the harness's
    ``(name, start_s, end_s)`` and the program's spans together, by
    ``cardbench.trace.idle_by_span``."""
    from cardbench import trace as btrace

    host = list(harness_spans) + [(s.name, s.start_ns / 1e9, s.end_ns / 1e9)
                                  for s in spans if s.name not in NOT_PAINTED]
    return btrace.idle_by_span(runs, host, lo_ns, hi_ns)


def measure(root, workload: str, seed: int, seconds: float, recorder: bool,
            **run_kw) -> dict:
    """One traced ``bench.run`` of ``workload`` with the recorder on or off:
    ``(row, spans)``, the row holding the result line's metrics and
    ``correct`` and :func:`program_numbers`, the spans those that overlap
    the window."""
    from cardbench import bench, generator, spec, system
    from cardbench import trace as btrace
    from repro_torch.utils import trace

    got: dict = {"edges": []}
    orig = (generator.Traffic, system.counters, btrace.reduce, spec.Benchmark.metrics)

    def traffic(*a, **kw):
        trace.take()
        if recorder:
            trace.enable()
        return orig[0](*a, **kw)

    def counters(svc):
        got["edges"].append(time.perf_counter())
        if len(got["edges"]) == 2:       # the window's close
            trace.disable()
        return orig[1](svc)

    def reduce(tr, host_spans):
        _, dev = tr.events()
        got.update(runs=btrace.busy_runs(dev), harness=list(host_spans),
                   lohi=(int(tr.start * 1e9), int(tr.stop * 1e9)))
        return orig[2](tr, host_spans)

    def metrics(self, cell, traced):
        return orig[3](self, cell, False) + orig[3](self, cell, True)

    generator.Traffic, system.counters, btrace.reduce = traffic, counters, reduce
    spec.Benchmark.metrics = metrics
    try:
        out = bench.run(root, workload, seed, seconds, True, t_start=time.perf_counter(),
                        **run_kw)
    finally:
        generator.Traffic, system.counters, btrace.reduce, spec.Benchmark.metrics = orig
        trace.disable()
    spans = trace.take()
    # the window is the device trace's: it closes before the profiler stops,
    # which takes seconds and comes before the harness's second reading of
    # its counters.  On a host without a card nothing is traced: the
    # counters' readings bound the window and no idle is read.
    window = tuple(x / 1e9 for x in got["lohi"]) if "lohi" in got else tuple(got["edges"])
    nums = program_numbers(spans, window, got.get("runs"), got.get("harness", ()),
                           got.get("lohi"))
    row = {"workload": workload, "seed": seed, "recorder": recorder,
           "correct": out["correct"], "device": out["device"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "window": window, "n_spans": len(spans), **nums}
    return row, [s for s in spans if _in(s.end_ns, window) or _in(s.start_ns, window)]


def span_costs(n: int = 200_000) -> dict:
    """Host microseconds of one span site on this machine: off (the flag's
    branch and the shared context), on (a recorded span), and ``timed``
    off (its two clock reads)."""
    from repro_torch.utils import trace

    def loop(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make("search.scan"):
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    trace.disable()
    off, timed_off = loop(trace.span), loop(trace.timed)
    trace.enable()
    on = loop(trace.span)
    trace.disable()
    trace.take()
    return {"span_off_us": off, "span_on_us": on, "timed_off_us": timed_off}


def dump(path: Path, spans) -> None:
    """The window's spans, one ``[name, start_ns, end_ns, id, parent, thread,
    batch, tag]`` row each, gzipped JSON."""
    rows = [[s.name, s.start_ns, s.end_ns, s.id, s.parent, s.thread, s.batch, s.tag]
            for s in spans]
    with gzip.open(path, "wt") as f:
        json.dump(rows, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="comma-separated cells, run in turn")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, each cell's")
    ap.add_argument("--warmup", type=float, default=0.0,
                    help="seconds of an unreported first run of the first cell (the "
                         "process's first run is slower than the rest)")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    # the harness's build and kernel caches, as its command line sets them
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    if not torch.cuda.is_available():
        print("spans_on_card: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20).stdout.strip()
    out_dir = ROOT / "chiprun_out" / "spans"
    out_dir.mkdir(parents=True, exist_ok=True)
    costs = span_costs()
    print("SPAN_COSTS " + json.dumps({**costs, "card": card}), flush=True)
    cells = args.workload.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.warmup > 0:
        measure(ROOT, cells[0], seeds[0] + 1, args.warmup, False)
    for cell in cells:
        for i, seed in enumerate(seeds):
            for rec in ((False, True) if i % 2 == 0 else (True, False)):
                row, spans = measure(ROOT, cell, seed, args.seconds, rec)
                row["card"] = card
                line = json.dumps(row)
                print("SPANS " + line, flush=True)
                with open(out_dir / "runs.jsonl", "a") as f:
                    f.write(line + "\n")
                if spans:
                    dump(out_dir / f"{cell}_{seed}_{'on' if rec else 'off'}.json.gz", spans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
