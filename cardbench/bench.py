"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics.  ``run.py`` is its command line.

Set-up, in order: the kernels (loaded from the checkout's
``build/kernels``; the first run there compiles them), the data from the
seed, the build through ``repro_torch.api.open``, the drain of the
backlog the build leaves (``Service.drain``), and the warm-up: the cell's
own traffic for the mix's ``warmup_s``, which flows on into the window, so
the window starts under load and with every shape the traffic uses
already dispatched.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np

from cardbench import check, data as bdata, faults, generator, guard, spec, system
from cardbench import trace as btrace


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class GuardError(RuntimeError):
    pass


def _sleep_until(t: float) -> None:
    while (dt := t - time.perf_counter()) > 0:
        time.sleep(min(dt, 0.5))


def _page_stats(torch, svc, batches, window, device):
    """The rows and live pages of each search batch dispatched in the
    window, on the state the window ran against (no update ran in a cell
    that records them)."""
    from repro_torch.core import lire

    state = svc.index.state
    budget = state.cfg.scan_page_budget
    out = []
    with torch.no_grad():
        for t, q, nprobe in batches:
            if not window[0] <= t < window[1]:
                continue
            st = lire.scan_page_stats(state, torch.as_tensor(q, device=device), nprobe=nprobe)
            n_unique, overflow = int(st["n_unique"]), int(st["overflow"])
            out.append({"q": len(q), "nprobe": nprobe, "n_unique": n_unique,
                        "overflow": overflow, "n_pages": int(st["n_pages"]),
                        "n_kept": min(n_unique, budget) if budget else n_unique})
    return out


def set_up(torch, cfg: dict, seed: int, device: str):
    """The kernels, the data, the build and the drain: ``(service, data,
    seconds by step)``."""
    card = device == "cuda"
    setup = {}
    t0 = time.perf_counter()
    if card:
        from repro_torch.kernels import build
        build.build_all()
        for name in build.SIGNATURES:
            build.library(name)
    setup["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dat = bdata.make(cfg, seed)
    setup["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = system.open_service(cfg, dat["base"], seed, device)
    if card:
        torch.cuda.synchronize()
    setup["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    drained = svc.drain()
    if card:
        torch.cuda.synchronize()
    setup["drain"] = time.perf_counter() - t0
    st = svc.stats()
    log(f"[setup] kernels {setup['kernels']:.2f} s, data {setup['data']:.2f} s, build "
        f"{setup['build']:.2f} s ({st['n_postings']} postings), drain {setup['drain']:.2f} s "
        f"({drained} jobs, backlog now {svc.backlog()})")
    return svc, dat, setup


def run(root, workload: str, seed: int, seconds: float, traced: bool, *, t_start: float,
        device: str = "cuda", edit_config=None, edit_mix=None, fault: str | None = None,
        controls: dict | None = None) -> dict:
    """Run ``workload`` once and return the result line's object.
    ``edit_config`` / ``edit_mix`` (dict -> dict) shrink a cell for a CPU
    test and ``fault`` plants one of ``faults.py``'s.  ``controls`` (name
    -> ``answers(live, queries, seqnos)``) judges other answerers on the
    same sample, each in the program's place; their numbers come back
    under the key ``controls``, which the result line never has."""
    import torch

    bench = spec.Benchmark(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    cfg = edit_config(cfg) if edit_config else cfg
    mix = edit_mix(mix) if edit_mix else mix
    card = device == "cuda"
    k = cfg["serve"]["search_k"]
    spans = system.Spans()

    svc, dat, setup = set_up(torch, cfg, seed, device)

    batches = [] if traced else None
    if traced:
        system.record_dispatches(svc, spans, batches)
    if fault is not None:
        faults.plant(fault, svc)
    if card:
        torch.cuda.reset_peak_memory_stats()
    # the profiler starts before the warm-up: starting it stalls the card
    # for seconds, and only the window's events are kept
    tr = btrace.DeviceTrace(torch) if traced and card else None
    if tr is not None:
        tr.__enter__()
    traffic = generator.Traffic(svc.engine, mix, dat, seed)
    now = time.perf_counter()
    w0 = now + mix["warmup_s"]
    w1 = w0 + seconds
    traffic.start(now, w1)
    _sleep_until(w0)
    counters0 = system.counters(svc)
    if tr is not None:
        tr.start = time.perf_counter()
    _sleep_until(w1)
    if tr is not None:
        tr.__exit__(None, None, None)
    counters1 = system.counters(svc)
    setup["warmup"] = w0 - now
    traffic.finish()
    finished = time.perf_counter()
    log(f"[window] {seconds} s closed; every answer in {finished - w1:.2f} s after the close")

    found = guard.loaded()
    if found:
        raise GuardError(f"loaded after the window: {found}")
    probed = check.probes(svc.engine, traffic.log, check.live_sets(traffic.log, dat), seed, k)
    peak = torch.cuda.max_memory_allocated() if card else None
    static = all(r.kind == "search" for r in traffic.log)
    page_stats = _page_stats(torch, svc, batches, (w0, w1), device) if batches and static \
        else None
    p_live = svc.stats()["n_postings"]
    svc.close()
    del svc
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    reduced = btrace.reduce(tr, spans.items) if tr is not None else None
    tr = None
    t0 = time.perf_counter()
    nums = check.numbers(traffic.log, dat, (w0, w1), seed, device=device, k=k, probed=probed)
    log(f"[check] the reference over {nums['sampled_rows']} sampled rows in "
        f"{time.perf_counter() - t0:.2f} s")
    correct, checks = check.verdict(nums, cfg["limits"])

    ctx = {"window": (w0, w1), "t_start": t_start, "log": traffic.log, "finished": finished,
           "setup": setup, "counters": (counters0, counters1), "numbers": nums,
           "config": cfg, "trace": reduced, "batches": page_stats, "p_live": p_live}
    metrics = {}
    for m in bench.metrics(workload, traced):
        v = bench.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    window = [r for r in traffic.log if w0 <= r.due < w1]
    failed = sum(1 for r in window if math.isnan(r.done)
                 or (r.kind == "insert" and not np.asarray(r.out[1]).all()))
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(window), "failed": failed, "metrics": metrics,
           "device": dev}
    if reduced is not None:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        out["breakdown"] = reduced["breakdown"]
    if page_stats:
        log(f"[pages] {len(page_stats)} batches: mean unique "
            f"{np.mean([b['n_unique'] for b in page_stats]):.1f}, overflow in "
            f"{sum(b['overflow'] > 0 for b in page_stats)}")
    log(f"[counters] setup {setup}; window queue {counters1['queue']}, maintenance "
        f"{counters1['maintenance']}; numbers {nums}")
    out["checks"] = checks
    if controls:
        out["controls"] = {
            name: check.numbers(traffic.log, dat, (w0, w1), seed, device=device, k=k,
                                probed=probed, answers=fn)
            for name, fn in controls.items()}
    return out
