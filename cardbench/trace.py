"""The device trace of a ``--trace 1`` window: ``torch.profiler`` (CUDA
activity only, read from the raw trace) over the window, reduced to

* the device's busy seconds: the union of its activity intervals (kernels,
  copies, sets), a frozen copy of ``chip_smoke.device_busy``'s arithmetic;
* each kernel's summed device seconds and launches, by name;
* the idle time by what the host was doing: the harness's spans around the
  engine's calls into the backend, painted on 0.1 ms bins, and each bin's
  idle time given to its span.
"""
from __future__ import annotations

import time

import numpy as np

BIN_NS = 100_000            # 0.1 ms bins for the idle attribution
OUTSIDE = "engine_other"    # idle with no harness span open


class DeviceTrace:
    """A profiler whose events inside ``[start, stop)`` of the host clock
    are kept."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.start = self.stop = None

    def __enter__(self):
        """Start the profiler; the window starts at ``self.start``, which
        the caller sets (now, unless it sets it later)."""
        self.prof.__enter__()
        self._perf0, self._wall0 = time.perf_counter_ns(), time.time_ns()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        """Close the window now, then stop the profiler."""
        self.stop = time.perf_counter()
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> tuple[list[str], np.ndarray]:
        """``(names, spans (n, 2) int64 ns on the host's perf_counter clock)``
        of the device activities inside the window."""
        names, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                names.append(e.name())
                spans.append((e.start_ns(), e.end_ns()))
        spans = np.asarray(spans, np.int64).reshape(-1, 2)
        # the trace's clock is the wall clock or the monotonic one (which
        # perf_counter reads): take the one whose window holds more events
        lo, hi = int(self.start * 1e9), int(self.stop * 1e9)
        shift = self._wall0 - self._perf0
        mid = spans.mean(1)
        if ((mid >= lo + shift) & (mid < hi + shift)).sum() > ((mid >= lo) & (mid < hi)).sum():
            spans = spans - shift
        keep = (spans[:, 1] > lo) & (spans[:, 0] < hi)
        spans = np.clip(spans[keep], lo, hi)
        return [n for n, k in zip(names, keep) if k], spans


def busy_runs(spans: np.ndarray) -> np.ndarray:
    """The union of ``spans (n, 2)`` as disjoint sorted runs ``(m, 2)``."""
    if len(spans) == 0:
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    reach = np.maximum.accumulate(spans[:, 1])
    starts = np.concatenate([[True], spans[1:, 0] > reach[:-1]])
    run_id = np.cumsum(starts) - 1
    run_end = np.zeros(int(starts.sum()), np.int64)
    np.maximum.at(run_end, run_id, spans[:, 1])
    return np.stack([spans[starts, 0], run_end], 1)


def by_kernel(names: list[str], spans: np.ndarray) -> dict:
    """``{name: {"s": device seconds, "n": launches}}``."""
    out: dict = {}
    for name, (s, e) in zip(names, spans.tolist()):
        k = out.setdefault(name, {"s": 0.0, "n": 0})
        k["s"] += (e - s) / 1e9
        k["n"] += 1
    return out


def idle_by_span(runs: np.ndarray, host_spans, lo_ns: int, hi_ns: int) -> dict:
    """Idle seconds of the window by the innermost host span open then:
    each 0.1 ms bin's idle time (exact, from the busy runs) goes to the
    span painted on that bin."""
    n_bins = max(1, -(-(hi_ns - lo_ns) // BIN_NS))
    edges = np.minimum(lo_ns + BIN_NS * np.arange(n_bins + 1, dtype=np.int64), hi_ns)
    busy_before = np.zeros(len(edges))        # busy ns before each edge
    if len(runs):
        cum = np.concatenate([[0], np.cumsum(runs[:, 1] - runs[:, 0])])
        j = np.searchsorted(runs[:, 0], edges, side="right") - 1
        inside = np.where(j >= 0, np.minimum(edges - runs[np.maximum(j, 0), 0],
                                             runs[np.maximum(j, 0), 1] - runs[np.maximum(j, 0), 0]), 0)
        busy_before = np.where(j >= 0, cum[np.maximum(j, 0)] + inside, 0)
    idle = np.diff(edges) - np.diff(busy_before)
    label = np.zeros(n_bins, np.int32)
    names = [OUTSIDE]
    # outer spans first, so an inner one paints over the span around it
    for name, s, e in sorted(host_spans, key=lambda x: x[1] - x[2]):
        s, e = int(s * 1e9), int(e * 1e9)
        if e <= lo_ns or s >= hi_ns:
            continue
        if name not in names:
            names.append(name)
        label[max(0, (s - lo_ns) // BIN_NS):(min(e, hi_ns) - lo_ns - 1) // BIN_NS + 1] = \
            names.index(name)
    by = np.bincount(label, weights=idle, minlength=len(names)) / 1e9
    return {n: float(v) for n, v in zip(names, by) if v > 0}


def reduce(trace: DeviceTrace, host_spans) -> dict:
    """Everything the per-layer readers take from the trace."""
    names, spans = trace.events()
    runs = busy_runs(spans)
    lo, hi = int(trace.start * 1e9), int(trace.stop * 1e9)
    kernels = by_kernel(names, spans)
    idle = idle_by_span(runs, host_spans, lo, hi)
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["s"])[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": float((runs[:, 1] - runs[:, 0]).sum()) / 1e9,
        "activities": len(spans),
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[name, v["s"]] for name, v in top],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
