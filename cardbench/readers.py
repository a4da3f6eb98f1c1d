"""What the metric readers under ``cardbench/metrics/`` share.  A reader is
a file ``metrics/<metric name>.py`` with ``read(ctx) -> float | None``;
``None`` means it found nothing to read, and the metric is left out of
the result line.

``ctx`` holds: ``window`` (start, stop on the host clock), ``t_start``
(the process's start), ``log`` (every request, ``generator.Request``),
``finished`` (when the last answer came or the wait ended), ``setup``
(seconds by set-up step), ``counters`` (``system.counters`` at the
window's start and stop), ``numbers`` (what ``check.numbers`` compared),
``config`` (the configuration file), and in a ``--trace 1`` run ``trace``
(``trace.reduce``), ``batches`` (each dispatched search batch's rows and
live pages) and ``p_live`` (live postings).
"""
from __future__ import annotations

import math

import numpy as np

from cardbench import roofline


def window_requests(ctx, kind: str):
    w0, w1 = ctx["window"]
    return [r for r in ctx["log"] if r.kind == kind and w0 <= r.due < w1]


def p95_ms(ctx, kind: str):
    """The 95th percentile of every ``kind`` request due in the window, from
    when it was due to when it resolved; one that never resolved counts
    the whole wait."""
    reqs = window_requests(ctx, kind)
    if not reqs:
        return None
    lat = [(ctx["finished"] if math.isnan(r.done) else r.done) - r.due for r in reqs]
    return float(np.percentile(np.asarray(lat), 95)) * 1e3


def delta(ctx, *path):
    a, b = ctx["counters"]
    for key in path:
        a, b = a[key], b[key]
    return b - a


def window_s(ctx) -> float:
    w0, w1 = ctx["window"]
    return w1 - w0


def idle_share(ctx):
    tr = ctx.get("trace")
    if not tr or tr["activities"] == 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def template_args(name: str) -> list[str]:
    """The top-level template arguments of a demangled kernel name."""
    lt = name.find("<")
    if lt < 0:
        return []
    depth, args, cur = 0, [], ""
    for ch in name[lt + 1:]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            if depth == 0:
                break
            depth -= 1
        elif ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        cur += ch
    return args + [cur.strip()]


def kernel_seconds(ctx, match) -> float:
    """Summed device seconds of the kernels ``match(name)``."""
    tr = ctx.get("trace") or {}
    return sum(v["s"] for name, v in tr.get("kernels", {}).items() if match(name))


def roofline_share(ctx, match, work, op_rate):
    """100 x the least time of the window's batches (``work(batch, cfg, ctx) ->
    (ops, bytes)``) over the matched kernels' device time; None where no
    such kernel ran or no batch was recorded."""
    secs = kernel_seconds(ctx, match)
    batches = ctx.get("batches")
    if not secs or not batches:
        return None
    cfg = ctx["config"]["lire"]
    least = sum(roofline.least_s(*work(b, cfg, ctx), op_rate) for b in batches)
    return 100.0 * least / secs
