"""Query vectors whose search tickets resolved in the window, a second."""
from cardbench.readers import window_s


def read(ctx):
    w0, w1 = ctx["window"]
    rows = sum(r.rows for r in ctx["log"] if r.kind == "search" and w0 <= r.done < w1)
    return rows / window_s(ctx) if rows else None
