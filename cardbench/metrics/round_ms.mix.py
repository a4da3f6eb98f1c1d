"""Milliseconds a maintenance round in the window (``maint_time_s`` over
``maint_rounds``, window deltas)."""
from cardbench.readers import delta


def read(ctx):
    rounds = delta(ctx, "maintenance", "rounds")
    return 1e3 * delta(ctx, "maintenance", "time_s") / rounds if rounds else None
