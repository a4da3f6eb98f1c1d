"""The 95th percentile of every search request due in the window, from
when it was due (open loop) or sent (closed loop) until its ticket
resolved with results on the host."""
from cardbench.readers import p95_ms


def read(ctx):
    return p95_ms(ctx, "search")
