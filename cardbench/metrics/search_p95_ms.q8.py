"""``search_p95_ms`` of the int8 cell, read in its traced run: the 95th
percentile of every search request sent in the window (closed loop),
sent to resolved on the host.  It is no end-to-end metric there: between
runs it follows the host's speed by more than half of the largest bound
the benchmark may set."""
from cardbench.readers import p95_ms


def read(ctx):
    return p95_ms(ctx, "search")
