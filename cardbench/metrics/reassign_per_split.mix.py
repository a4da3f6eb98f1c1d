"""Vectors reassigned per split in the window (``SPFreshIndex.stats()``
deltas): LIRE's boundary-only reassignment."""
from cardbench.readers import delta


def read(ctx):
    splits = delta(ctx, "stats", "n_splits")
    return delta(ctx, "stats", "n_reassigned") / splits if splits else None
