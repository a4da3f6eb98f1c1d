"""Padding rows over all dispatched rows of the window's batches (the
engine queue's accounting, window deltas)."""
from cardbench.readers import delta


def read(ctx):
    pad, real = delta(ctx, "queue", "padded_rows"), delta(ctx, "queue", "rows")
    return pad / (pad + real) if pad + real else None
