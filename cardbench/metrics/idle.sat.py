"""The share of the traced window with no kernel or copy running on the
card (the union of its activity intervals)."""
from cardbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
