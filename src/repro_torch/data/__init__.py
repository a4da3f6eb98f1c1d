"""Synthetic vector datasets (a numpy-only copy of the reference's)."""
from repro_torch.data.vectors import (  # noqa: F401
    UpdateWorkload,
    make_queries,
    make_shifting_stream,
    make_sift_like,
    make_spacev_int8,
    make_spacev_like,
    make_spacev_like_bytes,
    to_bytes,
)
