"""Distance primitives and the stable top-k shared by the whole index.

All SPFresh math is squared Euclidean.  ``jax.lax.top_k`` returns the
lowest index first among equal values and the reference relies on it;
``torch.topk`` promises no order among ties, so every top-k outside a
kernel goes through :func:`stable_topk`, built on a stable sort.
"""
from __future__ import annotations

import torch

# Larger than any attainable squared distance; finite so sorts stay stable.
MASK_DISTANCE = 3.0e38


def stable_topk(
    x: torch.Tensor, k: int, *, largest: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim, ties broken toward the lower index.

    Returns ``(values (..., k), indices (..., k) int64)``."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, computed in f32."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def pairwise_sql2(q, x, x_sqn=None) -> torch.Tensor:
    """Pairwise squared L2 ``(m, n)`` between ``q (m, d)`` and ``x (n, d)``.

    Uses the expansion ``‖q‖² − 2 qᵀx + ‖x‖²`` as one f32 matmul (full f32:
    PyTorch leaves ``allow_tf32`` off for matmuls), clamped at 0."""
    qf = q.float()
    q_sqn = torch.sum(qf * qf, dim=-1, keepdim=True)
    if x_sqn is None:
        x_sqn = squared_norms(x)
    cross = qf @ x.float().T
    return torch.clamp(q_sqn - 2.0 * cross + x_sqn[None, :], min=0.0)


def sql2(q, x) -> torch.Tensor:
    """Squared L2 between broadcastable ``q (..., d)`` and ``x (..., d)``."""
    diff = q.float() - x.float()
    return torch.sum(diff * diff, dim=-1)


def masked_topk(dists, valid, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest among ``valid`` entries; invalid ones read
    MASK_DISTANCE.  Returns ``(dists (..., k), indices (..., k))``."""
    masked = torch.where(valid, dists, MASK_DISTANCE)
    return stable_topk(masked, k)
