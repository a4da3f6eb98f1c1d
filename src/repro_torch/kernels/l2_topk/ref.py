"""Plain-torch oracle for l2_topk: exact masked top-k smallest distances."""
from __future__ import annotations

import torch

from repro_torch.core.distance import stable_topk

BIG = 3.0e38


def l2_topk_ref(queries, centroids, valid, *, k: int):
    """``(dists (Q, k), idx (Q, k))`` — lowest index first among ties."""
    q = queries.float()
    c = centroids.float()
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    csq = torch.sum(c * c, dim=1)
    d = torch.clamp(qsq - 2.0 * (q @ c.T) + csq[None, :], min=0.0)
    d = torch.where(valid[None, :], d, BIG)
    return stable_topk(d, k)
