"""Public wrapper of the l2_topk kernel: padding, masking, final merge."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distance import stable_topk
from repro_torch.kernels.l2_topk.kernel import BIG, l2_topk_tiles


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def l2_topk(queries, centroids, valid, *, k: int, block_p: int = 512):
    """Masked k-nearest centroids: ``(dists (Q, k), idx (Q, k))``.

    Two-stage tournament: per-tile k-min in the kernel, then one stable
    top-k over the T*k survivors (the global top-k is a subset of the
    union of per-tile top-k sets).  Invalid results read ``idx = -1``."""
    p_n = centroids.shape[0]
    block_p = min(block_p, _round_up(p_n, 128))
    pp = _round_up(p_n, block_p)
    k_tile = min(k, block_p)
    cen = centroids.float()
    cpad = F.pad(cen, (0, 0, 0, pp - p_n)).contiguous()
    csq = torch.sum(cen * cen, dim=1)
    csq = torch.where(valid, csq, BIG)
    csq = F.pad(csq, (0, pp - p_n), value=BIG)[None, :].contiguous()
    tile_d, tile_i = l2_topk_tiles(queries, cpad, csq, k=k_tile, block_p=block_p)
    dists, sel = stable_topk(tile_d, k)
    idx = torch.gather(tile_i, 1, sel)
    idx = torch.where(dists < BIG / 2, idx, -1)
    return torch.clamp(dists, min=0.0), idx
