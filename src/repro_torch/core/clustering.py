"""Balanced clustering for the offline SPANN-style index build.

* :func:`balanced_kmeans` — fixed-iteration Lloyd with a size-penalty
  term over the ``valid`` rows.
* :func:`hierarchical_balanced_kmeans` — host-driven recursive splitter:
  split until every leaf fits ``max_posting_size``.

Randomness comes from an explicit ``torch.Generator``; it cannot give the
reference's ``jax.random`` bits, so a port build and a reference build of
the same data agree in recall, not bit for bit.  Every reduction here is
a fixed-order matmul or sum (no atomics), so a build is deterministic for
a given seed and device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distance import pairwise_sql2, stable_topk


def balanced_kmeans(x, valid, *, k: int, generator: torch.Generator,
                    iters: int = 10, balance_weight: float = 1.0):
    """Size-penalized Lloyd over the ``valid`` rows of ``x (n, d)``.

    Assignment cost for cluster c is ``sql2(x, c) + λ·(size_c/n)·mean‖x‖²``
    with the sizes of the previous iteration.  The initial centroids are k
    distinct valid rows (Gumbel top-k).  Returns ``(centroids (k, d) f32,
    assign (n,) i64)``; invalid rows get ``-1``."""
    n = x.shape[0]
    xf = x.float()
    validf = valid.float()
    n_valid = torch.clamp(validf.sum(), min=1.0)

    u = torch.rand((n,), generator=generator, device=x.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    scores = torch.where(valid, g, -torch.inf)
    _, init_idx = stable_topk(scores, k, largest=True)
    centroids = xf[init_idx]
    mean_sq = torch.sum(torch.sum(xf * xf, dim=-1) * validf) / n_valid

    def assign_step(centroids, sizes):
        penalty = balance_weight * (sizes / n_valid) * (mean_sq + 1e-6)
        cost = pairwise_sql2(xf, centroids) + penalty[None, :]
        a = torch.argmin(cost, dim=-1)      # first index among ties
        return torch.where(valid, a, -1)

    def update_centroids(assign, centroids):
        onehot = (assign[:, None] == torch.arange(k, device=x.device)).float()
        counts = onehot.sum(dim=0)
        new = (onehot.T @ xf) / torch.clamp(counts, min=1.0)[:, None]
        return torch.where((counts > 0)[:, None], new, centroids), counts

    sizes = torch.zeros((k,), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = assign_step(centroids, sizes)
        centroids, sizes = update_centroids(a, centroids)
    assign = assign_step(centroids, sizes)
    centroids, _ = update_centroids(assign, centroids)
    return centroids, assign


def hierarchical_balanced_kmeans(x, *, max_posting_size: int, branch: int = 8,
                                 iters: int = 10, balance_weight: float = 1.0,
                                 seed: int = 0, device="cuda"):
    """Recursively split until every leaf fits ``max_posting_size``.

    ``x`` is an ``(n, d)`` numpy array; the clustering runs on ``device``.
    Returns ``(centroids (P, d) f32, assign (n,) i32)`` as numpy arrays."""
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    n = xt.shape[0]
    assign = np.zeros((n,), np.int32)
    gen = torch.Generator(device=xt.device)
    gen.manual_seed(seed)
    leaves: list[np.ndarray] = []       # index arrays of finished postings
    stack: list[np.ndarray] = [np.arange(n, dtype=np.int64)]
    guard = 0
    while stack:
        guard += 1
        if guard > 16 * max(1, n // max(1, max_posting_size)) + 64:
            # Degenerate data (e.g. all-identical points): stop splitting.
            leaves.extend(stack)
            break
        idx = stack.pop()
        if idx.size <= max_posting_size:
            leaves.append(idx)
            continue
        k = min(branch, max(2, int(np.ceil(idx.size / max_posting_size))))
        sub = xt[torch.from_numpy(idx).to(xt.device)]
        valid = torch.ones((idx.size,), dtype=torch.bool, device=xt.device)
        _, a = balanced_kmeans(
            sub, valid, k=k, generator=gen, iters=iters,
            balance_weight=balance_weight,
        )
        a = a.cpu().numpy()
        children = [idx[a == c] for c in range(k)]
        children = [ch for ch in children if ch.size]
        if len(children) == 1:
            # k-means failed to split (identical points): force halve.
            half = idx.size // 2
            children = [idx[:half], idx[half:]]
        stack.extend(children)
    sizes = np.array([leaf.size for leaf in leaves], np.int64)
    for cid, leaf in enumerate(leaves):
        assign[leaf] = cid
    # leaf means: rows grouped leaf by leaf, one segmented sum
    xs = np.asarray(x, np.float32)
    order = np.concatenate(leaves) if leaves else np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    centroids = np.zeros((len(leaves), xs.shape[1]), np.float32)
    nz = sizes > 0
    if nz.any():
        sums = np.add.reduceat(xs[order], starts[nz], axis=0)
        centroids[nz] = sums / sizes[nz, None].astype(np.float32)
    return centroids, assign


def balanced_two_means(x, valid, *, init_scores, iters: int = 8):
    """LIRE split primitive: balanced 2-means over posting buffers, batched
    over a leading job dim.

    ``x (K, L, d)`` holds each job's (garbage-collected) posting, ``valid
    (K, L)`` its live rows.  ``init_scores (K, L)`` carries the random
    draw: the two valid rows with the highest scores (lowest index first
    among equal ones) seed the centroids, as the reference's Gumbel top-2
    does with its own draw.  Size-penalised Lloyd (balance weight 2) runs
    ``iters`` steps; then balance is enforced hard — a side larger than
    ``ceil(n_valid / 2)`` hands its smallest-margin rows to the other —
    and the centroids are refreshed from the final assignment.

    Returns ``(centroids (K, 2, d) f32, assign (K, L) in {-1, 0, 1})``.
    Every reduction is a matmul or a sum over a fixed axis: no atomics."""
    xf = x.float()
    k_jobs, n, _ = xf.shape
    validf = valid.float()
    n_valid = torch.clamp(validf.sum(dim=1), min=1.0)              # (K,)
    scores = torch.where(valid, init_scores.double(), -torch.inf)
    _, init_idx = stable_topk(scores, 2, largest=True)              # (K, 2)
    centroids = torch.gather(xf, 1, init_idx[..., None].expand(-1, -1, xf.shape[2]))
    x_sqn = torch.sum(xf * xf, dim=-1)                             # (K, L)
    mean_sq = torch.sum(x_sqn * validf, dim=1) / n_valid
    sides = torch.arange(2, device=x.device)

    def assign_step(centroids, sizes):
        c_sqn = torch.sum(centroids * centroids, dim=-1)            # (K, 2)
        cross = torch.bmm(xf, centroids.transpose(1, 2))            # (K, L, 2)
        dists = torch.clamp(x_sqn[..., None] - 2.0 * cross + c_sqn[:, None, :], min=0.0)
        penalty = 2.0 * (sizes / n_valid[:, None]) * (mean_sq[:, None] + 1e-6)
        a = torch.argmin(dists + penalty[:, None, :], dim=-1)        # first among ties
        return torch.where(valid, a, -1)

    def means(assign):
        onehot = (assign[..., None] == sides).float()               # (K, L, 2)
        counts = onehot.sum(dim=1)                                  # (K, 2)
        sums = torch.bmm(onehot.transpose(1, 2), xf)                # (K, 2, d)
        return sums / torch.clamp(counts, min=1.0)[..., None], counts

    sizes = torch.zeros((k_jobs, 2), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        new, sizes = means(assign_step(centroids, sizes))
        centroids = torch.where((sizes > 0)[..., None], new, centroids)
    new, counts = means(assign_step(centroids, sizes))
    centroids = torch.where((counts > 0)[..., None], new, centroids)

    # hard rebalance on the signed preference d0 - d1 (> 0 prefers side 1)
    d0 = torch.sum((xf - centroids[:, :1]) ** 2, dim=-1)
    d1 = torch.sum((xf - centroids[:, 1:]) ** 2, dim=-1)
    pref = d0 - d1
    a = torch.where(valid, (pref > 0).long(), -1)
    target = (valid.sum(dim=1) + 1) // 2                           # (K,)
    margin = pref.abs()
    for side in (1, 0):
        count = (a == side).sum(dim=1)
        cand = a == side
        order = torch.sort(torch.where(cand, margin, torch.inf), dim=1, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(n, device=x.device).expand(k_jobs, n))
        flip = cand & (rank < (count - target)[:, None]) & (count > target)[:, None]
        a = torch.where(flip, 1 - side, a)
    centroids, _ = means(a)
    return centroids, a
