"""Fused L2 distance + per-tile k-min: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``l2_topk_tiles`` (``repro/kernels/l2_topk/
kernel.py``).  The kernel itself is ``kernels/csrc/l2_topk.cu``.  For a
tensor on the CPU the wrapper runs :func:`l2_topk_tiles_plain`; for a
CUDA tensor it launches the kernel or raises; for a ``meta`` tensor (the
dry run) it returns the outputs' shapes and counts the kernel's work
(``kernels/work.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import work

BIG = 3.0e38

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"l2_topk_tiles": 0}


def l2_topk_tiles_plain(queries, centroids, c_sqn, *, k: int, block_p: int):
    """The kernel's arithmetic in plain PyTorch.

    ``d = ||q||^2 - 2 q.c + c_sqn`` per (query, centroid) (no clamp), then
    the ``k`` smallest of every ``block_p``-column tile with global
    indices, lowest index first among equal values.  Returns ``(dists
    (Q, T*k) f32, idx (Q, T*k) i32)``, T = P / block_p."""
    q = queries.float()
    c = centroids.float()
    q_n, p_n = q.shape[0], c.shape[0]
    t = p_n // block_p
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    d = qsq - 2.0 * (q @ c.T) + c_sqn.reshape(1, p_n)
    vals, idx = torch.sort(d.reshape(q_n, t, block_p), dim=-1, stable=True)
    base = torch.arange(t, device=q.device)[None, :, None] * block_p
    idx = idx[..., :k] + base
    return vals[..., :k].reshape(q_n, t * k), idx.reshape(q_n, t * k).to(torch.int32)


def _check(queries, centroids, c_sqn, k, block_p):
    q_n, dim = queries.shape
    p_n = centroids.shape[0]
    if centroids.shape != (p_n, dim) or c_sqn.numel() != p_n:
        raise ValueError("shape mismatch among queries, centroids and c_sqn")
    if p_n % block_p or block_p % 64 or block_p > 512 or not 1 <= k <= block_p:
        raise ValueError(f"unsupported tiling: P={p_n} block_p={block_p} k={k}")
    for name, x in (("queries", queries), ("centroids", centroids), ("c_sqn", c_sqn)):
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on {queries.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")


def l2_topk_tiles(queries, centroids, c_sqn, *, k: int, block_p: int = 512):
    """Per-tile candidates ``(dists (Q, T*k), idx (Q, T*k))``.

    ``queries (Q, d)``, ``centroids (P, d)`` and ``c_sqn (1, P)`` are f32;
    P is a multiple of ``block_p``, a multiple of 64 up to 512."""
    queries = queries.float().contiguous()
    _check(queries, centroids, c_sqn, k, block_p)
    if queries.device.type == "cpu":
        return l2_topk_tiles_plain(queries, centroids, c_sqn, k=k, block_p=block_p)
    if queries.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {queries.device}")
    q_n, dim = queries.shape
    p_n = centroids.shape[0]
    t = p_n // block_p
    out_d = torch.empty((q_n, t * k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((q_n, t * k), dtype=torch.int32, device=queries.device)
    if queries.device.type == "meta":
        work.add("l2_topk_tiles", *work.l2_topk_tiles(q_n, p_n, dim, k, block_p))
        return out_d, out_i
    from repro_torch.kernels.build import check, library

    lib = library("l2_topk")
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = lib.l2_topk_tiles_f32(
        queries.data_ptr(), centroids.data_ptr(), c_sqn.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), q_n, p_n, dim, k, block_p, stream,
    )
    check(rc, "l2_topk_tiles")
    LAUNCHES["l2_topk_tiles"] += 1
    return out_d, out_i
