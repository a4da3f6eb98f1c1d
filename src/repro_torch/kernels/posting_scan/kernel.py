"""Paged posting scan with a fused per-page k-min: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces the TPU kernels ``scan_per_query_topk`` and ``scan_batched_topk``
(``repro/kernels/posting_scan/kernel.py``); the kernels themselves are in
``kernels/csrc/posting_scan.cu``.  For tensors on the CPU a wrapper runs
the plain version; for CUDA tensors it launches the kernel or raises.

Contract: ``BS <= 32`` (one lane per slot), ``k <= BS``, ``d % 4 == 0``;
the payload is float32, bfloat16 or int8.  Block ids must lie in
``[0, B)``; the callers clamp absent pages to 0 and mask them by bias.
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import stable_topk

BIG = 3.0e38

# Launches of each CUDA kernel since the counts were last reset.
LAUNCHES = {"scan_per_query_topk": 0, "scan_batched_topk": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _expand_dist(q, pages):
    """``max(||q||^2 - 2 q.b + ||b||^2, 0)`` — the kernels' arithmetic.
    ``q (..., d)`` against ``pages (..., BS, d)`` → ``(..., BS)``."""
    qf = q.float()
    b = pages.float()
    qsq = torch.sum(qf * qf, dim=-1, keepdim=True)
    bsq = torch.sum(b * b, dim=-1)
    cross = torch.matmul(b, qf.unsqueeze(-1)).squeeze(-1)
    return torch.clamp(qsq - 2.0 * cross + bsq, min=0.0)


def scan_per_query_topk_plain(block_table, queries, blocks, slot_bias, *, k: int):
    """Page ``table[q, j]`` against query ``q`` plus the slot bias, then the
    k smallest slots: ``(dists (Q, NB, k), slots (Q, NB, k) i32)``."""
    pages = blocks[block_table.long()]                  # (Q, NB, BS, d)
    d = _expand_dist(queries[:, None, :], pages) + slot_bias
    vals, idx = stable_topk(d, k)
    return vals, idx.to(torch.int32)


def scan_batched_topk_plain(unique_blocks, queries, blocks, slot_bias, *, k: int):
    """Each page ``ids[i]`` against every query plus the slot bias, then the
    k smallest slots: ``(dists (NB, Q, k), slots (NB, Q, k) i32)``."""
    pages = blocks[unique_blocks.long()].float()        # (NB, BS, d)
    qf = queries.float()
    qsq = torch.sum(qf * qf, dim=-1)                    # (Q,)
    bsq = torch.sum(pages * pages, dim=-1)              # (NB, BS)
    cross = torch.matmul(qf[None, :, :], pages.transpose(1, 2))  # (NB, Q, BS)
    d = torch.clamp(qsq[None, :, None] - 2.0 * cross + bsq[:, None, :], min=0.0)
    d = d + slot_bias[:, None, :]
    vals, idx = stable_topk(d, k)
    return vals, idx.to(torch.int32)


def _check(ids, queries, blocks, slot_bias, k):
    _, bs, dim = blocks.shape
    if not 1 <= bs <= 32 or not 1 <= k <= bs:
        raise ValueError(f"kernel contract: BS <= 32 and k <= BS (BS={bs}, k={k})")
    if dim % 4:
        raise ValueError(f"kernel contract: d % 4 == 0 (d={dim})")
    if queries.shape[-1] != dim:
        raise ValueError("queries and blocks disagree on d")
    if blocks.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported payload dtype {blocks.dtype}")
    if ids.dtype != torch.int32 or slot_bias.dtype != torch.float32:
        raise ValueError("block ids must be int32 and the bias float32")
    for name, x in (("ids", ids), ("queries", queries), ("blocks", blocks),
                    ("slot_bias", slot_bias)):
        if x.device != blocks.device:
            raise ValueError(f"{name} is on {x.device}, blocks on {blocks.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blocks.device.type == "cuda" and blocks.data_ptr() % 16:
        raise ValueError("the block pool must be 16-byte aligned")


def _launch(fn_name, ids, queries, blocks, slot_bias, k, out_shape, n_a, n_b):
    from repro_torch.kernels.build import check, library

    out_d = torch.empty(out_shape, dtype=torch.float32, device=blocks.device)
    out_i = torch.empty(out_shape, dtype=torch.int32, device=blocks.device)
    _, bs, dim = blocks.shape
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    rc = getattr(library("posting_scan"), fn_name)(
        ids.data_ptr(), queries.data_ptr(), blocks.data_ptr(),
        _DTYPE_CODE[blocks.dtype], slot_bias.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), n_a, n_b, bs, dim, k, stream,
    )
    check(rc, fn_name)
    LAUNCHES[fn_name] += 1
    return out_d, out_i


def _device_of(blocks):
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blocks.device}")
    return blocks.device.type


def scan_per_query_topk(block_table, queries, blocks, slot_bias, *, k: int):
    """Per-query paged scan with fused per-page k-min.

    ``block_table (Q, NB)`` i32 (clamped >= 0), ``queries (Q, d)``,
    ``blocks (B, BS, d)``, ``slot_bias (Q, NB, BS)`` f32 (0 live, +BIG
    dead) → ``(dists (Q, NB, k), slots (Q, NB, k))``."""
    queries = queries.float().contiguous()
    _check(block_table, queries, blocks, slot_bias, k)
    q_n, nb = block_table.shape
    if slot_bias.shape != (q_n, nb, blocks.shape[1]):
        raise ValueError(f"slot_bias shape {tuple(slot_bias.shape)}")
    if _device_of(blocks) == "cpu":
        return scan_per_query_topk_plain(block_table, queries, blocks, slot_bias, k=k)
    return _launch("scan_per_query_topk", block_table, queries, blocks,
                   slot_bias, k, (q_n, nb, k), q_n, nb)


def scan_batched_topk(unique_blocks, queries, blocks, slot_bias, *, k: int):
    """Batch-dedup paged scan with fused per-(page, query) k-min.

    ``unique_blocks (NB,)`` i32 (>= 0), ``slot_bias (NB, BS)`` →
    ``(dists (NB, Q, k), slots (NB, Q, k))``."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, blocks, slot_bias, k)
    nb = unique_blocks.shape[0]
    q_n = queries.shape[0]
    if slot_bias.shape != (nb, blocks.shape[1]):
        raise ValueError(f"slot_bias shape {tuple(slot_bias.shape)}")
    if _device_of(blocks) == "cpu":
        return scan_batched_topk_plain(unique_blocks, queries, blocks, slot_bias, k=k)
    return _launch("scan_batched_topk", unique_blocks, queries, blocks,
                   slot_bias, k, (nb, q_n, k), nb, q_n)
