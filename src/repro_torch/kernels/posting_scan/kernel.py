"""Paged posting scan: the CUDA kernels' wrappers and their plain
PyTorch versions.

Replaces the six TPU kernels of ``repro/kernels/posting_scan/kernel.py``:
``scan_per_query`` and ``scan_batched`` (every slot's distance),
``scan_per_query_topk`` and ``scan_batched_topk`` (a fused per-page
k-min), and their int8-code forms ``scan_per_query_topk_q8`` and
``scan_batched_topk_q8`` (each page dequantised as ``code * scale +
zero`` with its posting's parameters).  The three batched forms,
``scan_batched``, ``scan_batched_topk`` and ``scan_batched_topk_q8``, are
one tensor-core kernel in ``kernels/csrc/scan_batched_topk.cu`` (library
``scan_batched_topk``); the three per-query forms share one kernel in
``kernels/csrc/posting_scan.cu`` that stages each live page in shared
memory and skips pairs whose every slot is dead.  For tensors on the CPU
a wrapper runs the plain version; for CUDA tensors it launches the kernel
or raises.

``scan_batched_topk_pairs`` and ``scan_batched_topk_q8_pairs`` are the
same two batched k-mins stored only where a query probed a page: given
the inverse of the page dedup, ``page_pos (NB, Q)`` int16 (the row of
query ``q``'s probe list that holds page ``i``, -1 none), they return
``(Q, nbq, k)`` candidates in the probe lists' order, ``(BIG, -1)`` where
no page was probed.  The kernel is the same (its pairs form), and so are
the products; only the select and the stores shrink.

Contract: ``BS <= 32`` (one lane per slot), ``k <= BS``, ``d % 4 == 0``;
the payload is float32, bfloat16 or int8 (int8 codes for the ``_q8``
forms); a per-query kernel refuses a page larger than a block's shared
memory (float32 at ``BS = 32``: ``d`` above about 1,750).  Block ids must
lie in ``[0, B)``; the callers clamp absent pages to 0 and mask them by
bias, except for ``scan_batched``, which takes -1 for a padding page and
writes its rows as ``BIG`` itself.

For ``meta`` tensors (the dry run) a wrapper launches nothing: it returns
its outputs' shapes and counts the kernel's work (``kernels/work.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import stable_topk
from repro_torch.kernels import work

BIG = 3.0e38

# Launches of each CUDA kernel since the counts were last reset.
LAUNCHES = {
    "scan_per_query": 0, "scan_batched": 0,
    "scan_per_query_topk": 0, "scan_batched_topk": 0,
    "scan_per_query_topk_q8": 0, "scan_batched_topk_q8": 0,
    "scan_batched_topk_pairs": 0, "scan_batched_topk_q8_pairs": 0,
}

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


def _dequant(codes, page_sz):
    """int8 ``codes (..., BS, d)`` under ``page_sz (..., 2)`` → f32 pages:
    ``code * scale``, rounded, ``+ zero``, rounded (two ops, no FMA)."""
    scale = page_sz[..., 0][..., None, None]
    zero = page_sz[..., 1][..., None, None]
    return codes.float() * scale + zero


def _kmin(d, k: int):
    vals, idx = stable_topk(d, k)
    return vals, idx.to(torch.int32)


def scan_per_query_plain(block_table, queries, blocks):
    """Page ``table[q, j]`` against query ``q``: ``(Q, NB, BS)``."""
    return _expand_dist(queries[:, None, :], blocks[block_table.long()])


def _batched_dist(queries, pages):
    """Every page ``(NB, BS, d)`` f32 against every query → ``(NB, Q, BS)``."""
    qf = queries.float()
    qsq = torch.sum(qf * qf, dim=-1)                    # (Q,)
    bsq = torch.sum(pages * pages, dim=-1)              # (NB, BS)
    cross = torch.matmul(qf[None, :, :], pages.transpose(1, 2))  # (NB, Q, BS)
    return torch.clamp(qsq[None, :, None] - 2.0 * cross + bsq[:, None, :], min=0.0)


def scan_batched_plain(unique_blocks, queries, blocks):
    """Each page ``ids[i]`` against every query: ``(NB, Q, BS)``; the rows
    of a padding page (``ids[i] = -1``) are ``BIG``."""
    pad = unique_blocks < 0
    d = _batched_dist(queries, blocks[torch.clamp(unique_blocks, min=0).long()].float())
    return torch.where(pad[:, None, None], BIG, d)


def scan_per_query_topk_plain(block_table, queries, blocks, slot_bias, *, k: int):
    """Page ``table[q, j]`` against query ``q`` plus the slot bias, then the
    k smallest slots: ``(dists (Q, NB, k), slots (Q, NB, k) i32)``."""
    return _kmin(scan_per_query_plain(block_table, queries, blocks) + slot_bias, k)


def scan_batched_topk_plain(unique_blocks, queries, blocks, slot_bias, *, k: int):
    """Each page ``ids[i]`` against every query plus the slot bias, then the
    k smallest slots: ``(dists (NB, Q, k), slots (NB, Q, k) i32)``."""
    d = scan_batched_plain(unique_blocks, queries, blocks)
    return _kmin(d + slot_bias[:, None, :], k)


def scan_per_query_topk_q8_plain(block_table, queries, codes, slot_bias, page_sz, *, k: int):
    """:func:`scan_per_query_topk_plain` over int8 codes, each page
    dequantised with its ``page_sz[q, j] = (scale, zero)``."""
    pages = _dequant(codes[block_table.long()], page_sz)   # (Q, NB, BS, d)
    return _kmin(_expand_dist(queries[:, None, :], pages) + slot_bias, k)


def scan_batched_topk_q8_plain(unique_blocks, queries, codes, slot_bias, page_sz, *, k: int):
    """:func:`scan_batched_topk_plain` over int8 codes, each unique page
    dequantised with its ``page_sz[i] = (scale, zero)``."""
    pages = _dequant(codes[unique_blocks.long()], page_sz)  # (NB, BS, d)
    return _kmin(_batched_dist(queries, pages) + slot_bias[:, None, :], k)


def _to_pairs(d, i, page_pos, nbq: int):
    """Full ``(NB, Q, k)`` candidates → ``(Q, nbq, k)`` at the probed pairs
    of ``page_pos (NB, Q)``, ``(BIG, -1)`` elsewhere."""
    _, q_n, k = d.shape
    out_d = torch.full((q_n, nbq, k), BIG, dtype=torch.float32, device=d.device)
    out_i = torch.full((q_n, nbq, k), -1, dtype=torch.int32, device=d.device)
    page, qi = torch.nonzero(page_pos >= 0, as_tuple=True)
    row = page_pos[page, qi].long()
    out_d[qi, row] = d[page, qi]
    out_i[qi, row] = i[page, qi]
    return out_d, out_i


def scan_batched_topk_pairs_plain(unique_blocks, queries, blocks, slot_bias, page_pos, *,
                                  nbq: int, k: int):
    """:func:`scan_batched_topk_plain` at the probed pairs only:
    ``(dists (Q, nbq, k), slots (Q, nbq, k))``."""
    return _to_pairs(*scan_batched_topk_plain(unique_blocks, queries, blocks, slot_bias, k=k),
                     page_pos, nbq)


def scan_batched_topk_q8_pairs_plain(unique_blocks, queries, codes, slot_bias, page_sz,
                                     page_pos, *, nbq: int, k: int):
    """:func:`scan_batched_topk_q8_plain` at the probed pairs only."""
    return _to_pairs(*scan_batched_topk_q8_plain(unique_blocks, queries, codes, slot_bias,
                                                 page_sz, k=k), page_pos, nbq)


def _check(ids, queries, blocks, k: int = 1, *, q8: bool = False, **f32):
    """The kernels' contract; ``f32`` names the float32 side inputs."""
    _, bs, dim = blocks.shape
    if not 1 <= bs <= 32 or not 1 <= k <= bs:
        raise ValueError(f"kernel contract: BS <= 32 and k <= BS (BS={bs}, k={k})")
    if dim % 4:
        raise ValueError(f"kernel contract: d % 4 == 0 (d={dim})")
    if queries.shape[-1] != dim:
        raise ValueError("queries and blocks disagree on d")
    if blocks.dtype not in _DTYPE_CODE or (q8 and blocks.dtype != torch.int8):
        raise ValueError(f"unsupported payload dtype {blocks.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError("block ids must be int32")
    for name, x in f32.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    for name, x in (("ids", ids), ("queries", queries), ("blocks", blocks), *f32.items()):
        if x.device != blocks.device:
            raise ValueError(f"{name} is on {x.device}, blocks on {blocks.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blocks.device.type == "cuda" and blocks.data_ptr() % 16:
        raise ValueError("the block pool must be 16-byte aligned")


def _on_cpu(blocks) -> bool:
    if blocks.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {blocks.device}")
    return blocks.device.type == "cpu"


def _launch(fn_name, blocks, *args, cost, lib="posting_scan", name=None):
    """Call the C entry ``fn_name`` of library ``lib`` (tensors by pointer)
    on the current stream, raise on its CUDA error code, count the launch
    under ``name`` (default ``fn_name``).  On ``meta`` add ``cost``
    (``(flops, bytes)``) to the open work counts instead."""
    name = name or fn_name
    if blocks.device.type == "meta":
        work.add(name, *cost)
        return
    from repro_torch.kernels.build import check, library

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    check(getattr(library(lib), fn_name)(*ptrs, stream), name)
    LAUNCHES[name] += 1


def _outputs(shape, blocks, with_idx=True):
    out_d = torch.empty(shape, dtype=torch.float32, device=blocks.device)
    if not with_idx:
        return out_d
    return out_d, torch.empty(shape, dtype=torch.int32, device=blocks.device)


def _check_shape(x, want, name):
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{name} shape {tuple(x.shape)}, want {tuple(want)}")


def _check_pairs(page_pos, nb, q_n, nbq, blocks):
    """The pairs form's contract: ``page_pos (NB, Q)`` int16, contiguous,
    beside the pool; ``1 <= nbq <= 32767`` (its rows are int16)."""
    _check_shape(page_pos, (nb, q_n), "page_pos")
    if page_pos.dtype != torch.int16 or not page_pos.is_contiguous():
        raise ValueError("page_pos must be contiguous int16")
    if page_pos.device != blocks.device:
        raise ValueError(f"page_pos is on {page_pos.device}, blocks on {blocks.device}")
    if not 1 <= nbq <= 32767:
        raise ValueError(f"pairs form: 1 <= nbq <= 32767 (nbq={nbq})")


def _pairs_outputs(q_n, nbq, k, blocks):
    """The pairs form's outputs, filled with ``(BIG, -1)``: the kernel
    writes the probed pairs only."""
    return (torch.full((q_n, nbq, k), BIG, dtype=torch.float32, device=blocks.device),
            torch.full((q_n, nbq, k), -1, dtype=torch.int32, device=blocks.device))


def scan_per_query(block_table, queries, blocks):
    """Per-query paged scan, every slot: ``block_table (Q, NB)`` i32
    (clamped >= 0), ``queries (Q, d)``, ``blocks (B, BS, d)`` → ``(Q, NB,
    BS)`` f32 distances."""
    queries = queries.float().contiguous()
    _check(block_table, queries, blocks)
    if _on_cpu(blocks):
        return scan_per_query_plain(block_table, queries, blocks)
    q_n, nb = block_table.shape
    _, bs, dim = blocks.shape
    out_d = _outputs((q_n, nb, bs), blocks, with_idx=False)
    _launch("scan_per_query", blocks, block_table, queries, blocks,
            _DTYPE_CODE[blocks.dtype], out_d, q_n, nb, bs, dim,
            cost=work.scan_per_query(q_n, nb, bs, dim, blocks.element_size()))
    return out_d


def scan_batched(unique_blocks, queries, blocks):
    """Batch-dedup paged scan, every slot: ``unique_blocks (NB,)`` i32
    (-1 padding) → ``(NB, Q, BS)`` f32 distances, padding rows ``BIG``."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, blocks)
    if _on_cpu(blocks):
        return scan_batched_plain(unique_blocks, queries, blocks)
    nb, q_n = unique_blocks.shape[0], queries.shape[0]
    _, bs, dim = blocks.shape
    out_d = _outputs((nb, q_n, bs), blocks, with_idx=False)
    _launch("scan_batched", blocks, unique_blocks, queries, blocks,
            _DTYPE_CODE[blocks.dtype], out_d, nb, q_n, bs, dim, lib="scan_batched_topk",
            cost=work.scan_batched(nb, q_n, bs, dim, blocks.element_size()))
    return out_d


def scan_per_query_topk(block_table, queries, blocks, slot_bias, *, k: int):
    """Per-query paged scan with fused per-page k-min.

    ``block_table (Q, NB)`` i32 (clamped >= 0), ``queries (Q, d)``,
    ``blocks (B, BS, d)``, ``slot_bias (Q, NB, BS)`` f32 (0 live, +BIG
    dead) → ``(dists (Q, NB, k), slots (Q, NB, k))``."""
    queries = queries.float().contiguous()
    _check(block_table, queries, blocks, k, slot_bias=slot_bias)
    q_n, nb = block_table.shape
    _, bs, dim = blocks.shape
    _check_shape(slot_bias, (q_n, nb, bs), "slot_bias")
    if _on_cpu(blocks):
        return scan_per_query_topk_plain(block_table, queries, blocks, slot_bias, k=k)
    out_d, out_i = _outputs((q_n, nb, k), blocks)
    _launch("scan_per_query_topk", blocks, block_table, queries, blocks,
            _DTYPE_CODE[blocks.dtype], slot_bias, out_d, out_i, q_n, nb, bs, dim, k,
            cost=work.scan_per_query(q_n, nb, bs, dim, blocks.element_size(), k=k))
    return out_d, out_i


def scan_batched_topk(unique_blocks, queries, blocks, slot_bias, *, k: int):
    """Batch-dedup paged scan with fused per-(page, query) k-min.

    ``unique_blocks (NB,)`` i32 (>= 0), ``slot_bias (NB, BS)`` →
    ``(dists (NB, Q, k), slots (NB, Q, k))``."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, blocks, k, slot_bias=slot_bias)
    nb, q_n = unique_blocks.shape[0], queries.shape[0]
    _, bs, dim = blocks.shape
    _check_shape(slot_bias, (nb, bs), "slot_bias")
    if _on_cpu(blocks):
        return scan_batched_topk_plain(unique_blocks, queries, blocks, slot_bias, k=k)
    out_d, out_i = _outputs((nb, q_n, k), blocks)
    _launch("scan_batched_topk", blocks, unique_blocks, queries, blocks,
            _DTYPE_CODE[blocks.dtype], slot_bias, out_d, out_i, nb, q_n, bs, dim, k, None, 0,
            lib="scan_batched_topk", cost=work.scan_batched(nb, q_n, bs, dim,
                                                            blocks.element_size(), k=k))
    return out_d, out_i


def scan_batched_topk_pairs(unique_blocks, queries, blocks, slot_bias, page_pos, *,
                            nbq: int, k: int):
    """:func:`scan_batched_topk` selected and stored only at the probed
    (page, query) pairs: ``page_pos (NB, Q)`` int16, the row of query
    ``q``'s ``nbq`` probed pages that holds page ``i`` (-1 none; a page at
    most once a row) → ``(dists (Q, nbq, k), slots (Q, nbq, k))``, ``(BIG,
    -1)`` at rows no page fills.  Every page is still scored against every
    query."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, blocks, k, slot_bias=slot_bias)
    nb, q_n = unique_blocks.shape[0], queries.shape[0]
    _, bs, dim = blocks.shape
    _check_shape(slot_bias, (nb, bs), "slot_bias")
    _check_pairs(page_pos, nb, q_n, nbq, blocks)
    if _on_cpu(blocks):
        return scan_batched_topk_pairs_plain(unique_blocks, queries, blocks, slot_bias,
                                             page_pos, nbq=nbq, k=k)
    out_d, out_i = _pairs_outputs(q_n, nbq, k, blocks)
    _launch("scan_batched_topk", blocks, unique_blocks, queries, blocks,
            _DTYPE_CODE[blocks.dtype], slot_bias, out_d, out_i, nb, q_n, bs, dim, k, page_pos,
            nbq, lib="scan_batched_topk", name="scan_batched_topk_pairs",
            cost=work.scan_batched(nb, q_n, bs, dim, blocks.element_size(), k=k,
                                   pairs=q_n * nbq))
    return out_d, out_i


def scan_per_query_topk_q8(block_table, queries, codes, slot_bias, page_sz, *, k: int):
    """:func:`scan_per_query_topk` over int8 ``codes``, each page
    dequantised with ``page_sz (Q, NB, 2)`` f32 ``(scale, zero)`` (the
    kernel applies them to its exact integer sums over the codes)."""
    queries = queries.float().contiguous()
    _check(block_table, queries, codes, k, q8=True, slot_bias=slot_bias, page_sz=page_sz)
    q_n, nb = block_table.shape
    _, bs, dim = codes.shape
    _check_shape(slot_bias, (q_n, nb, bs), "slot_bias")
    _check_shape(page_sz, (q_n, nb, 2), "page_sz")
    if _on_cpu(codes):
        return scan_per_query_topk_q8_plain(block_table, queries, codes, slot_bias, page_sz, k=k)
    out_d, out_i = _outputs((q_n, nb, k), codes)
    _launch("scan_per_query_topk_q8", codes, block_table, queries, codes, slot_bias,
            page_sz, out_d, out_i, q_n, nb, bs, dim, k,
            cost=work.scan_per_query(q_n, nb, bs, dim, 1, k=k, q8=True))
    return out_d, out_i


def scan_batched_topk_q8(unique_blocks, queries, codes, slot_bias, page_sz, *, k: int):
    """:func:`scan_batched_topk` over int8 ``codes``, each unique page
    dequantised in the kernel with ``page_sz (NB, 2)`` f32 ``(scale,
    zero)``."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, codes, k, q8=True, slot_bias=slot_bias, page_sz=page_sz)
    nb, q_n = unique_blocks.shape[0], queries.shape[0]
    _, bs, dim = codes.shape
    _check_shape(slot_bias, (nb, bs), "slot_bias")
    _check_shape(page_sz, (nb, 2), "page_sz")
    if _on_cpu(codes):
        return scan_batched_topk_q8_plain(unique_blocks, queries, codes, slot_bias, page_sz, k=k)
    out_d, out_i = _outputs((nb, q_n, k), codes)
    _launch("scan_batched_topk_q8", codes, unique_blocks, queries, codes, slot_bias,
            page_sz, out_d, out_i, nb, q_n, bs, dim, k, None, 0, lib="scan_batched_topk",
            cost=work.scan_batched(nb, q_n, bs, dim, 1, k=k, q8=True))
    return out_d, out_i


def scan_batched_topk_q8_pairs(unique_blocks, queries, codes, slot_bias, page_sz, page_pos, *,
                               nbq: int, k: int):
    """:func:`scan_batched_topk_q8` at the probed pairs only, as
    :func:`scan_batched_topk_pairs`."""
    queries = queries.float().contiguous()
    _check(unique_blocks, queries, codes, k, q8=True, slot_bias=slot_bias, page_sz=page_sz)
    nb, q_n = unique_blocks.shape[0], queries.shape[0]
    _, bs, dim = codes.shape
    _check_shape(slot_bias, (nb, bs), "slot_bias")
    _check_shape(page_sz, (nb, 2), "page_sz")
    _check_pairs(page_pos, nb, q_n, nbq, codes)
    if _on_cpu(codes):
        return scan_batched_topk_q8_pairs_plain(unique_blocks, queries, codes, slot_bias,
                                                page_sz, page_pos, nbq=nbq, k=k)
    out_d, out_i = _pairs_outputs(q_n, nbq, k, codes)
    _launch("scan_batched_topk_q8", codes, unique_blocks, queries, codes, slot_bias,
            page_sz, out_d, out_i, nb, q_n, bs, dim, k, page_pos, nbq, lib="scan_batched_topk",
            name="scan_batched_topk_q8_pairs",
            cost=work.scan_batched(nb, q_n, bs, dim, 1, k=k, q8=True, pairs=q_n * nbq))
    return out_d, out_i
