"""Plain-torch oracles for the posting_scan kernels (direct diff²)."""
from __future__ import annotations

import torch

from repro_torch.core.distance import stable_topk


def scan_posting_blocks_ref(block_table, queries, blocks):
    """(Q, NB, BS) distances — per-query page scan."""
    gathered = blocks[block_table.long()].float()      # (Q, NB, BS, d)
    q = queries.float()[:, None, None, :]
    diff = gathered - q
    return torch.sum(diff * diff, dim=-1)


def scan_unique_blocks_ref(unique_blocks, queries, blocks):
    """(NB, Q, BS) distances — batched unique-page scan."""
    gathered = blocks[unique_blocks.long()].float()    # (NB, BS, d)
    q = queries.float()
    diff = gathered[:, None, :, :] - q[None, :, None, :]
    return torch.sum(diff * diff, dim=-1)


def _kmin_ref(d, k: int):
    """Row-wise k smallest with index-order tie-break."""
    vals, idx = stable_topk(d, k)
    return vals, idx.to(torch.int32)


def scan_per_query_topk_ref(block_table, queries, blocks, slot_bias, k: int):
    """(Q, NB, k) per-page k-min candidates — per-query schedule."""
    d = scan_posting_blocks_ref(block_table, queries, blocks) + slot_bias
    return _kmin_ref(d, k)


def scan_batched_topk_ref(unique_blocks, queries, blocks, slot_bias, k: int):
    """(NB, Q, k) per-(page, query) k-min candidates — batched schedule."""
    d = scan_unique_blocks_ref(unique_blocks, queries, blocks)
    return _kmin_ref(d + slot_bias[:, None, :], k)


def _dequant(codes, page_sz):
    """``codes (..., BS, d)`` under per-page ``page_sz (..., 2)`` → f32."""
    scale = page_sz[..., 0][..., None, None]
    zero = page_sz[..., 1][..., None, None]
    return codes.float() * scale + zero


def scan_per_query_topk_q8_ref(block_table, queries, blocks, slot_bias, page_sz, k: int):
    """Dequant-fused per-query oracle: reconstruct ``code*scale+zero`` per
    page ((Q, NB, 2) params) before the distance math."""
    g = _dequant(blocks[block_table.long()], page_sz)    # (Q, NB, BS, d)
    diff = g - queries.float()[:, None, None, :]
    return _kmin_ref(torch.sum(diff * diff, dim=-1) + slot_bias, k)


def scan_batched_topk_q8_ref(unique_blocks, queries, blocks, slot_bias, page_sz, k: int):
    """Dequant-fused batched oracle ((NB, 2) per-unique-page params)."""
    g = _dequant(blocks[unique_blocks.long()], page_sz)  # (NB, BS, d)
    diff = g[:, None, :, :] - queries.float()[None, :, None, :]
    d = torch.sum(diff * diff, dim=-1) + slot_bias[:, None, :]
    return _kmin_ref(d, k)


def gather_pairs(d, i, member_pos):
    """Full ``(NB, Q, k)`` candidates gathered through the dedup's
    ``member_pos (Q, nbq)`` → ``(Q, nbq, k)``, ``(BIG, -1)`` where it is -1."""
    mp = member_pos.long()
    safe = torch.clamp(mp, min=0)
    qi = torch.arange(mp.shape[0], device=mp.device)[:, None]
    hit = (mp >= 0)[:, :, None]
    return (torch.where(hit, d[safe, qi], 3.0e38),
            torch.where(hit, i[safe, qi], -1).to(torch.int32))


def scan_batched_topk_pairs_ref(unique_blocks, queries, blocks, slot_bias, member_pos, k: int):
    """(Q, nbq, k) candidates of each query's own probed pages — the
    batched oracle gathered back through ``member_pos``."""
    return gather_pairs(*scan_batched_topk_ref(unique_blocks, queries, blocks, slot_bias, k),
                         member_pos)


def scan_batched_topk_q8_pairs_ref(unique_blocks, queries, blocks, slot_bias, page_sz,
                                   member_pos, k: int):
    """:func:`scan_batched_topk_pairs_ref` over int8 codes."""
    return gather_pairs(*scan_batched_topk_q8_ref(unique_blocks, queries, blocks, slot_bias,
                                                   page_sz, k), member_pos)
