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
