"""Public wrappers of the posting-scan kernels and the batch page dedup.

They tie the block pool to the kernels: clamp absent pages to page 0 and
mask their slots (and dead slots) with a +BIG distance bias.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.posting_scan import kernel as K

BIG = K.BIG


def scan_posting_blocks_topk(queries, page_table, slot_live, blocks, *, k: int):
    """Per-query paged scan with fused per-page k-min.

    ``page_table (Q, NB)`` i32 block ids (-1 absent), ``slot_live (Q, NB,
    BS)`` bool → ``(dists (Q, NB, k), slots (Q, NB, k))``; dead candidates
    carry dist >= BIG."""
    bias = torch.where(slot_live & (page_table >= 0)[:, :, None], 0.0, BIG)
    return K.scan_per_query_topk(
        torch.clamp(page_table, min=0).to(torch.int32).contiguous(),
        queries, blocks, bias.float().contiguous(), k=k,
    )


def scan_unique_blocks_topk(queries, unique_blocks, slot_live, blocks, *, k: int):
    """Batch-dedup paged scan with fused per-(page, query) k-min.

    ``unique_blocks (NB,)`` i32 (-1 padding), ``slot_live (NB, BS)`` →
    ``(dists (NB, Q, k), slots (NB, Q, k))``."""
    bias = torch.where(slot_live & (unique_blocks >= 0)[:, None], 0.0, BIG)
    return K.scan_batched_topk(
        torch.clamp(unique_blocks, min=0).to(torch.int32).contiguous(),
        queries, blocks, bias.float().contiguous(), k=k,
    )


def dedup_pages(pages, *, budget: int, num_blocks: int):
    """Fixed-shape batch page dedup (the batched schedule's compaction).

    Returns ``(unique (budget,), member_pos (N,), n_unique (), overflow ())``:
    ``unique`` holds the sorted distinct valid page ids, -1-padded; past
    ``budget`` distinct pages the highest-numbered ones are dropped.
    ``member_pos`` is, per input probe, the row of ``unique`` holding its
    page (-1 where the probe is invalid or its page was dropped)."""
    dev = pages.device
    sentinel = num_blocks                               # > every real page id
    flat = torch.where(pages >= 0, pages, sentinel).to(torch.int32)
    srt = torch.sort(flat).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    first = first & (srt < sentinel)
    n_unique = first.sum().to(torch.int32)
    pos = torch.nonzero(first).squeeze(1)[:budget]
    pos = torch.cat([pos, torch.zeros(budget - pos.numel(), dtype=pos.dtype, device=dev)])
    kept = torch.clamp(n_unique, max=budget)
    uniq = torch.where(torch.arange(budget, device=dev) < kept, srt[pos], sentinel)
    overflow = torch.clamp(n_unique - kept, min=0)
    member = torch.searchsorted(uniq, flat).clamp(max=budget - 1)
    hit = (uniq[member] == flat) & (pages >= 0)
    member_pos = torch.where(hit, member, -1).to(torch.int32)
    return (
        torch.where(uniq < sentinel, uniq, -1).to(torch.int32),
        member_pos, n_unique, overflow,
    )
