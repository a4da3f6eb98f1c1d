"""Public wrappers of the posting-scan kernels and the batch page dedup.

They tie the block pool to the kernels: build the block table from
posting ids, clamp absent pages to page 0, and mask their slots (and dead
slots) with a +BIG distance bias; ``scan_batched`` takes the -1 padding
ids as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.posting_scan import kernel as K

BIG = K.BIG


def _per_query_bias(page_table, slot_live):
    """0 for live slots of present pages, +BIG else: ``(Q, NB, BS)`` f32."""
    bias = torch.where(slot_live & (page_table >= 0)[:, :, None], 0.0, BIG)
    return bias.float().contiguous()


def _batched_bias(unique_blocks, slot_live):
    """0 for live slots of real pages, +BIG else: ``(NB, BS)`` f32."""
    bias = torch.where(slot_live & (unique_blocks >= 0)[:, None], 0.0, BIG)
    return bias.float().contiguous()


def _clamped(ids):
    return torch.clamp(ids, min=0).to(torch.int32).contiguous()


def scan_posting_blocks(queries, posting_blocks, pids, blocks):
    """Per-query paged scan over probed postings, every slot.

    ``posting_blocks (P_cap, MB)`` i32 block table rows, ``pids (Q,
    nprobe)`` (-1 none) → ``(dists (Q, nprobe*MB*BS), page_ok (Q,
    nprobe*MB*BS) bool)``; slots of absent pages read BIG.  The caller
    applies the vid/version masks and the top-k."""
    q_n = queries.shape[0]
    bs = blocks.shape[1]
    table = posting_blocks[torch.clamp(pids, min=0).long()]     # (Q, nprobe, MB)
    table = torch.where((pids >= 0)[..., None], table, -1)
    flat = table.reshape(q_n, -1)                               # (Q, NB)
    page_ok = flat >= 0
    d = K.scan_per_query(_clamped(flat), queries, blocks)      # (Q, NB, BS)
    d = torch.where(page_ok[:, :, None], d, BIG)
    return d.reshape(q_n, -1), torch.repeat_interleave(page_ok, bs, dim=1)


def scan_unique_blocks(queries, unique_blocks, blocks):
    """Batch-dedup scan, every slot: ``unique_blocks (NB,)`` i32 (-1
    padding) → ``dists (NB, Q, BS)``, padding pages BIG (written by the
    kernel: no masking pass over the output)."""
    return K.scan_batched(unique_blocks.to(torch.int32).contiguous(), queries, blocks)


def scan_posting_blocks_topk(queries, page_table, slot_live, blocks, *, k: int):
    """Per-query paged scan with fused per-page k-min.

    ``page_table (Q, NB)`` i32 block ids (-1 absent), ``slot_live (Q, NB,
    BS)`` bool → ``(dists (Q, NB, k), slots (Q, NB, k))``; dead candidates
    carry dist >= BIG."""
    return K.scan_per_query_topk(
        _clamped(page_table), queries, blocks, _per_query_bias(page_table, slot_live), k=k
    )


def scan_unique_blocks_topk(queries, unique_blocks, slot_live, blocks, *, k: int):
    """Batch-dedup paged scan with fused per-(page, query) k-min.

    ``unique_blocks (NB,)`` i32 (-1 padding), ``slot_live (NB, BS)`` →
    ``(dists (NB, Q, k), slots (NB, Q, k))``."""
    return K.scan_batched_topk(
        _clamped(unique_blocks), queries, blocks, _batched_bias(unique_blocks, slot_live), k=k
    )


def scan_unique_blocks_topk_pairs(queries, unique_blocks, slot_live, blocks, page_pos, *,
                                  nbq: int, k: int):
    """:func:`scan_unique_blocks_topk` selected and stored only where a
    query probed the page: ``page_pos (NB, Q)`` from :func:`page_positions`
    → ``(dists (Q, nbq, k), slots (Q, nbq, k))`` in each query's probe
    order, ``(BIG, -1)`` where its row holds no kept page."""
    return K.scan_batched_topk_pairs(
        _clamped(unique_blocks), queries, blocks, _batched_bias(unique_blocks, slot_live),
        page_pos, nbq=nbq, k=k,
    )


def _page_sz(page_scale, page_zero):
    return torch.stack([page_scale.float(), page_zero.float()], dim=-1).contiguous()


def scan_posting_blocks_topk_q8(queries, page_table, slot_live, codes,
                                page_scale, page_zero, *, k: int):
    """:func:`scan_posting_blocks_topk` over int8 codes; ``page_scale`` and
    ``page_zero (Q, NB)`` are each page's posting parameters, and the page
    is dequantised inside the kernel."""
    return K.scan_per_query_topk_q8(
        _clamped(page_table), queries, codes, _per_query_bias(page_table, slot_live),
        _page_sz(page_scale, page_zero), k=k,
    )


def scan_unique_blocks_topk_q8(queries, unique_blocks, slot_live, codes,
                               page_scale, page_zero, *, k: int):
    """:func:`scan_unique_blocks_topk` over int8 codes, with per-unique-page
    ``page_scale`` and ``page_zero (NB,)``."""
    return K.scan_batched_topk_q8(
        _clamped(unique_blocks), queries, codes, _batched_bias(unique_blocks, slot_live),
        _page_sz(page_scale, page_zero), k=k,
    )


def scan_unique_blocks_topk_q8_pairs(queries, unique_blocks, slot_live, codes, page_scale,
                                     page_zero, page_pos, *, nbq: int, k: int):
    """:func:`scan_unique_blocks_topk_q8` at the probed pairs only, as
    :func:`scan_unique_blocks_topk_pairs`."""
    return K.scan_batched_topk_q8_pairs(
        _clamped(unique_blocks), queries, codes, _batched_bias(unique_blocks, slot_live),
        _page_sz(page_scale, page_zero), page_pos, nbq=nbq, k=k,
    )


def page_positions(member_pos, budget: int):
    """The inverse of the dedup's ``member_pos (Q, nbq)``: ``(budget, Q)``
    int16, the row of query ``q``'s probe list that holds unique page
    ``u``, -1 where none does.  One fill and one scatter, no read back:
    a probe without a kept page (``member_pos`` -1) indexes row -1, a
    spare row past the budget, which is cut.  A page sits at most once in
    a query's row (a block belongs to one posting, and navigation returns
    distinct postings); on the CPU that is checked."""
    q_n, nbq = member_pos.shape
    if nbq > 32767:
        raise ValueError(f"page_positions: {nbq} probed pages a query, int16 holds 32767")
    dev = member_pos.device
    tgt = torch.add(torch.arange(q_n, dtype=member_pos.dtype, device=dev)[:, None], member_pos,
                    alpha=q_n)
    pos = torch.full(((budget + 1) * q_n,), -1, dtype=torch.int16, device=dev)
    pos[tgt] = torch.arange(nbq, dtype=torch.int16, device=dev).expand(q_n, nbq)
    if dev.type == "cpu":
        kept = tgt[member_pos >= 0]
        if kept.numel() and int(torch.bincount(kept).max()) > 1:
            raise ValueError("page_positions: a page twice in one query's probed pages")
    return pos[: budget * q_n].view(budget, q_n)


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
    # compaction by rank (no nonzero: its output size would need a
    # device → host read); ranks past the budget write the spare row
    rank = torch.cumsum(first, 0) - 1
    tgt = torch.where(first & (rank < budget), rank, budget)
    uniq = torch.full((budget + 1,), sentinel, dtype=torch.int32, device=dev)
    uniq = uniq.scatter_(0, tgt, srt)[:budget]
    kept = torch.clamp(n_unique, max=budget)
    overflow = torch.clamp(n_unique - kept, min=0)
    member = torch.searchsorted(uniq, flat).clamp(max=budget - 1)
    hit = (uniq[member] == flat) & (pages >= 0)
    member_pos = torch.where(hit, member, -1).to(torch.int32)
    return (
        torch.where(uniq < sentinel, uniq, -1).to(torch.int32),
        member_pos, n_unique, overflow,
    )
