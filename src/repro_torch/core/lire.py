"""LIRE protocol operations — paper §3 + §4.2: search, insert, delete.

Every op is a fixed-shape functional state transition, as in the
reference: branchy protocol logic is expressed with enable masks, and the
input state's tensors are not written.  The maintenance round (split,
merge, reassign) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distance import (
    MASK_DISTANCE,
    masked_topk,
    pairwise_sql2,
    stable_topk,
)
from repro_torch.core.types import IndexState, bump_stat
from repro_torch.kernels.posting_scan import ops as scan_ops
from repro_torch.storage import blockpool as bp
from repro_torch.storage import versionmap as vm


# ---------------------------------------------------------------------------
# Centroid navigation (the SPTAG replacement: dense GEMM + top-k)
# ---------------------------------------------------------------------------

def navigate(state: IndexState, queries, nprobe: int):
    """Nearest-``nprobe`` valid posting centroids for each query.

    Returns ``(dists (Q, nprobe), pids (Q, nprobe))``; invalid slots read
    MASK_DISTANCE.  With ``cfg.use_pallas_nav`` the hand-written
    ``l2_topk`` kernel runs; otherwise a matmul + stable top-k."""
    if state.cfg.use_pallas_nav:
        from repro_torch.kernels.l2_topk.ops import l2_topk

        d, idx = l2_topk(queries, state.centroids, state.centroid_valid, k=nprobe)
        return torch.where(idx >= 0, d, MASK_DISTANCE), idx
    d = pairwise_sql2(queries, state.centroids, state.centroid_sqn)
    d, idx = masked_topk(d, state.centroid_valid[None, :], nprobe)
    return d, idx.to(torch.int32)


def route(state: IndexState, vecs, r: int):
    """Insert routing: top-``r`` centroids + closure-replica mask
    (replicate into posting i iff ``d_i <= replica_rng^2 * d_min``).
    Returns ``(pids (B, r), dists (B, r), replica_ok (B, r))``."""
    dists, pids = navigate(state, vecs, r)
    dmin = dists[:, :1]
    factor = float(np.float32(state.cfg.replica_rng) ** 2)   # f32, as the reference
    replica_ok = (dists <= factor * dmin) & (dists < MASK_DISTANCE / 2)
    return pids, dists, replica_ok


# ---------------------------------------------------------------------------
# Per-posting telemetry
# ---------------------------------------------------------------------------

def _bump_append_telemetry(state: IndexState, pids, vecs, landed):
    """Every landed row bumps its posting's ``update_count`` and adds its
    displacement from the current centroid into ``drift_vec``.

    The float sum is deterministic: rows of one posting are added in row
    order, one rank at a time, and within a rank every target is distinct,
    so no two additions race."""
    tel = state.telemetry
    cap = state.cfg.num_postings_cap
    safe = torch.clamp(pids.long(), min=0)
    disp = vecs.float() - state.centroids[safe]
    rank = bp.group_rank(safe, cap, landed)
    update = tel.update_count.clone()
    update.index_add_(0, safe[landed], torch.ones_like(safe[landed], dtype=torch.int32))
    drift = tel.drift_vec.clone()
    n_rounds = int(rank[landed].max().item()) + 1 if bool(landed.any()) else 0
    for r in range(n_rounds):
        sel = landed & (rank == r)
        drift.index_add_(0, safe[sel], disp[sel])
    return tel.replace(update_count=update, drift_vec=drift)


def probe_histogram(cfg, pids, probe_valid):
    """Per-posting probe counts for one search micro-batch."""
    cap = cfg.num_postings_cap
    tgt = pids[probe_valid].long()
    hist = torch.zeros((cap,), dtype=torch.int32, device=pids.device)
    return hist.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))


# ---------------------------------------------------------------------------
# External interface: Insert / Delete (the foreground Updater, §4.1)
# ---------------------------------------------------------------------------

def insert_batch(state: IndexState, vecs, vids, valid):
    """Foreground insert: route to the nearest posting(s), append at tail.

    Returns ``(state, landed (B,))``; ``landed`` is False where the
    primary (nearest-posting) append failed (posting or pool full)."""
    cfg = state.cfg
    r = cfg.replica_count
    idx = vm._targets(state.versions, vids, valid)
    cleared = state.versions[idx] & vm.VERSION_MASK
    versions = state.versions.clone()
    versions[idx] = cleared
    state = state.replace(versions=versions)

    pids, _, replica_ok = route(state, vecs, r)
    enable = valid[:, None] & replica_ok                # (B, R)
    flat_pids = pids.reshape(-1)
    flat_enable = enable.reshape(-1)
    flat_vecs = torch.repeat_interleave(vecs, r, dim=0)
    flat_vids = torch.repeat_interleave(vids, r)
    flat_vers = torch.repeat_interleave(cleared, r)
    want = flat_enable & (flat_pids >= 0)
    pool, oks = bp.append_batch(
        state.pool, torch.clamp(flat_pids, min=0), flat_vecs, flat_vids,
        flat_vers, want,
    )
    landed = oks.reshape(-1, r)[:, 0] | ~valid
    telemetry = _bump_append_telemetry(state, flat_pids, flat_vecs, oks)
    stats = state.stats
    stats = bump_stat(stats, "n_inserts", valid.sum())
    stats = bump_stat(stats, "n_appends", oks.sum())
    stats = bump_stat(stats, "n_append_drops", want.sum() - oks.sum())
    return state.replace(
        pool=pool, stats=stats, telemetry=telemetry, step=state.step + 1
    ), landed


def delete_batch(state: IndexState, vids, valid) -> IndexState:
    """Tombstone delete (a bit set in the version map)."""
    versions = vm.mark_deleted(state.versions, torch.clamp(vids, min=0), valid)
    stats = bump_stat(state.stats, "n_deletes", valid.sum())
    return state.replace(versions=versions, stats=stats, step=state.step + 1)


# ---------------------------------------------------------------------------
# Search (the SPANN searcher over versioned postings)
# ---------------------------------------------------------------------------

def _dedup_prefilter(cfg, k: int, n: int) -> int:
    """Static candidate cap for the dedup reduce: the k-th distinct vid
    must sit within the first ``k * max_live_replicas`` sorted entries."""
    return max(k, min(n, max(4 * k, 2 * k * cfg.replica_count)))


def _dedup_topk_1d_full(dists, vids, live, k: int, prefilter: int):
    """Top-k smallest with duplicate-vid suppression, row-wise over
    ``(Q, n)`` candidates.

    One stable top-k prefilter to ``prefilter`` candidates (so an entry's
    equal-or-closer duplicates precede it), an O(prefilter²) first-
    occurrence mask, then the final masked top-k.  Returns ``(top_d (Q,
    k), out_vids (Q, k), orig_idx (Q, k))``; ``orig_idx`` indexes the input
    candidates (-1 for masked rows)."""
    n = dists.shape[-1]
    m = min(max(prefilter, k), n)
    d = torch.where(live, dists, MASK_DISTANCE)
    sd, sel = stable_topk(d, m)
    sv = torch.gather(vids, -1, sel)
    idx = torch.arange(m, device=dists.device)
    earlier = idx[:, None] > idx[None, :]
    earlier_dup = (sv[..., :, None] == sv[..., None, :]) & earlier
    keep = ~earlier_dup.any(dim=-1) & (sd < MASK_DISTANCE / 2)
    top_d, s2 = masked_topk(sd, keep, k)
    ok = top_d < MASK_DISTANCE / 2
    out_vids = torch.where(ok, torch.gather(sv, -1, s2), -1)
    orig_idx = torch.where(ok, torch.gather(sel, -1, s2), -1)
    return top_d, out_vids, orig_idx


def _page_table(state: IndexState, pids, probe_valid):
    """Probed pids → ``(Q, nprobe*MB)`` block ids, -1 for absent pages and
    invalid probes."""
    q = pids.shape[0]
    table = state.pool.posting_blocks[torch.clamp(pids.long(), min=0)]
    table = torch.where(((pids >= 0) & probe_valid)[..., None], table, -1)
    return table.reshape(q, -1)


def _page_slot_live(state: IndexState, pages):
    """Per-slot ``(vids, live)`` of a set of pages ``(...)`` → ``(..., BS)``."""
    pool = state.pool
    safe = torch.clamp(pages.long(), min=0)
    pvids = pool.block_vid[safe]
    pvers = pool.block_ver[safe]
    live = (
        (pages >= 0)[..., None]
        & (pvids >= 0)
        & ~vm.is_stale(state.versions, pvids, pvers)
    )
    return pvids, live


def _pallas_scan_candidates(state: IndexState, queries, pids, probe_valid, *,
                            k: int, schedule: str):
    """Paged posting scan through the hand-written kernels → reduced
    candidates ``(dists (Q, n), vids (Q, n), pos (Q, n), live (Q, n))``
    with n = pages·kpage; ``pos`` is each candidate's pool position
    (``block_id·BS + slot``, -1 dead), which the exact rerank gathers from
    the cold tier.

    ``per_query`` scores every probed page against its own query;
    ``batched`` dedups the micro-batch's pages to ``scan_page_budget``
    (overflow drops the highest-numbered pages) and scores each unique page
    against all queries, then gathers each query's own pages back out.
    With the ``int8`` codec the ``_q8`` kernels run: each page carries its
    posting's ``(scale, zero)`` and is dequantised inside the kernel."""
    cfg = state.cfg
    pool = state.pool
    q, nprobe = pids.shape
    mb = pool.max_blocks_per_posting
    bs = pool.block_size
    kpage = min(k, bs)
    quant = pool.codec == "int8"
    flat = _page_table(state, pids, probe_valid)        # (Q, NB)
    if quant:
        # posting owning each page row: pages j of probe i are i*MB..i*MB+MB-1
        safe_pp = torch.clamp(torch.repeat_interleave(pids, mb, dim=1), min=0).long()

    if schedule == "per_query":
        pvids, live = _page_slot_live(state, flat)      # (Q, NB, BS)
        if quant:
            d, slots = scan_ops.scan_posting_blocks_topk_q8(
                queries, flat, live, pool.blocks,
                pool.post_scale[safe_pp], pool.post_zero[safe_pp], k=kpage,
            )                                           # (Q, NB, kpage)
        else:
            d, slots = scan_ops.scan_posting_blocks_topk(
                queries, flat, live, pool.blocks, k=kpage
            )                                           # (Q, NB, kpage)
        slots = slots.long()
        cand_v = torch.gather(pvids, 2, slots)
        cand_p = torch.where(
            (flat >= 0)[:, :, None], flat[:, :, None].long() * bs + slots, -1
        )
        cand_d = d.reshape(q, -1)
        cand_v = cand_v.reshape(q, -1)
        cand_p = cand_p.reshape(q, -1)
    elif schedule == "batched":
        budget = cfg.scan_page_budget or min(q * nprobe * mb, cfg.num_blocks)
        uniq, member_pos, _, _ = scan_ops.dedup_pages(
            flat.reshape(-1), budget=budget, num_blocks=cfg.num_blocks
        )
        pvids, live = _page_slot_live(state, uniq)      # (budget, BS)
        if quant:
            # invert the dedup: every probe writes its posting's (scale,
            # zero) onto its unique-page row; dropped probes write the
            # spare row ``budget``, which is cut.  One posting owns each
            # block, so writers that collide carry equal values.
            tgt = torch.where(member_pos >= 0, member_pos, budget).long()
            u_scale = torch.ones(budget + 1, dtype=torch.float32, device=queries.device)
            u_zero = torch.zeros(budget + 1, dtype=torch.float32, device=queries.device)
            u_scale[tgt] = pool.post_scale[safe_pp].reshape(-1)
            u_zero[tgt] = pool.post_zero[safe_pp].reshape(-1)
            d, slots = scan_ops.scan_unique_blocks_topk_q8(
                queries, uniq, live, pool.blocks, u_scale[:budget], u_zero[:budget],
                k=kpage,
            )                                           # (budget, Q, kpage)
        else:
            d, slots = scan_ops.scan_unique_blocks_topk(
                queries, uniq, live, pool.blocks, k=kpage
            )                                           # (budget, Q, kpage)
        mp = member_pos.reshape(q, -1).long()           # (Q, NB)
        safe_mp = torch.clamp(mp, min=0)
        qi = torch.arange(q, device=queries.device)[:, None]
        sl = slots[safe_mp, qi].long()                  # (Q, NB, kpage)
        hit = (mp >= 0)[:, :, None]
        cand_d = torch.where(hit, d[safe_mp, qi], MASK_DISTANCE).reshape(q, -1)
        cand_v = torch.gather(pvids[safe_mp], 2, sl).reshape(q, -1)
        page = uniq[safe_mp].long()[:, :, None]
        cand_p = torch.where(hit & (page >= 0), page * bs + sl, -1).reshape(q, -1)
    else:
        raise ValueError(
            f"scan_schedule must be 'per_query' or 'batched', got {schedule!r}"
        )
    return cand_d, cand_v, cand_p.to(torch.int32), cand_d < MASK_DISTANCE / 2


def scan_page_stats(state: IndexState, queries, *, nprobe=None,
                    scan_page_budget=None) -> dict:
    """Batched-schedule page accounting for a query micro-batch:
    ``{"n_pages", "n_unique", "overflow"}`` (0-d tensors)."""
    cfg = state.cfg
    nprobe = cfg.nprobe if nprobe is None else nprobe
    budget = cfg.scan_page_budget if scan_page_budget is None else scan_page_budget
    budget = budget or min(
        queries.shape[0] * nprobe * cfg.max_blocks_per_posting, cfg.num_blocks
    )
    nav_d, pids = navigate(state, queries, nprobe)
    flat = _page_table(state, pids, nav_d < MASK_DISTANCE / 2)
    _, _, n_unique, overflow = scan_ops.dedup_pages(
        flat.reshape(-1), budget=budget, num_blocks=cfg.num_blocks
    )
    return {"n_pages": (flat >= 0).sum(), "n_unique": n_unique, "overflow": overflow}


def _posting_positions(pool, flat_pids):
    """Pool positions of every capacity slot of the given postings:
    ``(m,)`` pids → ``(m, cap)``, -1 for absent blocks."""
    bids = pool.posting_blocks[flat_pids.long()].long()  # (m, MB)
    slot = torch.arange(pool.block_size, device=bids.device)
    pos = bids[..., None] * pool.block_size + slot
    pos = torch.where(bids[..., None] >= 0, pos, -1)
    return pos.reshape(flat_pids.shape[0], -1).to(torch.int32)


def _scan_probe_chunk(state: IndexState, queries, pids, probe_valid):
    """Gather oracle for one chunk of probes: ``queries (Q, d)``, ``pids
    (Q, c)`` → ``(dists (Q, c*cap), vids, pos, live)``.  The math runs in
    ``cfg.scan_dtype`` with an f32 sum, over the decoded hot tier."""
    cfg = state.cfg
    q, c = pids.shape
    cap = cfg.posting_capacity
    flat_pids = torch.clamp(pids.reshape(-1), min=0)
    vecs, vids, vers, slot_valid = bp.parallel_get_hot(state.pool, flat_pids)
    pos = _posting_positions(state.pool, flat_pids)
    stale = vm.is_stale(state.versions, vids, vers)
    live = slot_valid & ~stale & probe_valid.reshape(-1)[:, None]
    vecs = vecs.reshape(q, c * cap, -1)
    sd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.scan_dtype]
    diff = queries.to(sd)[:, None, :] - vecs.to(sd)
    dists = torch.sum((diff * diff).float(), dim=-1)
    return (
        dists, vids.reshape(q, c * cap), pos.reshape(q, c * cap),
        live.reshape(q, c * cap),
    )


def _rerank_exact(state: IndexState, queries, cand_d, cand_v, cand_pos, k: int):
    """Exact fp32 rerank of an over-fetched, already vid-deduped candidate
    set: gather each candidate's vector by pool position ``cand_pos (Q,
    k')`` from the cold exact tier (the hot tier where there is none), take
    the direct f32 diff², and keep the ``k`` nearest, lowest index first
    among equal distances."""
    pool = state.pool
    tier = pool.blocks_exact if pool.blocks_exact is not None else pool.blocks
    flat = tier.reshape(-1, pool.dim)
    vecs = flat[torch.clamp(cand_pos, min=0).long()].float()   # (Q, k', d)
    diff = vecs - queries.float()[:, None, :]
    dist = torch.sum(diff * diff, dim=-1)
    dist = torch.where((cand_pos >= 0) & (cand_v >= 0), dist, MASK_DISTANCE)
    top_d, sel = stable_topk(dist, k)
    out_v = torch.where(top_d < MASK_DISTANCE / 2, torch.gather(cand_v, 1, sel), -1)
    return top_d, out_v


def scan_and_reduce(state: IndexState, queries, pids, probe_valid, *, k: int,
                    probe_chunk: int = 0, use_pallas_scan=None,
                    scan_schedule=None):
    """Posting scan + dedup top-k over an already-navigated probe set.

    The kernel path (``use_pallas_scan``) reduces pages to per-page k-min
    candidates; the gather oracle materializes the probe buffer, in
    ``probe_chunk``-sized pieces with a running candidate set if asked.
    With a lossy codec and ``cfg.rerank_factor > 1`` every path
    over-fetches ``rerank_factor × k`` deduped candidates and reranks them
    on the exact tier before the final top-k."""
    cfg = state.cfg
    q, nprobe = pids.shape
    cap = cfg.posting_capacity
    pallas = cfg.use_pallas_scan if use_pallas_scan is None else use_pallas_scan
    schedule = scan_schedule if scan_schedule is not None else cfg.scan_schedule
    rerank = cfg.rerank_factor > 1 and state.pool.blocks_exact is not None
    kq = k * cfg.rerank_factor if rerank else k

    def reduce_and_rerank(cand_d, cand_v, cand_p, live):
        n = cand_d.shape[1]
        kk = min(kq, n) if rerank else k
        d, v, oi = _dedup_topk_1d_full(cand_d, cand_v, live, kk,
                                       _dedup_prefilter(cfg, kk, n))
        if not rerank:
            return d, v
        pos = torch.gather(cand_p, 1, torch.clamp(oi, min=0).long())
        pos = torch.where(oi >= 0, pos, -1)
        return _rerank_exact(state, queries, d, v, pos, k)

    if pallas:
        cand_d, cand_v, cand_p, live = _pallas_scan_candidates(
            state, queries, pids, probe_valid, k=kq, schedule=schedule
        )
        return reduce_and_rerank(cand_d, cand_v, cand_p, live)

    if probe_chunk <= 0 or nprobe % probe_chunk != 0 or nprobe == probe_chunk:
        return reduce_and_rerank(*_scan_probe_chunk(state, queries, pids, probe_valid))

    keep = min(max(4 * kq, 64), probe_chunk * cap)
    best_d = torch.full((q, keep), MASK_DISTANCE, dtype=torch.float32, device=queries.device)
    best_v = torch.full((q, keep), -1, dtype=torch.int32, device=queries.device)
    best_p = torch.full((q, keep), -1, dtype=torch.int32, device=queries.device)
    for s in range(0, nprobe, probe_chunk):
        d, v, p, live = _scan_probe_chunk(
            state, queries, pids[:, s:s + probe_chunk],
            probe_valid[:, s:s + probe_chunk],
        )
        d = torch.where(live, d, MASK_DISTANCE)
        best_d, sel = stable_topk(torch.cat([best_d, d], dim=1), keep)
        best_v = torch.gather(torch.cat([best_v, v], dim=1), 1, sel)
        best_p = torch.gather(torch.cat([best_p, p], dim=1), 1, sel)
    return reduce_and_rerank(best_d, best_v, best_p, best_d < MASK_DISTANCE / 2)


def search(state: IndexState, queries, *, k: int, nprobe=None,
           probe_chunk: int = 0, use_pallas_scan=None, scan_schedule=None,
           with_access: bool = False, qvalid=None):
    """ANN search: centroid navigation → posting scan → dedup top-k.

    Returns ``(dists (Q, k), vids (Q, k))``, missing results ``-1`` with
    MASK_DISTANCE; ``with_access=True`` adds the per-posting probe
    histogram (``qvalid`` masks padded query rows out of it only)."""
    cfg = state.cfg
    nprobe = cfg.nprobe if nprobe is None else nprobe
    nav_d, pids = navigate(state, queries, nprobe)
    probe_valid = nav_d < MASK_DISTANCE / 2
    d, v = scan_and_reduce(
        state, queries, pids, probe_valid, k=k, probe_chunk=probe_chunk,
        use_pallas_scan=use_pallas_scan, scan_schedule=scan_schedule,
    )
    if not with_access:
        return d, v
    counted = probe_valid if qvalid is None else probe_valid & qvalid[:, None]
    return d, v, probe_histogram(cfg, pids, counted)
