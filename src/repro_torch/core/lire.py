"""LIRE protocol operations — paper §3 + §4.2.

External interface: :func:`insert_batch`, :func:`delete_batch`,
:func:`search`.  Internal (Local Rebuilder): :func:`split_posting`,
:func:`merge_posting`, :func:`maintenance_step`, and the batched
:func:`maintenance_round` (K split + K merge jobs with one fused
reassignment pass), drained by :func:`rebuild_drain`.

Every op is a fixed-shape state transition, as in the reference: branchy
protocol logic is expressed with enable masks.  The input state's tensors
are not written, unless an owner of the state passes ``inplace=True``:
then the block pool is written in place (see ``storage.blockpool``), with
bit-identical results.  Nothing in an op reads a value back to the host:
``rebuild_drain`` reads one did-work count per round.  Scatters give one
value to each location and every float sum runs in a fixed order, so a
round replays bit for bit on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import npa
from repro_torch.core.clustering import balanced_two_means
from repro_torch.core.distance import (
    MASK_DISTANCE,
    masked_topk,
    pairwise_sql2,
    stable_topk,
)
from repro_torch.core.types import (
    IndexState,
    alloc_pids,
    bump_stat,
    free_pids,
    set_centroids,
)
from repro_torch.kernels.posting_scan import ops as scan_ops
from repro_torch.storage import blockpool as bp
from repro_torch.storage import versionmap as vm
from repro_torch.utils import trace
from repro_torch.utils.scatter import masked_set_


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

def _segment_sums(vals, first, last):
    """Float sums of segments of consecutive rows of ``vals (n, d)``,
    ``first`` / ``last`` marking each segment's first and last row.
    Returns ``(seg (n,), sums (n, d))``: row i lies in segment ``seg[i]``,
    whose total is ``sums[seg[i]]`` (rows of ``sums`` past the last
    segment are 0).

    ``torch.segment_reduce`` adds each segment's rows in row order, so
    every run gives the same bits (PyTorch makes no such promise for a
    floating-point ``cumsum`` on the card).  The segment lengths are
    written by a scatter to distinct targets, so nothing is read back."""
    n = vals.shape[0]
    pos = torch.arange(n, device=vals.device)
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    seg = torch.cumsum(first.long(), 0) - 1
    lengths = masked_set_(torch.zeros(n, dtype=torch.long, device=vals.device), seg,
                          pos - start + 1, last)
    return seg, torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def _bump_append_telemetry(state: IndexState, pids, vecs, landed):
    """Every landed row bumps its posting's ``update_count`` and adds its
    displacement from the current centroid into ``drift_vec``.

    The float sum runs in a fixed order: rows are grouped by posting in
    row order, each posting's displacements summed in float64 by
    :func:`_segment_sums`, and the segment total added to the f32 leaf
    once, so no two additions race on the card."""
    tel = state.telemetry
    cap = state.cfg.num_postings_cap
    safe = torch.clamp(pids.long(), min=0)
    update = tel.update_count.clone()
    update.index_add_(0, safe, landed.to(torch.int32))   # integer adds: exact
    key = torch.where(landed, safe, cap)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    disp = (vecs.float() - state.centroids[safe]).double()
    n = sk.shape[0]
    if n == 0:
        return tel.replace(update_count=update)
    first = torch.ones(n, dtype=torch.bool, device=sk.device)
    first[1:] = sk[1:] != sk[:-1]
    last = torch.ones(n, dtype=torch.bool, device=sk.device)
    last[:-1] = first[1:]
    seg, sums = _segment_sums(torch.where(landed[:, None], disp, 0.0)[order], first, last)
    tgt = torch.clamp(sk, max=cap - 1)
    total = (tel.drift_vec[tgt].double() + sums[seg]).float()
    drift = masked_set_(tel.drift_vec.clone(), tgt, total, last & (sk < cap))
    return tel.replace(update_count=update, drift_vec=drift)


def probe_histogram(cfg, pids, probe_valid):
    """Per-posting probe counts for one search micro-batch.  Invalid
    probes count into a spare bin that is cut (a boolean-mask gather
    would read its size back to the host)."""
    cap = cfg.num_postings_cap
    tgt = torch.where(probe_valid, pids.long(), cap).reshape(-1)
    hist = torch.zeros((cap + 1,), dtype=torch.int32, device=pids.device)
    return hist.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:cap]


# ---------------------------------------------------------------------------
# External interface: Insert / Delete (the foreground Updater, §4.1)
# ---------------------------------------------------------------------------

def insert_batch(state: IndexState, vecs, vids, valid, *, inplace: bool = False):
    """Foreground insert: route to the nearest posting(s), append at tail.

    Returns ``(state, landed (B,))``; ``landed`` is False where the
    primary (nearest-posting) append failed (posting or pool full): the
    host Updater then runs the Local Rebuilder and retries.
    ``inplace`` writes the block pool in place (its owner only)."""
    cfg = state.cfg
    r = cfg.replica_count
    idx = vm._targets(state.versions, vids, valid)
    cleared = state.versions[idx] & vm.VERSION_MASK
    versions = state.versions.clone()
    versions[idx] = cleared
    state = state.replace(versions=versions)

    with trace.span("insert.route"):
        pids, _, replica_ok = route(state, vecs, r)
    enable = valid[:, None] & replica_ok                # (B, R)
    flat_pids = pids.reshape(-1)
    flat_enable = enable.reshape(-1)
    flat_vecs = torch.repeat_interleave(vecs, r, dim=0)
    flat_vids = torch.repeat_interleave(vids, r)
    flat_vers = torch.repeat_interleave(cleared, r)
    want = flat_enable & (flat_pids >= 0)
    with trace.span("insert.append"):
        pool, oks = bp.append_batch(
            state.pool, torch.clamp(flat_pids, min=0), flat_vecs, flat_vids,
            flat_vers, want, inplace=inplace,
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
    against all queries, keeping candidates only where a query probed the
    page, straight in its probe order (the kernels' pairs form, through
    the inverse of the dedup).
    With the ``int8`` codec the ``_q8`` kernels run: each page carries its
    posting's ``(scale, zero)`` and is dequantised inside the kernel."""
    cfg = state.cfg
    pool = state.pool
    q, nprobe = pids.shape
    mb = pool.max_blocks_per_posting
    bs = pool.block_size
    kpage = min(k, bs)
    quant = pool.codec == "int8"
    if schedule not in ("per_query", "batched"):
        raise ValueError(
            f"scan_schedule must be 'per_query' or 'batched', got {schedule!r}"
        )
    with trace.span("search.pages"):
        flat = _page_table(state, pids, probe_valid)    # (Q, NB)
        if quant:
            # posting owning each page row: pages j of probe i are i*MB..i*MB+MB-1
            safe_pp = torch.clamp(torch.repeat_interleave(pids, mb, dim=1), min=0).long()
        if schedule == "per_query":
            pvids, live = _page_slot_live(state, flat)  # (Q, NB, BS)
        else:
            budget = cfg.scan_page_budget or min(q * nprobe * mb, cfg.num_blocks)
            uniq, member_pos, _, _ = scan_ops.dedup_pages(
                flat.reshape(-1), budget=budget, num_blocks=cfg.num_blocks
            )
            mp = member_pos.reshape(q, -1)              # (Q, NB)
            page_pos = scan_ops.page_positions(mp, budget)  # (budget, Q)
            _, live = _page_slot_live(state, uniq)      # (budget, BS)
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

    if schedule == "per_query":
        with trace.span("search.scan"):
            if quant:
                d, slots = scan_ops.scan_posting_blocks_topk_q8(
                    queries, flat, live, pool.blocks,
                    pool.post_scale[safe_pp], pool.post_zero[safe_pp], k=kpage,
                )                                       # (Q, NB, kpage)
            else:
                d, slots = scan_ops.scan_posting_blocks_topk(
                    queries, flat, live, pool.blocks, k=kpage
                )                                       # (Q, NB, kpage)
        with trace.span("search.gather"):
            slots = slots.long()
            cand_v = torch.gather(pvids, 2, slots)
            cand_p = torch.where(
                (flat >= 0)[:, :, None], flat[:, :, None].long() * bs + slots, -1
            )
            cand_d = d.reshape(q, -1)
            cand_v = cand_v.reshape(q, -1)
            cand_p = cand_p.reshape(q, -1)
            return cand_d, cand_v, cand_p.to(torch.int32), cand_d < MASK_DISTANCE / 2
    nbq = mp.shape[1]
    with trace.span("search.scan"):
        if quant:
            d, slots = scan_ops.scan_unique_blocks_topk_q8_pairs(
                queries, uniq, live, pool.blocks, u_scale[:budget], u_zero[:budget],
                page_pos, nbq=nbq, k=kpage,
            )                                           # (Q, NB, kpage)
        else:
            d, slots = scan_ops.scan_unique_blocks_topk_pairs(
                queries, uniq, live, pool.blocks, page_pos, nbq=nbq, k=kpage
            )                                           # (Q, NB, kpage)
    with trace.span("search.gather"):
        # a probe whose page was not kept reads (MASK_DISTANCE, slot -1):
        # not live, position -1, vid -1
        hit = (mp >= 0)[:, :, None]
        page = uniq[torch.clamp(mp, min=0).long()].long()[:, :, None]
        cand_p = torch.where(hit, page * bs + slots, -1).reshape(q, -1)
        cand_v = torch.where(cand_p >= 0,
                             pool.block_vid.reshape(-1)[torch.clamp(cand_p, min=0)], -1)
        cand_d = d.reshape(q, -1)
        return cand_d, cand_v, cand_p.to(torch.int32), cand_d < MASK_DISTANCE / 2


def scan_page_stats(state: IndexState, queries, *, nprobe=None,
                    scan_page_budget=None) -> dict:
    """Batched-schedule page accounting for a query micro-batch:
    ``{"n_pages", "n_unique", "overflow", "n_pairs"}`` (0-d tensors);
    ``n_pairs`` counts the (page, query) pairs the scan selects and stores
    (a probe whose page was kept)."""
    cfg = state.cfg
    nprobe = cfg.nprobe if nprobe is None else nprobe
    budget = cfg.scan_page_budget if scan_page_budget is None else scan_page_budget
    budget = budget or min(
        queries.shape[0] * nprobe * cfg.max_blocks_per_posting, cfg.num_blocks
    )
    nav_d, pids = navigate(state, queries, nprobe)
    flat = _page_table(state, pids, nav_d < MASK_DISTANCE / 2)
    _, member_pos, n_unique, overflow = scan_ops.dedup_pages(
        flat.reshape(-1), budget=budget, num_blocks=cfg.num_blocks
    )
    return {"n_pages": (flat >= 0).sum(), "n_unique": n_unique, "overflow": overflow,
            "n_pairs": (member_pos >= 0).sum()}


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
        with trace.span("search.topk"):
            d, v, oi = _dedup_topk_1d_full(cand_d, cand_v, live, kk,
                                           _dedup_prefilter(cfg, kk, n))
        if not rerank:
            return d, v
        with trace.span("search.rerank"):
            pos = torch.gather(cand_p, 1, torch.clamp(oi, min=0).long())
            pos = torch.where(oi >= 0, pos, -1)
            return _rerank_exact(state, queries, d, v, pos, k)

    if pallas:
        cand_d, cand_v, cand_p, live = _pallas_scan_candidates(
            state, queries, pids, probe_valid, k=kq, schedule=schedule
        )
        return reduce_and_rerank(cand_d, cand_v, cand_p, live)

    if probe_chunk <= 0 or nprobe % probe_chunk != 0 or nprobe == probe_chunk:
        with trace.span("search.scan"):
            cand = _scan_probe_chunk(state, queries, pids, probe_valid)
        return reduce_and_rerank(*cand)

    keep = min(max(4 * kq, 64), probe_chunk * cap)
    with trace.span("search.scan"):
        best_d = torch.full((q, keep), MASK_DISTANCE, dtype=torch.float32,
                            device=queries.device)
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
    with trace.span("search.navigate"):
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


# ---------------------------------------------------------------------------
# Reassignment execution (shared by split and merge)
# ---------------------------------------------------------------------------

def _first_true_first(mask):
    """Row order with the True rows first, each group in row order."""
    return torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices


def _dedup_vid_mask_ref(vids, mask):
    """Same-vid dedup, O(n²): a masked row is dropped when an earlier
    masked row carries the same vid (the oracle of :func:`_dedup_vid_mask`)."""
    n = vids.shape[0]
    idx = torch.arange(n, device=vids.device)
    same = (vids[:, None] == vids[None, :]) & (idx[:, None] > idx[None, :])
    return mask & ~(same & mask[None, :]).any(dim=1)


def _dedup_vid_mask(vids, mask):
    """First occurrence of each vid among the masked rows: one stable sort
    on a masked key (unmasked rows key to a sentinel, so they never
    suppress a masked row)."""
    key = torch.where(mask, vids.long(), torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.ones_like(mask)
    first[1:] = sk[1:] != sk[:-1]
    keep = torch.empty_like(mask)
    keep[order] = first
    return mask & keep


def _execute_reassigns(state: IndexState, cand_vecs, cand_vids, cand_cur_pid,
                       cand_mask, budget: int | None = None, *,
                       inplace: bool = False) -> IndexState:
    """Paper §3.3 final stage: per candidate, find the nearest posting now,
    drop the false positives (NPA re-check), then re-append at the new
    home with a tentative version and commit it where the primary landed.

    Candidates are compacted to ``budget`` rows (default
    ``cfg.reassign_budget``) and the movers to ``cfg.reassign_budget``
    rows, the rest counted as overflow; the whole round pays one
    ``(budget × P)`` argmin GEMM, one closure routing of the movers and one
    ``append_scatter``."""
    cfg = state.cfg
    r = cfg.replica_count
    c = cand_vecs.shape[0]
    budget = min(budget or cfg.reassign_budget, c)

    take = _first_true_first(cand_mask)[:budget]
    vecs = cand_vecs[take]
    vids = cand_vids[take]
    cur_pid = cand_cur_pid[take]
    mask = cand_mask[take]
    n_cand = cand_mask.sum()
    overflow = torch.clamp(n_cand - budget, min=0)

    # same vid twice in the batch: the first occurrence moves
    mask = _dedup_vid_mask(vids, mask)
    safe_vids = torch.clamp(vids.long(), min=0)
    mask = mask & ~vm.is_deleted(state.versions, safe_vids) & (vids >= 0)

    # NPA re-check: the nearest valid posting now (argmin, lowest index first)
    d_all = pairwise_sql2(vecs, state.centroids, state.centroid_sqn)
    d_all = torch.where(state.centroid_valid[None, :], d_all, MASK_DISTANCE)
    nearest = torch.argmin(d_all, dim=1)
    nearest = torch.where(torch.amin(d_all, dim=1) < MASK_DISTANCE / 2, nearest, -1)
    # false positive: a live replica of this version already sits there
    cur_ver = state.versions[safe_vids] & vm.VERSION_MASK
    t_vids, t_vers, t_valid = bp.gather_posting_ids(state.pool, torch.clamp(nearest, min=0))
    replica_there = (
        (t_vids == vids[:, None]) & t_valid
        & ((t_vers & vm.VERSION_MASK) == cur_ver[:, None])
    ).any(dim=-1)
    need = mask & (nearest >= 0) & (nearest != cur_pid) & ~replica_there

    # at most reassign_budget movers; the rest stay where they are
    movers = min(cfg.reassign_budget, budget)
    mtake = _first_true_first(need)[:movers]
    m_vecs = vecs[mtake]
    m_vids = vids[mtake]
    m_safe_vids = safe_vids[mtake]
    m_need = need[mtake]
    overflow = overflow + torch.clamp(need.sum() - movers, min=0)
    m_pids, _, m_replica_ok = route(state, m_vecs, r)

    # fresh replicas at the new homes carry a TENTATIVE version; the map
    # is bumped only where the primary landed (else the old replicas stay
    # live and the tentative ones are garbage for the next split's GC)
    tentative = (cur_ver[mtake] + 1) & vm.VERSION_MASK
    enable = m_need[:, None] & m_replica_ok & (m_pids >= 0)
    flat_pids = torch.clamp(m_pids.reshape(-1), min=0)
    flat_enable = enable.reshape(-1)
    flat_vecs = torch.repeat_interleave(m_vecs, r, dim=0)
    pool, oks = bp.append_scatter(
        state.pool, flat_pids, flat_vecs, torch.repeat_interleave(m_vids, r),
        torch.repeat_interleave(tentative, r), flat_enable, inplace=inplace,
    )
    commit = m_need & oks.reshape(-1, r)[:, 0]
    telemetry = _bump_append_telemetry(state, flat_pids, flat_vecs, oks)
    stats = state.stats
    stats = bump_stat(stats, "n_reassign_candidates", n_cand)
    stats = bump_stat(stats, "n_reassign_overflow", overflow)
    stats = bump_stat(stats, "n_reassigned", commit.sum())
    stats = bump_stat(stats, "n_appends", oks.sum())
    stats = bump_stat(stats, "n_append_drops", flat_enable.sum() - oks.sum())
    return state.replace(
        pool=pool, stats=stats, telemetry=telemetry,
        versions=vm.bump_version(state.versions, m_safe_vids, commit),
    )


# ---------------------------------------------------------------------------
# Split (Local Rebuilder job, §4.2.1) — batched K-job core + K=1 wrapper
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply) on int64 tensors holding
    values in [0, 2^32): the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def split_draw(rng, k: int, n: int):
    """The split's random draw from the state's key ``rng (2,) u32``:
    ``(next key (2,) u32, init scores (k, n) int64 in [0, 2^32))``.

    A counter-based hash of the key, so a round replays bit for bit and
    gives the same bits on the card and on the CPU.  The scores play the
    part of the reference's Gumbel noise: the two live rows scoring
    highest seed a job's 2-means (:func:`balanced_two_means`)."""
    key = rng.to(torch.int64)
    a = _mix32(key[0] ^ _mix32(key[1] ^ 0x243F6A88))
    b = _mix32(key[1] ^ _mix32(key[0] ^ 0x85A308D3))
    nxt = torch.stack([_mix32(a ^ 0x13198A2E), _mix32(b ^ 0x03707344)])
    sub0, sub1 = _mix32(a ^ 0xA4093822), _mix32(b ^ 0x299F31D0)
    job = torch.arange(k, device=rng.device)[:, None]
    row = torch.arange(n, device=rng.device)[None, :]
    scores = _mix32(sub0 ^ _mix32(job * n + row)) ^ sub1
    return nxt.to(rng.dtype), _mix32(scores)


def _split_jobs(state: IndexState, pids, enable, *, draw=None, inplace: bool = False):
    """K split jobs in one fused pass; ``pids (K,)`` distinct.

    Per job: GC the posting; if it is still over ``split_limit`` live
    rows, balanced-2-means it into two fresh postings.  All K jobs share
    one batched ``balanced_two_means``, one pid alloc, one
    ``free_postings``, ONE ``put_postings`` for every half-write and GC
    write-back, and one ``(K × P)`` neighbour GEMM.  ``draw`` overrides
    ``split_draw(state.rng, K, cap)`` with ``(next key, scores)``, as a
    test feeding the reference's draw does.

    Returns ``(state, acted (K,), (cand_vecs, cand_vids, cand_cur,
    cand_mask))``: the flattened reassign candidates
    (``K·(1+reassign_range)·cap`` rows)."""
    cfg = state.cfg
    cap = cfg.posting_capacity
    rr = cfg.reassign_range
    k = pids.shape[0]
    pids = pids.to(torch.int32)
    safe = torch.clamp(pids.long(), min=0)
    enable = enable & (pids >= 0) & state.centroid_valid[safe]

    vecs, vids, vers, valid = bp.gather_postings(state.pool, safe)   # (K, cap, ...)
    live = valid & ~vm.is_stale(state.versions, vids, vers)
    n_live = live.sum(dim=1)
    cur_len = state.pool.posting_len[safe]
    cur_ver = state.versions[torch.clamp(vids.long(), min=0)] & vm.VERSION_MASK

    # Case A: the garbage-collection write-back resolves the job
    gc_wb = enable & (n_live <= cfg.split_limit) & (n_live < cur_len)
    order_live = _first_true_first(live)

    def take(buf, order):
        if buf.dim() == 3:
            order = order[..., None].expand(-1, -1, buf.shape[2])
        return torch.gather(buf, 1, order)

    # Case B: a real split
    want = enable & (n_live > cfg.split_limit)
    if not cfg.enable_split:
        want = torch.zeros_like(want)
    rng, scores = draw if draw is not None else split_draw(state.rng, k, cap)
    state = state.replace(rng=rng)
    new_centroids, assign = balanced_two_means(
        vecs.float(), live, init_scores=scores, iters=cfg.kmeans_iters
    )                                                   # (K, 2, d), (K, cap)

    state, new_pids = alloc_pids(state, torch.repeat_interleave(want, 2))
    pid1, pid2 = new_pids[0::2], new_pids[1::2]
    ok = want & (pid1 >= 0) & (pid2 >= 0)
    # roll back half-successful allocations (pid1 landed, pid2 did not)
    state = free_pids(state, new_pids, torch.repeat_interleave(want & ~ok, 2))

    old_centroid = state.centroids[safe]                # (K, d)
    old_access = state.telemetry.access_count[safe]     # read before the free

    # retire the old postings (blocks, centroids, ids)
    state = state.replace(pool=bp.free_postings(state.pool, safe, ok, inplace=inplace))
    state = free_pids(state, pids, ok)

    # halves, compacted to the front of fixed-capacity buffers; ONE put
    # for the K GC write-backs (old pid) and the 2K half-writes (fresh pids)
    in0 = live & (assign == 0)
    in1 = live & (assign == 1)
    order0, order1 = _first_true_first(in0), _first_true_first(in1)
    s1, s2 = torch.clamp(pid1, min=0), torch.clamp(pid2, min=0)
    pool, _ = bp.put_postings(
        state.pool,
        torch.cat([safe, s1, s2]),
        torch.cat([take(vecs, order_live), take(vecs, order0), take(vecs, order1)]),
        torch.cat([take(vids, order_live), take(vids, order0), take(vids, order1)]),
        torch.cat([take(cur_ver, order_live), take(cur_ver, order0), take(cur_ver, order1)]),
        torch.cat([n_live, in0.sum(dim=1), in1.sum(dim=1)]),
        torch.cat([gc_wb, ok, ok]),
        inplace=inplace,
    )
    state = state.replace(pool=pool)
    state = set_centroids(state, pid1, new_centroids[:, 0], ok)
    state = set_centroids(state, pid2, new_centroids[:, 1], ok)

    # the halves inherit the split posting's access count in proportion to
    # their live sizes (integer shares that conserve the total); their
    # update and drift telemetry start at zero (freed pids are zeroed)
    n0, n1 = in0.sum(dim=1), in1.sum(dim=1)
    share1 = (old_access.long() * n0) // torch.clamp(n0 + n1, min=1)
    share2 = old_access.long() - share1
    acc = masked_set_(state.telemetry.access_count.clone(), s1, share1, ok)
    acc = masked_set_(acc, s2, share2, ok)
    state = state.replace(telemetry=state.telemetry.replace(access_count=acc))

    # reassign candidates: the reassign_range postings nearest each OLD
    # centroid, other than the job's own halves — one (K × P) GEMM
    nb_d = pairwise_sql2(old_centroid, state.centroids, state.centroid_sqn)
    ar = torch.arange(cfg.num_postings_cap, device=nb_d.device)
    nb_valid = (state.centroid_valid[None, :] & (ar[None, :] != s1[:, None])
                & (ar[None, :] != s2[:, None]))
    nb_dist, nb_pids = masked_topk(nb_d, nb_valid, rr)
    nb_ok = nb_dist < MASK_DISTANCE / 2                 # (K, RR)
    nvecs, nvids, nvers, nvalid = bp.gather_postings(state.pool, nb_pids.reshape(-1))
    nlive = (nvalid & ~vm.is_stale(state.versions, nvids, nvers)
             & nb_ok.reshape(-1)[:, None] & torch.repeat_interleave(ok, rr)[:, None])

    # Eq. (2) for the neighbours' vectors, Eq. (1) for the split posting's
    eq2 = npa.split_neighbor_candidates(
        nvecs.reshape(k, rr * cap, cfg.dim).float(), old_centroid, new_centroids
    ).reshape(k * rr, cap)
    eq1 = npa.split_old_posting_candidates(vecs.float(), old_centroid, new_centroids)
    own_cur = torch.where(assign == 0, s1[:, None], s2[:, None])
    cand = (
        torch.cat([vecs.reshape(-1, cfg.dim), nvecs.reshape(-1, cfg.dim)]),
        torch.cat([vids.reshape(-1), nvids.reshape(-1)]),
        torch.cat([own_cur.reshape(-1), torch.repeat_interleave(nb_pids.reshape(-1), cap)]),
        torch.cat([(eq1 & live & ok[:, None]).reshape(-1), (eq2 & nlive).reshape(-1)]),
    )

    checked = torch.where(ok, n_live, 0).sum() + nlive.sum()
    stats = bump_stat(state.stats, "n_reassign_checked", checked)
    stats = bump_stat(stats, "n_splits", ok.sum())
    stats = bump_stat(stats, "n_gc_writebacks", gc_wb.sum())
    state = state.replace(stats=stats, step=state.step + 1)
    return state, ok | gc_wb, cand


def split_posting(state: IndexState, pid, enable, *, draw=None, inplace: bool = False):
    """Split job: GC the posting; if still oversized, balanced-2-means split
    it, then reassign over the split and ``reassign_range`` neighbours.
    K=1 form of :func:`_split_jobs` (``draw`` as there); returns
    ``(state, acted)``."""
    pid = torch.as_tensor(pid, device=state.device).reshape(1)
    enable = torch.as_tensor(enable, device=state.device).reshape(1)
    state, acted, cand = _split_jobs(state, pid, enable, draw=draw, inplace=inplace)
    if state.cfg.enable_reassign:
        state = _execute_reassigns(state, *cand, inplace=inplace)
    return state, acted[0]


# ---------------------------------------------------------------------------
# Merge (Local Rebuilder job, §3.2 / §4.2.1) — batched K-job core + wrapper
# ---------------------------------------------------------------------------

def _merge_jobs(state: IndexState, pids, enable, exclude_pids, *, inplace: bool = False):
    """K merge jobs in one fused pass; ``pids (K,)`` distinct.

    Each job's target is the nearest of its ``merge_fanout`` closest
    postings with room (one ``(K × P)`` GEMM); the moves land through ONE
    ``append_scatter``.  A job whose target an earlier job of the round
    also fills is charged that job's load and waits for a later round if
    it no longer fits.  ``exclude_pids`` are barred as targets (the round
    passes every merge source).  Returns ``(state, gone (K,), (cand_vecs,
    cand_vids, cand_cur, cand_mask))``: the moved vectors as reassign
    candidates."""
    cfg = state.cfg
    cap = cfg.posting_capacity
    p_cap = cfg.num_postings_cap
    k = pids.shape[0]
    pids = pids.to(torch.int32)
    safe = torch.clamp(pids.long(), min=0)
    enable = enable & (pids >= 0) & state.centroid_valid[safe]

    vecs, vids, vers, valid = bp.gather_postings(state.pool, safe)
    live = valid & ~vm.is_stale(state.versions, vids, vers)
    n_live = live.sum(dim=1)
    enable = enable & (n_live < cfg.merge_limit)

    d = pairwise_sql2(state.centroids[safe], state.centroids, state.centroid_sqn)
    ar = torch.arange(p_cap, device=d.device)
    ex = exclude_pids.long()
    excluded = ((ar[:, None] == ex[None, :]) & (ex >= 0)[None, :]).any(dim=1)
    cand_ok = state.centroid_valid & ~excluded
    cd, cpids = masked_topk(d, cand_ok[None, :].expand_as(d), cfg.merge_fanout)
    lens = state.pool.posting_len.long()
    fits = (cd < MASK_DISTANCE / 2) & (lens[cpids] + n_live[:, None] <= cap)
    any_fit = fits.any(dim=1)
    first_fit = torch.argmax(fits.to(torch.uint8), dim=1)    # first True
    target = torch.where(any_fit, torch.gather(cpids, 1, first_fit[:, None])[:, 0], -1)
    do = enable & any_fit & (n_live > 0)
    # a shared target must hold every job that picked it: charge each job
    # the load of the earlier move candidates on it
    jidx = torch.arange(k, device=d.device)
    same_t = (target[:, None] == target[None, :]) & (target >= 0)[:, None]
    earlier = same_t & (jidx[:, None] > jidx[None, :]) & do[None, :]
    prior = torch.where(earlier, n_live[None, :], 0).sum(dim=1)
    safe_t = torch.clamp(target, min=0)
    do = do & (lens[safe_t] + prior + n_live <= cap)
    retire_empty = enable & (n_live == 0)

    cur_ver = state.versions[torch.clamp(vids.long(), min=0)] & vm.VERSION_MASK
    move = live & do[:, None]
    tgt_rows = safe_t[:, None].expand(k, cap).reshape(-1)
    flat_vecs = vecs.reshape(-1, cfg.dim)
    pool, oks = bp.append_scatter(
        state.pool, tgt_rows, flat_vecs, vids.reshape(-1), cur_ver.reshape(-1),
        move.reshape(-1), inplace=inplace,
    )
    state = state.replace(pool=pool)

    # retire a source only where every live vector landed (pool OOM
    # mid-merge must not lose vectors)
    do = do & (oks.reshape(k, -1) == move).all(dim=1)
    gone = do | retire_empty

    # the moves are appends on the target; an absorbed source's access
    # count moves into its target (integer adds) before the source pid is
    # freed (which zeroes it)
    tel = _bump_append_telemetry(state, tgt_rows, flat_vecs, oks)
    acc = tel.access_count.clone()
    acc.index_add_(0, safe_t, torch.where(do, tel.access_count[safe], 0).to(torch.int32))
    state = state.replace(telemetry=tel.replace(access_count=acc))
    state = state.replace(pool=bp.free_postings(state.pool, safe, gone, inplace=inplace))
    state = free_pids(state, pids, gone)

    stats = bump_stat(state.stats, "n_merges", do.sum())
    stats = bump_stat(stats, "n_reassign_checked", torch.where(do, n_live, 0).sum())
    state = state.replace(stats=stats, step=state.step + 1)
    cand = (flat_vecs, vids.reshape(-1), tgt_rows, (live & do[:, None]).reshape(-1))
    return state, gone, cand


def merge_posting(state: IndexState, pid, enable, *, inplace: bool = False):
    """Merge job: move the undersized posting's live vectors into the
    nearest posting with room, delete its centroid, then reassign-check
    the moved vectors.  K=1 form of :func:`_merge_jobs`."""
    pid = torch.as_tensor(pid, device=state.device).reshape(1)
    enable = torch.as_tensor(enable, device=state.device).reshape(1)
    state, gone, cand = _merge_jobs(state, pid, enable, pid, inplace=inplace)
    if state.cfg.enable_reassign:
        state = _execute_reassigns(state, *cand, inplace=inplace)
    return state, gone[0]


# ---------------------------------------------------------------------------
# Maintenance driver (the Local Rebuilder queue, discovered by length scan)
# ---------------------------------------------------------------------------

def maintenance_step(state: IndexState, *, draw=None, inplace: bool = False):
    """One sequential rebuild step: split the longest posting (if over
    ``split_limit``), merge the shortest (if under ``merge_limit``).
    Returns ``(state, did_work)``; :func:`maintenance_round` is the
    batched K-job form.  ``draw`` injects the split's random draw (see
    :func:`_split_jobs`)."""
    cfg = state.cfg
    lens = state.pool.posting_len
    valid = state.centroid_valid
    split_scores = torch.where(valid, lens, -1)
    split_pid = torch.argmax(split_scores)
    # the merge is picked from the lengths before the split, as the
    # reference's step does
    merge_scores = torch.where(valid & (lens < cfg.merge_limit), lens,
                               torch.iinfo(torch.int32).max)
    merge_pid = torch.argmin(merge_scores)
    want_merge = merge_scores.amin() < cfg.merge_limit
    state, split_acted = split_posting(
        state, split_pid, split_scores.amax() > cfg.split_limit, draw=draw, inplace=inplace
    )
    if not cfg.enable_merge:
        want_merge = torch.zeros_like(want_merge)
    state, merge_acted = merge_posting(state, merge_pid, want_merge, inplace=inplace)
    return state, split_acted | merge_acted


def _select_jobs(state: IndexState, k: int):
    """Job selection for one round, per ``cfg.maintain_policy``.

    ``"size"``: the top-K longest postings split, the bottom-K shortest
    merge.  ``"drift"``: eligibility is the same (only oversized postings
    split, only undersized merge) but the ranking weighs access rate and
    centroid drift — split priority ``len/split_limit · (1 +
    alpha·access_rate) + beta·drift_rel``, merge priority ``len · (1 +
    alpha·access_rate)`` ascending.  With all-zero telemetry both reduce
    to the size order.  Ties go to the lowest pid.

    Returns ``(split_pids, split_enable, merge_pids, merge_enable)``."""
    cfg = state.cfg
    lens = state.pool.posting_len
    valid = state.centroid_valid
    i32_max = torch.iinfo(torch.int32).max

    if cfg.maintain_policy == "size":
        top_l, split_pids = stable_topk(torch.where(valid, lens, -1), k, largest=True)
        low_l, merge_pids = stable_topk(
            torch.where(valid & (lens < cfg.merge_limit), lens, i32_max), k
        )
        return split_pids, top_l > cfg.split_limit, merge_pids, low_l < cfg.merge_limit

    def f32(v):         # made on the device: copying a host scalar syncs
        return torch.full((), v, dtype=torch.float32, device=lens.device)

    tel = state.telemetry
    lens_f = lens.float()
    acc = torch.where(valid, tel.access_count, 0).float()
    n_valid = valid.sum().float()
    access_rate = acc * n_valid / torch.clamp(acc.sum(), min=1.0)
    mean_disp = torch.linalg.vector_norm(tel.drift_vec, dim=-1) / torch.clamp(
        tel.update_count.float(), min=1.0
    )
    drift_rel = mean_disp / torch.sqrt(state.centroid_sqn + f32(1e-6))
    boost = 1.0 + f32(cfg.maintain_alpha) * access_rate
    split_pri = lens_f / f32(cfg.split_limit) * boost + f32(cfg.maintain_beta) * drift_rel
    top_s, split_pids = stable_topk(
        torch.where(valid & (lens > cfg.split_limit), split_pri, -torch.inf), k, largest=True
    )
    low_m, merge_pids = stable_topk(
        torch.where(valid & (lens < cfg.merge_limit), lens_f * boost, torch.inf), k
    )
    return split_pids, top_s > -torch.inf, merge_pids, low_m < torch.inf


def maintenance_round(state: IndexState, jobs_per_round: int | None = None,
                      access=None, *, draw=None, inplace: bool = False):
    """One batched rebuild round: K split + K merge jobs picked by
    :func:`_select_jobs` (disjoint: ``merge_limit < split_limit``), then
    every job's reassign candidates in ONE :func:`_execute_reassigns`.

    Returns ``(state, n_did_work)``, a 0-d tensor the host drain reads
    once per round.  ``access`` is an optional ``(P_cap,)`` probe
    histogram folded into ``telemetry.access_count`` before selection.
    ``draw`` injects the split's random draw (see :func:`_split_jobs`);
    ``inplace`` writes the block pool in place (its owner only)."""
    cfg = state.cfg
    k = int(jobs_per_round or cfg.jobs_per_round)
    k = max(1, min(k, cfg.num_postings_cap // 2))
    if access is not None:
        tel = state.telemetry
        state = state.replace(telemetry=tel.replace(
            access_count=tel.access_count + access.to(torch.int32)))

    with trace.span("round.select"):
        split_pids, split_enable, merge_pids, merge_enable = _select_jobs(state, k)
        if not cfg.enable_merge:
            merge_enable = torch.zeros_like(merge_enable)
    with trace.span("round.split"):
        state, split_acted, s_cand = _split_jobs(
            state, split_pids, split_enable, draw=draw, inplace=inplace
        )
    # merges run after the splits (freed split pids are invalid targets);
    # every ENABLED merge source is barred as a target of every job
    with trace.span("round.merge"):
        state, merge_acted, m_cand = _merge_jobs(
            state, merge_pids, merge_enable, torch.where(merge_enable, merge_pids, -1),
            inplace=inplace,
        )
    if cfg.enable_reassign:
        with trace.span("round.reassign"):
            cand = tuple(torch.cat([a, b]) for a, b in zip(s_cand, m_cand))
            state = _execute_reassigns(
                state, *cand, budget=max(cfg.reassign_budget, k * cfg.reassign_budget // 2),
                inplace=inplace,
            )
    return state, split_acted.sum() + merge_acted.sum()


def rebuild_drain(state: IndexState, max_steps: int | None = None,
                  jobs_per_round: int | None = None, *, donate: bool = False,
                  access=None):
    """Host-driven Local Rebuilder loop: run :func:`maintenance_round` until
    a round does nothing, reading back ONE did-work count per round.

    ``max_steps`` caps the jobs run (default ``2·P_cap``, past the
    convergence bound; the last round may overshoot by up to
    ``jobs_per_round - 1``).  ``donate=True`` lets the rounds write the
    caller's block pool in place — only for a caller that owns the state
    (``SPFreshIndex.maintain``).  ``access`` folds into the first round's
    selection.  Returns ``(state, jobs_done, rounds)``."""
    cfg = state.cfg
    jobs = int(jobs_per_round or cfg.jobs_per_round)
    cap_jobs = max_steps if max_steps is not None else 2 * cfg.num_postings_cap
    done = rounds = 0
    while done < cap_jobs:
        with trace.span("round"):
            state, did = maintenance_round(state, jobs, access, inplace=donate)
            with trace.span("round.readback"):
                d = int(did)            # the round's one device → host read
        access = None
        rounds += 1
        done += d
        if d == 0:
            break
    return state, done, rounds
