"""Two-level centroid routing — the arithmetic-intensity-optimized
replacement for SPANN's SPTAG navigation graph (beyond-paper opt #1).

The flat navigator computes a (Q × P) distance GEMM over every posting
centroid.  Two-level routing clusters the centroids into G balanced
groups; a query first scores the G group centroids, then scores only the
members of its ``gprobe`` nearest groups:

    FLOPs: Q·G·d + Q·gprobe·γ·d   vs   Q·P·d      (γ = group capacity)

Freshness: the group index is a *derived* structure rebuilt by the host
after maintenance; splits between refreshes leave new centroids unrouted,
which degrades recall gracefully until the next refresh.

Level 2 is plain PyTorch (the reference computes it without a kernel): a
gather of the candidate centroids and their direct f32 ``diff²``, walked
in query chunks so the gathered block stays near ``_GATHER_ELEMS``
elements; rows are independent, so the chunking changes no result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lire
from repro_torch.core.clustering import balanced_kmeans
from repro_torch.core.distance import MASK_DISTANCE, masked_topk, pairwise_sql2, stable_topk
from repro_torch.core.types import IndexState
from repro_torch.utils.tree import state_dataclass

# candidate-centroid elements gathered at once by level 2 (1 GiB of f32)
_GATHER_ELEMS = 1 << 28


@state_dataclass
class GroupIndex:
    group_centroids: torch.Tensor   # (G, d) f32
    group_sqn: torch.Tensor         # (G,) f32
    members: torch.Tensor           # (G, gamma) i32 posting ids, -1 empty
    member_valid: torch.Tensor      # (G, gamma) bool


def place_members(assign: np.ndarray, valid: np.ndarray, n_groups: int,
                  capacity: int) -> np.ndarray:
    """``(G, capacity)`` member table: every valid posting, in pid order,
    joins its group; a full group sends it to the least-full group (the
    first among equals).  Raises if the capacity cannot hold them all."""
    members = np.full((n_groups, capacity), -1, np.int32)
    counts = np.zeros(n_groups, np.int64)
    dropped = 0
    for pid in np.flatnonzero(valid):
        g = int(assign[pid])
        if g < 0:
            continue
        if counts[g] >= capacity:
            g = int(np.argmin(counts))
            if counts[g] >= capacity:
                dropped += 1
                continue
        members[g, counts[g]] = pid
        counts[g] += 1
    if dropped:
        raise ValueError(f"group capacity too small: {dropped} postings dropped")
    return members


def build_group_index(state: IndexState, *, n_groups: int, capacity: int,
                      seed: int = 0) -> GroupIndex:
    """Cluster the valid posting centroids into ``n_groups`` balanced
    groups (host-driven; rebuilt after maintenance rounds).  The draw comes
    from a ``torch.Generator`` seeded with ``seed`` on the state's device,
    so it is not the reference's ``jax.random`` draw."""
    gen = torch.Generator(device=state.device)
    gen.manual_seed(seed)
    cen, assign = balanced_kmeans(
        state.centroids, state.centroid_valid, k=n_groups, generator=gen,
        iters=10, balance_weight=2.0,
    )
    members = torch.as_tensor(place_members(
        assign.cpu().numpy(), state.centroid_valid.cpu().numpy(), n_groups, capacity,
    )).to(state.device)
    cen = cen.float()
    return GroupIndex(
        group_centroids=cen,
        group_sqn=torch.sum(cen * cen, dim=-1),
        members=members,
        member_valid=members >= 0,
    )


def _level2(state: IndexState, gidx: GroupIndex, queries, top_g, nprobe: int):
    """Exact distances to the members of each query's groups, then the
    ``nprobe`` nearest (lowest candidate index first among equals)."""
    q = queries.shape[0]
    cand = gidx.members[top_g].reshape(q, -1)          # (Q, gprobe*gamma)
    cand_valid = gidx.member_valid[top_g].reshape(q, -1)
    safe = torch.clamp(cand, min=0).long()
    c = state.centroids[safe]                          # (Q, gprobe*gamma, d)
    diff = queries.float()[:, None, :] - c.float()
    d = torch.sum(diff * diff, dim=-1)
    live = cand_valid & state.centroid_valid[safe]
    d = torch.where(live, d, MASK_DISTANCE)
    top_d, sel = stable_topk(d, nprobe)
    pids = torch.gather(cand, 1, sel)
    return top_d, torch.where(top_d < MASK_DISTANCE / 2, pids, -1).to(torch.int32)


def navigate_grouped(state: IndexState, gidx: GroupIndex, queries, *,
                     nprobe: int, gprobe: int):
    """Two-level nearest-``nprobe`` postings ``(dists (Q, nprobe), pids
    (Q, nprobe))``.  Same interface as ``lire.navigate``; exact when
    ``gprobe`` is the number of groups."""
    queries = queries.float()
    dg = pairwise_sql2(queries, gidx.group_centroids, gidx.group_sqn)
    any_member = torch.any(gidx.member_valid, dim=1)
    _, top_g = masked_topk(dg, any_member[None, :], gprobe)   # (Q, gprobe)
    per_query = gprobe * gidx.members.shape[1] * queries.shape[1]
    step = max(1, _GATHER_ELEMS // per_query)
    parts = [_level2(state, gidx, queries[s:s + step], top_g[s:s + step], nprobe)
             for s in range(0, queries.shape[0], step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def search_grouped(state: IndexState, gidx: GroupIndex, queries, *, k: int,
                   nprobe=None, gprobe: int = 8, probe_chunk: int = 0,
                   use_pallas_scan=None, scan_schedule=None):
    """``lire.search`` with two-level navigation.  The scan + reduce is the
    shared ``lire.scan_and_reduce``, so the paged scan kernels, the batch
    dedup schedule and probe chunking all apply here too."""
    nprobe = nprobe or state.cfg.nprobe
    nav_d, pids = navigate_grouped(state, gidx, queries, nprobe=nprobe, gprobe=gprobe)
    return lire.scan_and_reduce(
        state, queries, pids, nav_d < MASK_DISTANCE / 2, k=k,
        probe_chunk=probe_chunk, use_pallas_scan=use_pallas_scan,
        scan_schedule=scan_schedule,
    )
