"""spfresh-1b — the paper's own architecture at billion scale.

Document-sharded SPFresh: one LIRE shard per device (256 on the
single-pod 16×16 mesh, 512 on the 2×16×16 multi-pod mesh).  One shard holds
~2M live vectors (≈8M replica slots) with int8 payloads: 256 shards ≈ 0.5B,
512 ≈ 1.1B vectors.  This module carries the per-shard configs, the service
spec (whose ``n_shards`` / ``n_replicas`` open a sharded and replicated
service) and the five cells, the paper's §5 serving steps over the
distributed layer's steps on a list of per-shard states:

  * ``serve_search`` — Q=1,024 queries, k=10, nprobe=64, at ``CONFIG``;
  * ``serve_search_paged`` — the same at ``CONFIG_PAGED`` (the batched
    page-dedup kernel scan, a 32,768-page budget);
  * ``serve_search_grouped`` — the two-level router: 512 groups of at most
    256 centroids a shard, the 32 nearest groups probed;
  * ``serve_update`` — B=4,096 inserts routed to their owner shard;
  * ``maintain`` — one Local-Rebuilder round (``jobs_per_round`` splits and
    merges) on every shard.

Each step reads its geometry from the states it is given (``nprobe``,
``jobs_per_round``, the scan flags of the search cells that take none),
so a smaller config runs the same step.  A step returns what the call it
wraps returns and changes no input: the search cells ``(dists (Q, k),
handles (Q, k))``, ``serve_update`` ``(states, handles (B,))``,
``maintain`` ``(states, jobs done)``; a handle is ``shard ·
num_vectors_cap + vid``.  ``maintain``'s step takes the round's ``draw=``
as ``sharded_maintenance_round`` does.  ``make_mesh_step`` gives the
program of one device: its one shard's state and the replicated queries
or update batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.common import F32, Cell, _sds
from repro_torch.core.types import LireConfig, make_empty_state

CONFIG = LireConfig(
    dim=100,                      # SPACEV byte vectors
    block_size=32,
    max_blocks_per_posting=4,     # posting capacity 128
    num_blocks=262_144,           # 838 MB int8 payload / device
    num_postings_cap=65_536,
    num_vectors_cap=4_194_304,    # 4M handles / shard
    vector_dtype="int8",
    scan_dtype="bfloat16",
    split_limit=96,
    merge_limit=12,
    merge_fanout=4,
    reassign_range=64,            # paper default (Fig. 11)
    reassign_budget=256,
    replica_count=4,
    replica_rng=1.15,
    nprobe=64,                    # paper: search nearest 64 postings
    jobs_per_round=8,
    maintain_policy="drift",
    maintain_alpha=4.0,
    maintain_beta=1.0,
)

SMOKE = LireConfig(
    dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=1024,
    num_postings_cap=128, num_vectors_cap=4096, split_limit=48,
    merge_limit=6, merge_fanout=4, reassign_range=8, reassign_budget=128,
    replica_count=2, nprobe=8, jobs_per_round=4,
)

SEARCH_Q = 1024   # queries per search micro-batch
UPDATE_B = 4096   # rows per insert batch
PROBE_CHUNK = 0

# The production search path: batch-dedup paged scan with a static page
# budget (overflow drops the highest-numbered pages, counted by
# ``dedup_pages``).
CONFIG_PAGED = dataclasses.replace(
    CONFIG,
    use_pallas_scan=True,
    scan_schedule="batched",
    scan_page_budget=32_768,
)


# ---------------------------------------------------------------------------
# Service specs — the deployable description of this architecture for
# `repro_torch.api.open` (the serving knobs live here, next to the geometry
# they tune).
# ---------------------------------------------------------------------------

def service_spec(*, paged: bool = True, smoke: bool = False,
                 n_shards: int = 1, durable_root: str | None = None,
                 n_replicas: int = 1, max_lag: int = 64):
    """The production ServiceSpec for spfresh-1b (or its smoke twin).

    ``repro_torch.api.open(service_spec(smoke=True), vectors=...)`` stands
    up a runnable miniature of the deployment; ``durable_root`` roots its
    WAL and snapshots.  ``n_shards > 1`` partitions the index over that
    many shards; ``n_replicas > 1`` adds read replicas fed by the WAL
    dispatch stream, ``max_lag`` their freshness bound in WAL seqnos
    before a search falls back to the primary.
    """
    from repro_torch import api

    base = SMOKE if smoke else (CONFIG_PAGED if paged else CONFIG)
    return api.ServiceSpec(
        index=api.IndexSpec(config=base),
        serve=api.ServeSpec(search_k=10, nprobe=base.nprobe, max_batch=SEARCH_Q,
                            max_lag=max_lag),
        scan=api.ScanSpec(probe_chunk=PROBE_CHUNK),
        maintenance=api.MaintenanceSpec(
            jobs_per_round=base.jobs_per_round,
            policy=base.maintain_policy,
            alpha=base.maintain_alpha,
            beta=base.maintain_beta,
        ),
        durability=api.DurabilitySpec(root=durable_root),
        shards=api.ShardSpec(n_shards=n_shards, n_replicas=n_replicas),
    )


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

# two-level router geometry: 512 groups of <= 256 centroids per shard;
# queries probe the 32 nearest groups
N_GROUPS = 512
GROUP_CAP = 256
GPROBE = 32

SHAPES = ("serve_search", "serve_search_paged", "serve_search_grouped", "serve_update",
          "maintain")


def _search_step(**kw):
    def step(states, queries, shard_alive, group_indexes=None):
        from repro_torch.distributed.sharded_index import sharded_search

        with torch.no_grad():
            return sharded_search(states, queries, shard_alive, k=10, probe_chunk=PROBE_CHUNK,
                                  group_indexes=group_indexes, **kw)
    return step


def _update_step(states, vecs, valid):
    from repro_torch.distributed.sharded_index import sharded_insert

    with torch.no_grad():
        return sharded_insert(states, vecs, valid)


def _maintain_step(states, *, draw=None):
    from repro_torch.distributed.sharded_index import sharded_maintenance_round

    with torch.no_grad():
        return sharded_maintenance_round(states, states[0].cfg.jobs_per_round, draw=draw)


STEPS = {
    "serve_search": _search_step(),
    "serve_search_paged": _search_step(use_pallas_scan=True, scan_schedule="batched"),
    "serve_search_grouped": _search_step(gprobe=GPROBE),
    "serve_update": _update_step,
    "maintain": _maintain_step,
}


def _group_index_specs(cfg: LireConfig):
    """One shard's group index on ``meta``: ``N_GROUPS`` groups of
    ``GROUP_CAP`` member slots."""
    from repro_torch.core.grouping import GroupIndex

    return GroupIndex(group_centroids=_sds((N_GROUPS, cfg.dim), F32),
                      group_sqn=_sds((N_GROUPS,), F32),
                      members=_sds((N_GROUPS, GROUP_CAP), torch.int32),
                      member_valid=_sds((N_GROUPS, GROUP_CAP), torch.bool))


def _make_mesh_step(shape: str):
    def make(mesh, multi_pod: bool):
        """One device's program: its shard's state (``CONFIG``, or
        ``CONFIG_PAGED`` for the paged cell) as a one-shard list, the
        queries or the update batch replicated.  Every argument is the
        device's own, so each spec is ``None``."""
        cfg = CONFIG_PAGED if shape == "serve_search_paged" else CONFIG
        states = [make_empty_state(cfg, device="meta")]
        alive = _sds((1,), torch.bool)
        if shape == "serve_update":
            args = (states, _sds((UPDATE_B, cfg.dim), F32), _sds((UPDATE_B,), torch.bool))
        elif shape == "maintain":
            args = (states,)
        else:
            args = (states, _sds((SEARCH_Q, cfg.dim), F32), alive)
            if shape == "serve_search_grouped":
                args = (*args, [_group_index_specs(cfg)])
        return STEPS[shape], args, (None,) * len(args)
    return make


def cells() -> list[Cell]:
    return [Cell(arch="spfresh-1b", shape=shape, family="index", kind="serve", model_cfg=CONFIG,
                 smoke_cfg=SMOKE, step_fn=STEPS[shape], make_mesh_step=_make_mesh_step(shape))
            for shape in SHAPES]
