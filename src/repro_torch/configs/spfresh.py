"""spfresh-1b per-shard geometry — the paper's SPACEV1B regime.

One LIRE shard holds ~2M live vectors (≈8M replica slots) with int8
payloads.  The reference's shard-mesh dry-run cells are not ported; this
module carries the per-shard configs, the serving step shapes and the
service spec (whose ``n_shards`` / ``n_replicas`` open a sharded and
replicated service).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import LireConfig

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
