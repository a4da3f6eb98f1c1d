"""ServiceSpec — the one declarative description of a SPFresh service.

Every knob of ``LireConfig``, ``EngineConfig`` and the durability
lifecycle lives in exactly one frozen sub-spec here;
``repro_torch.api.open(spec)`` compiles the spec into a running
:class:`~repro_torch.api.service.Service`.  The sub-specs are the JAX
package's (``repro.api.spec``), field for field, less the mesh axis names
of the distributed deployment (the port places shards and replicas on a
device, not a mesh) and ``ScanSpec.pallas_interpret`` (the port's kernels
have no interpret mode; ``LireConfig`` keeps the field so a stamped
config still compares).

Sub-specs (all frozen dataclasses, composable with ``dataclasses.replace``):

  * :class:`IndexSpec`       — the LIRE protocol + storage geometry
                               (wraps :class:`~repro_torch.core.types.LireConfig`)
  * :class:`ScanSpec`        — the posting-scan data path flags
  * :class:`ServeSpec`       — micro-batching + maintenance policy
                               (compiles to ``EngineConfig``)
  * :class:`MaintenanceSpec` — Local-Rebuilder round shape / budget
  * :class:`DurabilitySpec`  — WAL dir, snapshot dir, checkpoint cadence
  * :class:`ShardSpec`       — shard and read-replica counts
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.core.types import LireConfig


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Index geometry + LIRE protocol parameters.

    ``config`` is the full :class:`LireConfig`; ``seed`` seeds the offline
    SPANN build.  Scan/maintenance fields of the config are *defaults* —
    the sibling :class:`ScanSpec` / :class:`MaintenanceSpec` override them
    (``ServiceSpec.lire_config()`` folds everything into one config).
    """

    config: LireConfig = LireConfig()
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """Posting-scan data path.

    ``None`` means "defer to ``IndexSpec.config``" for the tri-state
    flags; ``probe_chunk`` is an engine-side knob (oracle path only).
    """

    probe_chunk: int = 0
    use_pallas_scan: bool | None = None
    scan_schedule: str | None = None       # "per_query" | "batched" | None
    scan_page_budget: int | None = None
    # Posting payload codec (storage/codec.py): "fp32" | "bf16" | "int8";
    # None defers to IndexSpec.config.  Lossy codecs over-fetch
    # rerank_factor×k quantized candidates and rerank them against the
    # exact tier.
    codec: str | None = None
    rerank_factor: int | None = None


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Micro-batching + maintenance scheduling (compiles to EngineConfig)."""

    search_k: int = 10
    nprobe: int | None = None
    max_batch: int = 256
    min_bucket: int = 8
    policy: str = "ratio"                  # "ratio" | "backlog"
    fg_bg_ratio: int = 2
    backlog_threshold: int = 1
    max_insert_retries: int = 4
    # --- async serving (background pump thread; see serve/engine.py) ---
    # async_serve=True: the engine owns a dedicated pump thread; callers
    # only enqueue and block on per-ticket events, maintenance runs in
    # queue-idle gaps, and durable update tickets ack after the WAL
    # fsync.  max_wait_ms is the batch-formation window (async only).
    async_serve: bool = False
    max_wait_ms: float = 0.0
    # --- read replicas (serve/engine.py + distributed/replication.py) ---
    # With ShardSpec.n_replicas > 1 the pump routes search batches to
    # replica workers round-robin; max_lag is the freshness bound (a
    # replica more than max_lag WAL seqnos behind the primary is skipped
    # and the batch falls back to the primary), replica_inflight caps the
    # routed-but-unfinished batches a single replica may hold.
    max_lag: int = 64
    replica_inflight: int = 2


@dataclasses.dataclass(frozen=True)
class MaintenanceSpec:
    """Local-Rebuilder round shape.  ``None`` defers to IndexSpec.config."""

    jobs_per_round: int | None = None      # split/merge jobs per fused round
    merge_fanout: int | None = None
    reassign_budget: int | None = None
    maintain_budget: int | None = None     # jobs per background SLOT
                                           # (None -> jobs_per_round)
    # Job selection: "size" (top-K longest / bottom-K shortest) or
    # "drift" (Ada-IVF-style cost model over the per-posting telemetry).
    # None defers to IndexSpec.config; alpha/beta weigh the access-rate
    # and drift terms.
    policy: str | None = None              # "size" | "drift"
    alpha: float | None = None
    beta: float | None = None


@dataclasses.dataclass(frozen=True)
class DurabilitySpec:
    """Crash-recovery lifecycle: WAL + snapshot checkpoints.

    ``root=None`` disables durability (an ephemeral service).  With a
    root, every update dispatch is WAL-appended (fsync'd) before it runs,
    ``checkpoint()`` writes an atomic snapshot stamping the applied WAL
    seqno and truncates the log, and ``open`` replays snapshot + WAL tail.
    ``checkpoint_every=N`` auto-checkpoints (full base snapshot) after
    every N update rows (0 = manual/close only).

    The durability **fast path** (paper §4.4's block-granular
    copy-on-write):

    * ``delta_every=N`` — every N update rows, auto-checkpoint as a
      **delta** snapshot: only the blocks the pool's dirty bitmap marked
      since the last unit, chained to the base.  Checkpoint bytes scale
      with churn, not index size.
    * ``compact_every=M`` — once M deltas stack on the base, the next
      delta-cadence checkpoint is promoted to a compaction: a fresh full
      base folds the chain and prunes it (0 = never auto-compact).
    * ``group_commit=N`` (+ ``group_commit_ms``) — batch up to N update
      dispatches per WAL fsync.  The ack point does not move: the service
      forces a sync before an update call returns, so one fsync covers
      every dispatch that ran inside the call (retries, interleaved
      maintenance, ``insert_bulk`` chunks).
    * ``compact_wal=True`` — on recovery, mask insert rows whose vids
      were later deleted before replaying (preserves the live set and
      version map, not the physical block layout — see
      ``storage.wal.compact_wal_records``).
    """

    root: str | None = None
    wal_dir: str | None = None             # default: <root>/wal
    snapshot_dir: str | None = None        # default: <root>/snapshot
    checkpoint_every: int = 0
    snapshot_on_open: bool = True          # durability point for the build
    checkpoint_on_close: bool = True
    # --- durability fast path ---
    delta_every: int = 0                   # rows per auto DELTA checkpoint
    compact_every: int = 16                # deltas per chain before re-base
    group_commit: int = 0                  # dispatches per WAL fsync window
    group_commit_ms: float = 0.0           # window age-out (0 = count only)
    compact_wal: bool = False              # replay-side WAL compaction

    @property
    def enabled(self) -> bool:
        return bool(self.root or (self.wal_dir and self.snapshot_dir))

    def resolved_wal_dir(self) -> str:
        assert self.enabled
        return self.wal_dir or os.path.join(self.root, "wal")

    def resolved_snapshot_dir(self) -> str:
        assert self.enabled
        return self.snapshot_dir or os.path.join(self.root, "snapshot")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Shard and replica counts.  ``n_shards=1`` selects the single-index
    backend; ``n_shards > 1`` the sharded one (``distributed/
    sharded_index.py``), its shards partitioned in centroid space.

    ``n_replicas > 1`` adds read replicas: ``n_replicas`` full copies of
    the index, the primary (copy 0) alone running the WAL-append +
    dispatch order, and every logged dispatch streamed to the others
    through a bounded window replayed in seqno order (``distributed/
    replication.py``).  Replication composes with sharding.  Every shard
    of every copy lives on the one device ``open`` is given.
    """

    n_shards: int = 1
    n_replicas: int = 1


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """The whole service, declaratively.  See ``repro_torch.api.open``."""

    index: IndexSpec = IndexSpec()
    serve: ServeSpec = ServeSpec()
    scan: ScanSpec = ScanSpec()
    maintenance: MaintenanceSpec = MaintenanceSpec()
    durability: DurabilitySpec = DurabilitySpec()
    shards: ShardSpec = ShardSpec()

    @property
    def sharded(self) -> bool:
        return self.shards.n_shards > 1

    @property
    def replicated(self) -> bool:
        return self.shards.n_replicas > 1

    # ------------------------------------------------------------------
    def lire_config(self) -> LireConfig:
        """IndexSpec.config with the scan/maintenance overrides folded in —
        the ONE config the backend and every dispatch see."""
        over: dict = {}
        s, m = self.scan, self.maintenance
        for field, value in (
            ("use_pallas_scan", s.use_pallas_scan),
            ("scan_schedule", s.scan_schedule),
            ("scan_page_budget", s.scan_page_budget),
            ("codec", s.codec),
            ("rerank_factor", s.rerank_factor),
            ("jobs_per_round", m.jobs_per_round),
            ("merge_fanout", m.merge_fanout),
            ("reassign_budget", m.reassign_budget),
            ("maintain_policy", m.policy),
            ("maintain_alpha", m.alpha),
            ("maintain_beta", m.beta),
        ):
            if value is not None:
                over[field] = value
        cfg = dataclasses.replace(self.index.config, **over) if over \
            else self.index.config
        cfg.validate()
        return cfg

    def engine_config(self):
        """Compile serve+scan+maintenance into the pipeline's EngineConfig."""
        from repro_torch.serve.engine import EngineConfig

        cfg = self.lire_config()
        sv, sc, mt = self.serve, self.scan, self.maintenance
        return EngineConfig(
            search_k=sv.search_k,
            nprobe=sv.nprobe,
            probe_chunk=sc.probe_chunk,
            use_pallas_scan=sc.use_pallas_scan,
            scan_schedule=sc.scan_schedule,
            max_batch=sv.max_batch,
            min_bucket=sv.min_bucket,
            policy=sv.policy,
            fg_bg_ratio=sv.fg_bg_ratio,
            maintain_budget=(
                mt.maintain_budget
                if mt.maintain_budget is not None
                else cfg.jobs_per_round
            ),
            backlog_threshold=sv.backlog_threshold,
            max_insert_retries=sv.max_insert_retries,
            async_serve=sv.async_serve,
            max_wait_ms=sv.max_wait_ms,
            max_lag=sv.max_lag,
            replica_inflight=sv.replica_inflight,
        )

    def validate(self) -> None:
        self.lire_config()  # folds + validates
        if self.shards.n_shards < 1 or self.shards.n_replicas < 1:
            raise ValueError(f"shard and replica counts must be >= 1: {self.shards}")
        checks = [
            (self.serve.policy in ("ratio", "backlog"), f"serve.policy {self.serve.policy!r}"),
            (self.serve.max_wait_ms >= 0, "serve.max_wait_ms >= 0"),
            (self.serve.max_lag >= 0, "serve.max_lag >= 0"),
            (self.serve.replica_inflight >= 1, "serve.replica_inflight >= 1"),
            (self.durability.checkpoint_every >= 0, "checkpoint_every >= 0"),
            (self.durability.delta_every >= 0 and self.durability.compact_every >= 0,
             "delta_every, compact_every >= 0"),
            (self.durability.group_commit >= 0 and self.durability.group_commit_ms >= 0,
             "group_commit, group_commit_ms >= 0"),
            (self.scan.scan_schedule in (None, "per_query", "batched"),
             f"scan.scan_schedule {self.scan.scan_schedule!r}"),
            (self.scan.codec in (None, "fp32", "bf16", "int8"), f"scan.codec {self.scan.codec!r}"),
            (self.scan.rerank_factor is None or self.scan.rerank_factor >= 1,
             "scan.rerank_factor >= 1"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid ServiceSpec: {what}")
        dur = self.durability
        if dur.root is None and (dur.wal_dir is None) != (dur.snapshot_dir is None):
            # Half-configured durability would silently run ephemeral.
            raise ValueError(
                "DurabilitySpec needs BOTH wal_dir and snapshot_dir (or "
                "just root); only one of them configures nothing"
            )

    # ------------------------------------------------------------------
    def with_durability(self, root: str, **kw) -> "ServiceSpec":
        """Convenience: the same service, durably rooted at ``root``."""
        return dataclasses.replace(
            self, durability=dataclasses.replace(
                self.durability, root=root, **kw
            )
        )

    def with_shards(self, n_shards: int, **kw) -> "ServiceSpec":
        """Convenience: the same service over ``n_shards`` shards."""
        return dataclasses.replace(
            self, shards=dataclasses.replace(self.shards, n_shards=n_shards, **kw)
        )

    def with_replicas(self, n_replicas: int, *, max_lag: int | None = None,
                      ) -> "ServiceSpec":
        """Convenience: the same service with ``n_replicas`` copies in all
        (the primary and ``n_replicas - 1`` read replicas)."""
        serve = self.serve if max_lag is None else dataclasses.replace(
            self.serve, max_lag=max_lag
        )
        return dataclasses.replace(
            self,
            serve=serve,
            shards=dataclasses.replace(self.shards, n_replicas=n_replicas),
        )
