"""``repro_torch.api.open(spec)`` — one durable serving lifecycle.

``open`` compiles a :class:`~repro_torch.api.spec.ServiceSpec` into a
running :class:`Service`: it builds (or crash-recovers) the index on the
card, stands the micro-batched ServeEngine in front of it, and wires the
durability lifecycle (WAL + snapshot checkpoints) into the backend.

Lifecycle::

    open(spec, vectors=...)           # fresh build; durable roots get an
                                      #   open-time snapshot (the build's
                                      #   durability point) + an empty WAL
    svc.search / insert / delete      # updates are WAL-appended per
                                      #   dispatch before they run; under
                                      #   group_commit the fsync is forced
                                      #   before the call returns (ack)
    svc.insert_bulk(...)              # many dispatches, ONE fsync
    svc.checkpoint()                  # flush + atomic snapshot unit
                                      #   (delta when the spec enables
                                      #   them, else full base) stamping
                                      #   the wal_seqnos + WAL truncate
    svc.close()                       # flush (+ final checkpoint)

    open(spec)                        # after a crash: latest snapshot +
                                      #   WAL replay through the backend's
                                      #   own dispatches

Replay is bit-deterministic: the WAL records *dispatches* (padded arrays,
masks, maintenance rounds) rather than requests, and every dispatch is a
deterministic function of (state, batch) — so a recovered service holds
the same state, leaf for leaf, as the uncrashed one.

The same spec (modulo :class:`~repro_torch.api.spec.ShardSpec`) opens a
single-index service or an N-shard one (``distributed/sharded_index.py``:
one WAL per shard, one stacked snapshot unit), with ``n_replicas - 1``
read replicas cloned from the primary after recovery and fed by its
dispatch stream (``distributed/replication.py``).  Every shard and
replica lives on ``device``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.spec import ServiceSpec
from repro_torch.convert import fill_state
from repro_torch.core.index import SPFreshIndex
from repro_torch.core.types import make_empty_state
from repro_torch.distributed.replication import ReplicaSet
from repro_torch.distributed.sharded_index import ShardedIndex
from repro_torch.distributed.sharding import replica_layout
from repro_torch.serve.engine import LocalBackend, ServeEngine
from repro_torch.storage.durability import check_replay_config
from repro_torch.storage.snapshot import SnapshotStore
from repro_torch.storage.wal import WalSet, compact_wal_records
from repro_torch.utils.tree import tensor_leaves


class Service:
    """A running SPFresh service: the stable serving surface.

    Thin by design — all state transitions live in the backend's
    dispatches; the service owns the lifecycle (queue flush, checkpoint
    cadence, close) and the spec that created it.  ``recovery`` holds the
    timings of the recovery that opened it (None for a build), and
    ``last_checkpoint`` the unit, bytes and seconds of the latest
    checkpoint.
    """

    def __init__(
        self,
        spec: ServiceSpec,
        engine: ServeEngine,
        *,
        initial_handles: np.ndarray | None = None,
        recovered: bool = False,
        recovery: dict | None = None,
    ):
        self.spec = spec
        self.engine = engine
        self.initial_handles = initial_handles
        self.recovered = recovered
        self.recovery = recovery
        self.last_checkpoint: dict | None = None
        self._updates_since_ckpt = 0
        self._updates_since_delta = 0
        self._closed = False
        self._store = (
            SnapshotStore(spec.durability.resolved_snapshot_dir())
            if spec.durability.enabled else None
        )

    # ------------------------------ serving ----------------------------
    @property
    def backend(self) -> LocalBackend | ShardedIndex:
        return self.engine.backend

    @property
    def index(self) -> SPFreshIndex | None:
        """The single index (None on the sharded backend)."""
        return self.engine.index

    @property
    def replicas(self) -> ReplicaSet | None:
        """The bound ReplicaSet (None when ``n_replicas == 1``)."""
        return self.engine.replicas

    def search(
        self, queries: np.ndarray, *, k: int | None = None,
        nprobe: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.engine.search(queries, k=k, nprobe=nprobe)

    def insert(self, vecs: np.ndarray, vids: np.ndarray | None = None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """Returns ``(ids, landed)``.  The sharded backend assigns its own
        ``(shard, slot)`` handles — pass ``vids=None`` there; the single
        index keys the version map by caller vids, so they are required."""
        vecs = np.asarray(vecs, np.float32)
        vids = self._resolve_vids(vecs, vids)
        ids, landed = self.engine.submit_insert(vecs, vids).result()
        self._wal_ack()
        self._note_updates(len(vecs))
        return ids, landed

    def insert_bulk(
        self, vecs: np.ndarray, vids: np.ndarray | None = None,
        *, chunk: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Group-commit fast path: submit every ``chunk``-row micro-batch,
        pump them all, then cross ONE fsync before collecting results —
        many update dispatches share a single durability point while the
        ack-after-fsync contract holds (nothing is returned pre-sync)."""
        vecs = np.asarray(vecs, np.float32)
        vids = self._resolve_vids(vecs, vids)
        chunk = chunk or self.spec.serve.max_batch
        tickets = [
            self.engine.submit_insert(vecs[s:s + chunk], vids[s:s + chunk])
            for s in range(0, len(vecs), chunk)
        ]
        self.engine.pump()
        self._wal_ack()
        outs = [t.result() for t in tickets]
        ids = (np.concatenate([o[0] for o in outs])
               if outs else np.zeros((0,), np.int32))
        landed = (np.concatenate([o[1] for o in outs])
                  if outs else np.zeros((0,), bool))
        self._note_updates(len(vecs))
        return ids, landed

    def _resolve_vids(self, vecs, vids):
        if vids is None:
            if not self.spec.sharded:
                raise ValueError("the local backend requires caller vids")
            return np.full(len(vecs), -1, np.int32)
        return np.asarray(vids, np.int32)

    def delete(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, np.int32)
        self.engine.delete(vids)
        self._wal_ack()
        self._note_updates(len(vids))

    def maintain(self, jobs: int | None = None) -> int:
        """One explicit Local-Rebuilder round (background slots also run
        under the engine's MaintenancePolicy).  Runs under the engine's
        exclusive lock so it serializes against the async pump thread's
        dispatches (one WAL append + dispatch order)."""
        self.flush()
        with self.engine.exclusive():
            jobs_done = self.backend.maintain(
                jobs or self.engine.policy.budget
            )
            self._wal_ack_locked()
        return jobs_done

    def drain(self) -> int:
        """Flush the queue and run the rebuilder to quiescence."""
        jobs = self.engine.drain()
        self._wal_ack()
        return jobs

    # ----------------------------- lifecycle ---------------------------
    @property
    def durable(self) -> bool:
        return self.spec.durability.enabled

    def flush(self) -> int:
        """Process every queued micro-batch; returns batches pumped.
        Crosses the group-commit ack point: every ticket resolvable
        after a flush is backed by fsync'd WAL records."""
        n = self.engine.pump()
        self._wal_ack()
        return n

    def checkpoint(self, delta: bool | None = None) -> None:
        """Flush, then commit an atomic snapshot unit stamping the applied
        WAL seqno; the WAL restarts empty after the commit.

        ``delta=None`` (default) picks the cheapest correct unit: a delta
        when the spec enables them (``delta_every > 0``), a base exists,
        and the chain is shorter than ``compact_every`` — otherwise a
        full base, which also folds + prunes the chain (compaction).
        ``delta=True``/``False`` force the choice (a forced delta still
        promotes to a base over an empty store)."""
        if not self.durable:
            raise RuntimeError("checkpoint() on a service with no "
                               "DurabilitySpec root")
        self.flush()
        dur = self.spec.durability
        store = self._store
        if delta is None:
            # Cadence POLICY lives here (the spec's knobs); the backend's
            # checkpoint() owns only the mechanics, incl. demoting a
            # forced delta over an empty store to a base.
            delta = (
                dur.delta_every > 0
                and store.has_base()
                and (dur.compact_every == 0
                     or store.chain_len() < dur.compact_every)
            )
        t0 = time.perf_counter()
        with self.engine.exclusive():
            unit = self.backend.checkpoint(
                dur.resolved_snapshot_dir(), delta=bool(delta)
            )
        self.last_checkpoint = {
            "unit": unit, "bytes": store.unit_bytes(unit),
            "seconds": time.perf_counter() - t0,
        }
        self._updates_since_ckpt = 0
        self._updates_since_delta = 0

    def _wal_ack(self) -> None:
        """Ack point under group commit: updates return only after their
        WAL records (and everything before them) are fsync'd."""
        if self.durable:
            with self.engine.exclusive():
                self.backend.wal_sync()

    def _wal_ack_locked(self) -> None:
        """``_wal_ack`` for callers already inside ``engine.exclusive()``."""
        if self.durable:
            self.backend.wal_sync()

    def _note_updates(self, rows: int) -> None:
        self._updates_since_ckpt += rows
        self._updates_since_delta += rows
        if not self.durable:
            return
        dur = self.spec.durability
        if (dur.checkpoint_every > 0
                and self._updates_since_ckpt >= dur.checkpoint_every):
            self.checkpoint(delta=False)       # scheduled full re-base
        elif (dur.delta_every > 0
                and self._updates_since_delta >= dur.delta_every):
            self.checkpoint()                  # delta (or due compaction)

    def close(self) -> None:
        """Flush, optionally checkpoint (DurabilitySpec.checkpoint_on_close),
        and release the WAL file handles.  Idempotent."""
        if self._closed:
            return
        self.flush()
        # stop the pump thread BEFORE the final checkpoint/close so no
        # dispatch races the snapshot or lands on a closed WAL
        self.engine.shutdown()
        if self.durable and self.spec.durability.checkpoint_on_close:
            self.checkpoint()
        self.backend.close()
        self._closed = True

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------- observability ------------------------
    def report(self) -> dict:
        rep = self.engine.report()
        rep["durability"] = {
            "durable": self.durable,
            "recovered": self.recovered,
            "recovery": self.recovery,
            "wal_seqnos": (
                self.backend.wal_seqnos() if self.durable else None
            ),
            "updates_since_checkpoint": self._updates_since_ckpt,
            "last_checkpoint": self.last_checkpoint,
        }
        if self.durable:
            if self.backend.wal_set is not None:
                rep["durability"]["wal"] = self.backend.wal_set.stats()
            rep["durability"]["snapshot_chain_len"] = self._store.chain_len()
        return rep

    def stats(self) -> dict:
        return self.engine.stats()

    def backlog(self) -> int:
        return self.backend.backlog()


# ---------------------------------------------------------------------------
# open()
# ---------------------------------------------------------------------------

def _local_backend(spec: ServiceSpec, index: SPFreshIndex) -> LocalBackend:
    return LocalBackend(
        index,
        probe_chunk=spec.scan.probe_chunk,
        use_pallas_scan=spec.scan.use_pallas_scan,
        scan_schedule=spec.scan.scan_schedule,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def open(
    spec: ServiceSpec,
    *,
    vectors: np.ndarray | None = None,
    fresh: bool = False,
    device="cuda",
) -> Service:
    """Open a SPFresh service described by ``spec`` on ``device``.

    * With a durable root whose snapshot exists: **recover** — load the
      snapshot, replay each shard's WAL tail through the backend, and
      resume serving (``vectors`` is ignored; the snapshot is truth).
    * Otherwise **build** from ``vectors`` (required); durable roots get
      an open-time checkpoint so the offline build itself survives a
      crash before the first explicit ``checkpoint()``.

    ``fresh=True`` forces the build path even when a snapshot exists —
    the durable root's previous contents are superseded by the new
    open-time checkpoint (a rebuild, not a recovery).

    The same spec (modulo :class:`ShardSpec`) opens a single-index or an
    N-shard service; read replicas are cloned after recovery, so they
    start bit-identical to the recovered primary.
    """
    spec.validate()
    # row 0 of the layout is the primary's, the others the replicas'
    layout = replica_layout(spec.shards.n_replicas, spec.shards.n_shards, device)
    dev = layout[0][0]
    cfg = spec.lire_config()
    dur = spec.durability
    store = SnapshotStore(dur.resolved_snapshot_dir()) if dur.enabled else None
    can_recover = dur.enabled and not fresh and store.exists()
    if fresh and vectors is None:
        raise ValueError("fresh=True requires vectors to build from")
    if can_recover:
        # Validate the stamped config BEFORE any state is built: a
        # geometry drift must fail with field names, not a leaf-shape
        # mismatch.
        check_replay_config(store.read_manifest(), cfg, n_shards=spec.shards.n_shards)
    if not can_recover and vectors is None:
        raise FileNotFoundError(
            "no snapshot to recover and no vectors to build"
        )

    initial_handles: np.ndarray | None = None
    recovery: dict | None = None
    if spec.sharded:
        kwargs = dict(probe_chunk=spec.scan.probe_chunk, use_pallas_scan=spec.scan.use_pallas_scan,
                      scan_schedule=spec.scan.scan_schedule, jobs_per_round=cfg.jobs_per_round)
        if can_recover:
            backend, manifest = ShardedIndex.restore(
                cfg, dur.resolved_snapshot_dir(), spec.shards.n_shards, device=dev, **kwargs)
            recovery = dict(backend.restore_seconds)
        else:
            backend, initial_handles = ShardedIndex.build(
                cfg, np.asarray(vectors, np.float32), spec.shards.n_shards,
                seed=spec.index.seed, device=dev, **kwargs)
    elif can_recover:
        # the state is filled on the card straight from the snapshot's
        # arrays; the template lives on the meta device
        template = make_empty_state(cfg, device="meta")
        t0 = time.perf_counter()
        leaves, manifest = store.load_arrays(template)
        t1 = time.perf_counter()
        state = fill_state(template, dict(zip(tensor_leaves(template), leaves)), device=dev)
        _sync(dev)
        recovery = {"load_s": t1 - t0, "upload_s": time.perf_counter() - t1,
                    "snapshot_bytes": sum(a.nbytes for a in leaves)}
        del leaves
        backend = _local_backend(spec, SPFreshIndex(state))
    else:
        index = SPFreshIndex.build(
            cfg, np.asarray(vectors, np.float32), seed=spec.index.seed, device=dev
        )
        initial_handles = np.arange(len(vectors), dtype=np.int64)
        backend = _local_backend(spec, index)

    if dur.enabled:
        wal_set = WalSet(dur.resolved_wal_dir(), spec.shards.n_shards)
        if dur.group_commit > 1:
            wal_set.set_group_commit(dur.group_commit, dur.group_commit_ms)
        if recovery is not None:
            t0 = time.perf_counter()
            records = wal_set.recover_records()
            if dur.compact_wal and not spec.sharded:
                # Replay-speed knob: dead insert rows (vid deleted later
                # in the log) never re-land.  Single index only — the
                # sharded stream's handle assignment is positional.
                records, _dropped = compact_wal_records(records)
            after = min(manifest.get("extra", {}).get("wal_seqnos", [-1]))
            # The checkpoint truncated the log: seqno numbering must
            # resume ABOVE the manifest stamp, or the next recovery would
            # skip fresh acknowledged records as already-applied.
            wal_set.ensure_seqno_floor(after)
            backend.attach_durability(wal_set, applied_seqno=after)
            t1 = time.perf_counter()
            n = backend.replay(records, after_seqno=after)
            _sync(dev)
            recovery.update(wal_read_s=t1 - t0, replay_s=time.perf_counter() - t1,
                            replayed_records=n)
        else:
            # Fresh build over a durable root.  Leftover WAL records from
            # a previous incarnation are NOT truncated here: the open-time
            # checkpoint below drops them only AFTER its snapshot commits,
            # so a crash anywhere in this window still recovers the
            # previous incarnation intact (old snapshot + old WAL).
            backend.attach_durability(wal_set)
            if not dur.snapshot_on_open and (
                store.exists()
                or any(s >= 0 for s in wal_set.last_seqnos())
            ):
                raise ValueError(
                    "refusing to rebuild over a non-empty durable root "
                    "with snapshot_on_open=False: the old snapshot/WAL "
                    "would later recover mixed with the new build's "
                    "records (use fresh=True with snapshot_on_open=True, "
                    "or point DurabilitySpec at a clean root)"
                )

    replicas = None
    if spec.replicated:
        # Clone the read replicas AFTER durability attach + replay so a
        # recovered service's replicas start bit-identical to the
        # recovered primary at its applied seqno; attach the publish sink
        # before the engine exists so no logged dispatch can slip past
        # the stream.  Workers start only after bind() (catch-up needs the
        # engine's exclusive lock).
        clones = [backend.clone(row[0]) if spec.sharded else backend.clone()
                  for row in layout[1:]]
        replicas = ReplicaSet(backend, clones, max_lag=spec.serve.max_lag,
                              inflight=spec.serve.replica_inflight)
        backend.attach_replication(replicas)

    engine = ServeEngine(backend, spec.engine_config(), replicas=replicas)
    if replicas is not None:
        replicas.bind(engine)
        replicas.start()
    svc = Service(
        spec, engine, initial_handles=initial_handles,
        recovered=recovery is not None, recovery=recovery,
    )
    if dur.enabled and recovery is None and dur.snapshot_on_open:
        # The offline build is not in the WAL; snapshot it so a crash
        # before the first checkpoint still recovers to a served state
        # (checkpoint also truncates any previous incarnation's WAL —
        # strictly after the new snapshot commits).  Always a FULL base:
        # a fresh rebuild must supersede — never chain onto — whatever
        # delta chain a previous incarnation left in the store.
        svc.checkpoint(delta=False)
    return svc
