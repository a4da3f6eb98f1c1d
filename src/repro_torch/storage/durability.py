"""DurableBackend — the one durability lifecycle the index backend mixes in
(paper §4.4 promoted into the ``IndexBackend`` protocol).

The lifecycle invariants live HERE exactly once: the not-while-replaying
logging guard, applied-seqno bookkeeping, checkpoint = snapshot (stamping
per-shard ``wal_seqnos`` + the replay-critical ``lire_config``) then WAL
truncate, and the replay loop that re-applies a dispatch stream through
the subclass's ``_apply_record``.  Backends supply only what differs: the
state to snapshot, manifest extras, the per-op dispatch arms, and the
shard count.

Checkpoints go through :class:`~repro_torch.storage.snapshot.SnapshotStore`:
``checkpoint(dir)`` writes a full **base** unit (which is also the chain
compaction — the in-memory state already equals base + deltas + dirty
tail, so folding is a fresh full write that prunes the old chain), while
``checkpoint(dir, delta=True)`` writes a **delta** unit holding only the
blocks the pool's dirty bitmap marked since the previous unit.  Either way
the backend's in-memory state is swapped for the dirty-cleared twin
afterwards, so the next delta starts from a clean ledger, and the WALs
restart empty only after the unit commits.

On the card the checkpoint's device-to-host copies are queued on the
calling thread's current stream.  No thread of the port sets a stream, so
the serving engine's pump and a caller under ``engine.exclusive()`` share
the device's default stream: the copies run after every dispatch the pump
has queued, and a deferred search readback still in flight (its copy to
pinned memory queued before them) is left as it is — the checkpoint
writes no tensor that search reads; it installs a new ``dirty`` tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.storage.blockpool import clear_dirty
from repro_torch.storage.snapshot import SnapshotStore


@dataclasses.dataclass(frozen=True)
class Record:
    """One logged update dispatch: its seqno, op and payload arrays."""

    seqno: int
    op: str
    payload: dict[str, Any]


class DurableBackend:
    """Mixin for backends with dispatch-level WAL + snapshot recovery.

    Subclass hooks:
      * ``_snapshot_state()``  — the state the checkpoint serializes (a
                                 list of per-shard states for a sharded
                                 backend)
      * ``_set_snapshot_state(state)`` — install the dirty-cleared state
      * ``_snapshot_extra()``  — backend-specific manifest fields
      * ``_apply_record(rec)`` — re-run one logged dispatch (replay arms)
      * ``_wal_shards``        — logs in the WalSet (1 for local)
      * ``_lire_config()``     — config stamped into the manifest
    """

    wal_set = None
    _wal_applied = -1
    _replaying = False
    _repl_sink = None

    # ------------------------- subclass hooks --------------------------
    def _snapshot_state(self):
        raise NotImplementedError

    def _set_snapshot_state(self, state) -> None:
        raise NotImplementedError

    def _snapshot_extra(self) -> dict:
        return {}

    def _apply_record(self, rec) -> None:
        raise NotImplementedError

    def _lire_config(self):
        raise NotImplementedError

    @property
    def _wal_shards(self) -> int:
        return 1

    # ------------------------- the lifecycle ---------------------------
    def _log(self, op: str, payload: dict) -> None:
        if self._replaying:
            return
        if self.wal_set is not None:
            self._wal_applied = self.wal_set.append(op, payload)
        if self._repl_sink is not None:
            if self.wal_set is None:
                # no durable log: mint the contiguous seqnos replicas need
                self._wal_applied += 1
            self._repl_sink.publish(self._wal_applied, op, payload)

    def attach_replication(self, sink) -> None:
        """``sink.publish(seqno, op, payload)`` is called for every logged
        update dispatch, AFTER the WAL append assigns its seqno (so a
        published record is already in the log when durability is on),
        and before the dispatch runs.  The sink must be cheap and
        non-blocking: it runs on the serialized pump thread."""
        self._repl_sink = sink

    def attach_durability(self, wal_set, applied_seqno: int | None = None) -> None:
        """``applied_seqno`` is the seqno this backend's state already
        reflects — the snapshot manifest stamp on recovery.  The default
        (last durable record) is ONLY correct when the state genuinely
        includes everything on disk (a fresh build about to checkpoint);
        recovery paths must pass the stamp or a later checkpoint would
        mark the unreplayed tail as applied."""
        if wal_set.n_shards != self._wal_shards:
            raise ValueError(f"a WalSet of {wal_set.n_shards} logs for a backend of "
                             f"{self._wal_shards} shards")
        self.wal_set = wal_set
        self._wal_applied = (
            applied_seqno if applied_seqno is not None
            else wal_set.next_seqno - 1
        )

    def wal_seqnos(self) -> list[int]:
        """Applied WAL seqno per shard (the snapshot manifest entry).
        The snapshot is one atomic commit, so shards advance together."""
        return [self._wal_applied] * self._wal_shards

    def wal_sync(self) -> None:
        """Force any group-commit-buffered WAL records durable — the ack
        point the service crosses before returning an update."""
        if self.wal_set is not None:
            self.wal_set.sync()

    def checkpoint(self, snapshot_dir: str, *, delta: bool = False) -> str:
        """Atomic snapshot unit stamping the applied WAL seqnos and the
        replay-critical config; the WALs restart empty only after the
        unit commit.  ``delta=True`` writes an incremental unit (dirty
        blocks + non-block leaves, per shard) chained onto the store's
        head; it promotes to a full base when no chain exists yet.
        Afterwards the in-memory state is the dirty-cleared twin.  Returns
        the unit written."""
        if self.wal_set is not None:
            self.wal_set.sync()    # buffered records precede the stamp
        store = SnapshotStore(snapshot_dir)
        state = self._snapshot_state()
        if isinstance(state, list):         # one state per shard
            cleared = [st.replace(pool=clear_dirty(st.pool)) for st in state]
        else:
            cleared = state.replace(pool=clear_dirty(state.pool))
        extra = {
            "wal_seqnos": self.wal_seqnos(),
            "lire_config": dataclasses.asdict(self._lire_config()),
            **self._snapshot_extra(),
        }
        if delta and store.has_base():
            unit = store.save_delta(state, n_shards=self._wal_shards, extra=extra)
        else:
            unit = store.save_base(cleared, extra=extra)
        self._set_snapshot_state(cleared)
        if self.wal_set is not None:
            self.wal_set.truncate()
        return unit

    def replay(self, records, after_seqno: int = -1) -> int:
        """Re-apply a dispatch stream (``WalRecord`` / ``Record``-like
        objects with ``seqno``, ``op`` and ``payload``) through the
        backend's own entry points; returns how many records were
        applied."""
        n = 0
        self._replaying = True
        try:
            for rec in records:
                if rec.seqno <= after_seqno:
                    continue
                self._apply_record(rec)
                self._wal_applied = rec.seqno
                n += 1
        finally:
            self._replaying = False
        return n

    def close(self) -> None:
        if self.wal_set is not None:
            self.wal_set.close()


class RecordingSink:
    """A replication sink that keeps every published dispatch in memory
    (payload arrays copied), in seqno order — a stream ``replay`` takes."""

    def __init__(self):
        self.records: list[Record] = []

    def publish(self, seqno: int, op: str, payload: dict) -> None:
        self.records.append(Record(seqno, op, {k: np.array(v) for k, v in payload.items()}))


# Geometry/protocol fields that must match between a snapshot and the
# opening spec: they shape the state or change update-dispatch semantics,
# so replay under a different value is undefined.  Every LireConfig field
# is classified here or in REPLAY_EXEMPT_FIELDS below.
REPLAY_CRITICAL_FIELDS = (
    "dim", "block_size", "max_blocks_per_posting", "num_blocks",
    "num_postings_cap", "num_vectors_cap", "vector_dtype",
    "split_limit", "merge_limit", "merge_fanout",
    "reassign_range", "reassign_budget", "replica_count", "replica_rng",
    "kmeans_iters", "enable_split", "enable_merge", "enable_reassign",
    # Job SELECTION shapes which postings every logged maintenance round
    # touches, so replaying under a different policy/weighting diverges.
    "maintain_policy", "maintain_alpha", "maintain_beta",
    # The payload codec changes the hot-tier dtype/leaf structure and the
    # rerank factor changes which candidates a logged search would have
    # returned; both are stamped by name so pre-codec snapshots (which
    # never stamped them) still pass.
    "codec", "rerank_factor",
    # Insert/reassign ROUTING runs through `lire.navigate`, whose data
    # path (the l2_topk kernel vs the matmul + stable top-k oracle) these
    # select.  The paths agree only up to top-k tie-breaking on equal
    # distances — enough to route a vector to a different posting on
    # replay — so they must match the snapshot.
    "use_pallas_nav", "pallas_interpret",
)

# Serving-side fields a reopened index may change freely: they only
# shape dispatches that are never WAL-logged (searches) or whose logged
# records carry the value they ran with.
REPLAY_EXEMPT_FIELDS = (
    # Search-path only; search dispatches are not WAL-logged.
    "nprobe", "scan_dtype", "use_pallas_scan", "scan_schedule",
    "scan_page_budget",
    # Logged "maintain"/"drain" records carry their own job counts, so
    # replay re-runs the original round shapes regardless of the
    # reopened config's default.
    "jobs_per_round",
)


def check_replay_config(manifest: dict, cfg, *, n_shards: int | None = None) -> None:
    """Raise a clear error when a snapshot was written under a different
    replay-critical config than the spec now opening it — BEFORE a state
    is built from it and the drift turns into a cryptic leaf-shape
    mismatch."""
    extra = manifest.get("extra", {})
    diffs = []
    if n_shards is not None:
        stamped_shards = extra.get("n_shards", 1)
        if stamped_shards != n_shards:
            diffs.append(
                f"n_shards: snapshot={stamped_shards!r} spec={n_shards!r}"
            )
    stamped = extra.get("lire_config")
    if stamped is None and not diffs:
        return  # pre-stamp snapshot: nothing to validate against
    if stamped is not None:
        now = dataclasses.asdict(cfg)
        diffs += [
            f"{f}: snapshot={stamped[f]!r} spec={now[f]!r}"
            for f in REPLAY_CRITICAL_FIELDS
            if f in stamped and stamped[f] != now[f]
        ]
    if diffs:
        raise ValueError(
            "snapshot was written under a different index config; "
            "recovery must reuse the original geometry/protocol "
            "parameters (re-open with the original config or point "
            "DurabilitySpec at a fresh root).  Mismatched fields:\n  "
            + "\n  ".join(diffs)
        )
