"""DurableBackend — the dispatch-stream lifecycle the index backend mixes
in (paper §4.4; the in-memory half of the JAX package's
``storage/durability.py``).

What is here: the not-while-replaying logging guard, applied-seqno
bookkeeping, the replication sink (which, with no WAL attached, is handed
a contiguous seqno per logged dispatch), and the replay loop that
re-applies a dispatch stream through the subclass's ``_apply_record``.
The WAL and the snapshot store are not ported yet: ``attach_durability``
and ``checkpoint`` raise until the durability slice lands, and
``wal_sync`` / ``close`` have no log to act on.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

_NOT_YET = ("the write-ahead log and snapshots are not ported yet: they come "
            "with the durability slice (storage/wal.py, snapshot.py)")


@dataclasses.dataclass(frozen=True)
class Record:
    """One logged update dispatch: its seqno, op and payload arrays."""

    seqno: int
    op: str
    payload: dict[str, Any]


class DurableBackend:
    """Mixin for backends with a replayable update-dispatch stream.

    Subclass hooks:
      * ``_apply_record(rec)`` — re-run one logged dispatch (replay arms)
      * ``_wal_shards``        — logs in the stream (1 for local)
    """

    wal_set = None
    _wal_applied = -1
    _replaying = False
    _repl_sink = None

    # ------------------------- subclass hooks --------------------------
    def _apply_record(self, rec) -> None:
        raise NotImplementedError

    @property
    def _wal_shards(self) -> int:
        return 1

    # ------------------------- the lifecycle ---------------------------
    def _log(self, op: str, payload: dict) -> None:
        if self._replaying:
            return
        if self._repl_sink is not None:
            # no durable log: mint the contiguous seqnos replicas need
            self._wal_applied += 1
            self._repl_sink.publish(self._wal_applied, op, payload)

    def attach_replication(self, sink) -> None:
        """``sink.publish(seqno, op, payload)`` is called for every logged
        update dispatch, before it runs.  The sink must be cheap and
        non-blocking: it runs on the serialized pump thread."""
        self._repl_sink = sink

    def attach_durability(self, wal_set, applied_seqno: int | None = None) -> None:
        raise NotImplementedError(_NOT_YET)

    def checkpoint(self, snapshot_dir: str, *, delta: bool = False) -> None:
        raise NotImplementedError(_NOT_YET)

    def wal_seqnos(self) -> list[int]:
        """Applied seqno per shard (shards advance together)."""
        return [self._wal_applied] * self._wal_shards

    def wal_sync(self) -> None:
        """The ack point's fsync: nothing to force without a WAL."""

    def replay(self, records, after_seqno: int = -1) -> int:
        """Re-apply a dispatch stream (``Record``-like objects with
        ``seqno``, ``op`` and ``payload``) through the backend's own entry
        points; returns how many records were applied."""
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
        """Release the durable log: nothing to release without a WAL."""


class RecordingSink:
    """A replication sink that keeps every published dispatch in memory
    (payload arrays copied), in seqno order — a stream ``replay`` takes."""

    def __init__(self):
        self.records: list[Record] = []

    def publish(self, seqno: int, op: str, payload: dict) -> None:
        self.records.append(Record(seqno, op, {k: np.array(v) for k, v in payload.items()}))
