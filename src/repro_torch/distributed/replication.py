"""Read replicas over the WAL dispatch stream.

The primary backend alone runs the WAL-append + dispatch order (the
engine's serialized pump).  ``DurableBackend._log`` publishes every logged
update dispatch — AFTER the WAL append assigns its seqno — into the
:class:`ReplicaSet`'s bounded in-memory window; one worker thread per
replica replays the records **in seqno order** through the replica
backend's own dispatches (``DurableBackend.replay``, the crash-recovery
code path).  Every dispatch is a deterministic function of (state,
batch), so a replica that has applied seqno S is bit-identical to the
primary as it was at seqno S; staleness is the seqno lag
``primary_applied - replica_applied``.

Routing: the engine's pump offers each SEARCH micro-batch to
:meth:`ReplicaSet.route` — round-robin over replicas, skipping any that
has failed, is over its ``inflight`` cap, or is more than ``max_lag``
seqnos behind the primary (the freshness bound); when no replica
qualifies the batch falls back to the primary (counted).  Routed batches
are served on the replica's worker thread, off the primary's pump.  A
routed ticket's ``seqno`` is the replica's applied seqno when it served
the batch.

Catch-up: a replica that falls behind the window (paused too long, slow,
or freshly failed over) finds a seqno GAP and recovers like a crashed
service: fork the primary's state under the engine's exclusive lock (a
consistent copy at a known seqno — the primary writes its pools in place,
so the fork is a deep copy), adopt it, then resume tail replay.

On the card every worker runs on the device's default stream, as the
pump does (no thread sets a stream): a catch-up fork under
``exclusive()`` is queued behind every dispatch the pump has issued, with
no event between streams.

Lock ordering (deadlock freedom): the pump thread holds the engine's
``_work`` lock and may then take ``ReplicaSet._lock`` (route) or a
replica's cond (publish notify).  Worker threads take ``_work`` only via
``engine.exclusive()`` during catch-up and NEVER while holding any
ReplicaSet lock.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.storage.blockpool import clear_dirty
from repro_torch.storage.wal import WalRecord
from repro_torch.utils.tree import is_state, tensor_leaves

log = logging.getLogger("repro_torch.replication")

SEARCH = "search"

_GAP = object()   # sentinel: the needed seqno was evicted from the window


def _leaves(tree, ignore_dirty: bool) -> list:
    """The leaves of a state, a list of per-shard states, or a dict of
    arrays, in a fixed order (the dirty bitmap cleared if asked)."""
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub, ignore_dirty)]
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if is_state(tree):
        if ignore_dirty and hasattr(tree, "pool"):
            tree = tree.replace(pool=clear_dirty(tree.pool))
        return list(tensor_leaves(tree).values())
    return [tree]


def _same_bits(x, y) -> bool:
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        bx = x.reshape(-1).contiguous().view(torch.uint8)
        by = y.reshape(-1).contiguous().to(x.device).view(torch.uint8)
        return bool(torch.equal(bx, by))
    ax, ay = np.asarray(x), np.asarray(y)
    return ax.shape == ay.shape and ax.dtype == ay.dtype and ax.tobytes() == ay.tobytes()


def states_equal(tree_a, tree_b, *, ignore_dirty: bool = True) -> bool:
    """Bit-exact equality (shape + dtype + raw bytes per leaf) — the check
    behind "replicas are bit-identical at equal seqno".  Takes a state, a
    list of per-shard states, or a dict of arrays.

    ``ignore_dirty`` clears the block pool's dirty bitmap before comparing:
    that leaf is CHECKPOINT bookkeeping (which blocks changed since the
    last snapshot unit), and only the primary checkpoints — every content
    leaf is still compared bit for bit.  Pass False for literal full-state
    parity on services that never checkpoint."""
    la, lb = _leaves(tree_a, ignore_dirty), _leaves(tree_b, ignore_dirty)
    return len(la) == len(lb) and all(_same_bits(x, y) for x, y in zip(la, lb))


class _Replica:
    """One read replica: a cloned backend + its worker thread's state."""

    def __init__(self, idx: int, backend):
        self.idx = idx
        self.backend = backend
        self.cond = threading.Condition()
        self.batches: deque = deque()     # routed search batches (guarded
                                          # by ReplicaSet._lock)
        self.thread: threading.Thread | None = None
        self.inflight = 0                 # routed-but-unfinished batches
        self.paused = False               # test hook: stop applying records
        self.error: BaseException | None = None
        # counters (single-writer: the worker; racy reads are benign)
        self.batches_served = 0
        self.rows_served = 0
        self.records_applied = 0
        self.catchups = 0

    @property
    def applied(self) -> int:
        return int(self.backend._wal_applied)


class ReplicaSet:
    """N-1 read replicas behind one primary, fed by the publish sink.

    Implements the ``publish(seqno, op, payload)`` sink protocol of
    ``DurableBackend.attach_replication`` plus the engine-facing routing
    surface (``route`` / ``idle`` / ``report``).  ``n_replicas`` in specs
    counts TOTAL copies including the primary, so a ReplicaSet holds
    ``n_replicas - 1`` clone backends.
    """

    def __init__(self, primary, replicas, *, max_lag: int = 64,
                 inflight: int = 2, window: int = 256):
        assert window >= 1 and inflight >= 1 and max_lag >= 0
        self.primary = primary
        self.replicas = [_Replica(i, b) for i, b in enumerate(replicas)]
        self.max_lag = max_lag
        self.inflight_cap = inflight
        self.window_cap = window
        self._engine = None
        self._lock = threading.Lock()     # routing + inflight bookkeeping
        self._wlock = threading.Lock()    # the replication window
        self._window: deque[WalRecord] = deque()
        self._head = int(primary._wal_applied)
        self._stopev = threading.Event()
        self._rr = 0
        # global counters
        self.published = 0
        self.routed = 0
        self.fallback = 0

    # --------------------------- lifecycle -----------------------------
    def bind(self, engine) -> None:
        """Attach the engine whose pump routes batches here (gives the
        workers ``exclusive()`` for catch-up and the metrics sink for
        routed-search latencies)."""
        self._engine = engine

    def start(self) -> None:
        for r in self.replicas:
            if r.thread is not None:
                continue
            t = threading.Thread(
                target=self._run, args=(r,),
                name=f"spfresh-replica-{r.idx}", daemon=True,
            )
            r.thread = t
            t.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the workers.  Routed batches still pending are served
        first so no search ticket is stranded; unapplied tail records are
        abandoned (the replicas are caches — the WAL is truth)."""
        self._stopev.set()
        for r in self.replicas:
            with r.cond:
                r.cond.notify_all()
        for r in self.replicas:
            t = r.thread
            if t is not None:
                t.join(timeout)
                if t.is_alive():
                    raise RuntimeError(f"replica worker {r.idx} failed to stop")
            r.thread = None

    # ------------------------- publish (sink) --------------------------
    def publish(self, seqno: int, op: str, payload: dict) -> None:
        """Called by the primary's ``_log`` on the pump thread, after the
        WAL append.  Payload arrays are copied: the engine reuses batch
        staging buffers, so a reference would be overwritten before a
        slow replica replays it."""
        rec = WalRecord(
            op=op,
            payload={k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
                     for k, v in payload.items()},
            seqno=seqno,
        )
        with self._wlock:
            self._window.append(rec)
            while len(self._window) > self.window_cap:
                self._window.popleft()
            self._head = seqno
            self.published += 1
        for r in self.replicas:
            with r.cond:
                r.cond.notify()

    def _next_record(self, r: _Replica):
        """The record after ``r``'s cursor: a WalRecord, None (caught
        up), or ``_GAP`` (evicted — snapshot catch-up needed)."""
        cursor = r.applied
        with self._wlock:
            if self._head <= cursor:
                return None
            if not self._window or self._window[0].seqno > cursor + 1:
                return _GAP
            return self._window[cursor + 1 - self._window[0].seqno]

    # --------------------------- routing -------------------------------
    def route(self, batch) -> bool:
        """Offer a SEARCH micro-batch to a replica (pump thread, under the
        engine's ``_work``).  Returns True when routed; False means the
        caller serves it on the primary (fallback)."""
        if batch.op != SEARCH or not self.replicas:
            return False
        primary_seq = int(self.primary._wal_applied)
        with self._lock:
            n = len(self.replicas)
            for i in range(n):
                r = self.replicas[(self._rr + i) % n]
                if r.error is not None or r.inflight >= self.inflight_cap:
                    continue
                if primary_seq - r.applied > self.max_lag:
                    continue  # staler than the freshness bound
                self._rr = (self._rr + i + 1) % n
                # copy out of the queue's reused staging buffers
                batch.arrays = {k: np.array(v, copy=True) for k, v in batch.arrays.items()}
                r.inflight += 1
                r.batches.append(batch)
                self.routed += 1
                routed_to = r
                break
            else:
                self.fallback += 1
                return False
        with routed_to.cond:
            routed_to.cond.notify()
        return True

    def idle(self) -> bool:
        """No routed batch pending or in flight (the engine's barrier
        folds this into its quiescence condition)."""
        with self._lock:
            return all(r.inflight == 0 and not r.batches for r in self.replicas)

    # ------------------------- worker thread ---------------------------
    def _run(self, r: _Replica) -> None:
        try:
            while True:
                with self._lock:
                    batch = r.batches.popleft() if r.batches else None
                if batch is not None:
                    self._serve(r, batch)
                    continue
                if self._stopev.is_set():
                    return
                did = False
                if not r.paused:
                    nxt = self._next_record(r)
                    if nxt is _GAP:
                        self._catch_up(r)
                        did = True
                    elif nxt is not None:
                        r.backend.replay([nxt], after_seqno=r.applied)
                        r.records_applied += 1
                        did = True
                if not did:
                    with r.cond:
                        with self._lock:
                            has_work = bool(r.batches)
                        if not has_work:
                            r.cond.wait(0.005)
        except BaseException as e:  # noqa: BLE001 — fail the replica, not
            self._fail(r, e)        # the service

    def _serve(self, r: _Replica, batch) -> None:
        """Serve one routed search batch on the replica's own state."""
        k, nprobe = batch.key
        applied = r.applied
        d, v = r.backend.search(batch.arrays["queries"], k, nprobe, batch.valid)
        batch.scatter({"dists": d, "ids": v})
        eng = self._engine
        for part in batch.parts:
            t = part.ticket
            if t.seqno is None:
                t.seqno = applied
            if t.done:
                if eng is not None:
                    eng.metrics.note_ticket(t)
                t._signal()
        with self._lock:
            r.inflight -= 1
            r.batches_served += 1
            r.rows_served += batch.n_valid

    def _catch_up(self, r: _Replica) -> None:
        """Snapshot catch-up — the crash-recovery path: fork the primary's
        state at a known seqno (under the engine's exclusive lock, so no
        dispatch is mid-flight), adopt it, resume tail replay.  MUST NOT
        hold any ReplicaSet lock here (lock order: ``_work`` is always
        taken before ReplicaSet locks)."""
        eng = self._engine
        if eng is not None:
            with eng.exclusive():
                state = self.primary.fork_state()
                seqno = int(self.primary._wal_applied)
        else:
            state = self.primary.fork_state()
            seqno = int(self.primary._wal_applied)
        r.backend.adopt_state(state)
        r.backend._wal_applied = seqno
        r.catchups += 1
        log.info("replica %d caught up by snapshot at seqno %d", r.idx, seqno)

    def _fail(self, r: _Replica, e: BaseException) -> None:
        """Take a replica out of rotation and hand its pending batches
        back to the engine queue (the pump re-serves them on the primary
        or another replica)."""
        r.error = e
        log.exception("replica %d worker died; rerouting its batches", r.idx)
        with self._lock:
            pending = list(r.batches)
            r.batches.clear()
            r.inflight -= len(pending)
        eng = self._engine
        for b in pending:
            if eng is not None:
                eng.queue.requeue(b.parts)
            else:  # no engine to reroute through: mask the rows out
                k = b.key[0] if b.key else 0
                b.scatter({
                    "dists": np.full((b.bucket, k), np.inf, np.float32),
                    "ids": np.full((b.bucket, k), -1, np.int32),
                })
                for part in b.parts:
                    part.ticket._signal()

    # --------------------------- test hooks ----------------------------
    def pause(self, i: int) -> None:
        """Stop replica ``i`` applying records (induces seqno lag)."""
        self.replicas[i].paused = True

    def resume(self, i: int) -> None:
        r = self.replicas[i]
        r.paused = False
        with r.cond:
            r.cond.notify()

    def wait_sync(self, timeout: float = 60.0) -> None:
        """Block until every live, unpaused replica has applied the
        primary's current seqno (quiesce the primary first — e.g.
        ``engine.barrier()`` — or this chases a moving target)."""
        deadline = time.monotonic() + timeout
        while True:
            prim = int(self.primary._wal_applied)
            lagging = [r.idx for r in self.replicas
                       if r.error is None and not r.paused and r.applied < prim]
            if not lagging:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replicas {lagging} still behind seqno {prim} after {timeout}s")
            time.sleep(0.001)

    # ---------------------------- metrics ------------------------------
    def report(self) -> dict:
        primary_seq = int(self.primary._wal_applied)
        with self._lock:
            reps = [
                {
                    "replica": r.idx,
                    "applied_seqno": r.applied,
                    "lag": max(0, primary_seq - r.applied),
                    "batches": r.batches_served,
                    "rows": r.rows_served,
                    "records_applied": r.records_applied,
                    "catchups": r.catchups,
                    "paused": r.paused,
                    "failed": r.error is not None,
                }
                for r in self.replicas
            ]
        return {
            "n_replicas": len(self.replicas) + 1,
            "primary_seqno": primary_seq,
            "published": self.published,
            "routed_batches": self.routed,
            "fallback_primary": self.fallback,
            "max_lag": self.max_lag,
            "inflight_cap": self.inflight_cap,
            "window": self.window_cap,
            "per_replica": reps,
        }
