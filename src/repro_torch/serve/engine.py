"""Serving engine: the paper's online loop (§5.2/§5.3) as a batched
async pipeline over the PyTorch index.

Requests enter through a :class:`~repro_torch.serve.queue.RequestQueue`
that micro-batches them into fixed-shape padded buckets; each
micro-batch is ONE dispatch of ``SPFreshIndex.search_padded`` /
``insert_padded`` / ``delete_padded``, and each background slot one
``maintain_round``.  Backends implement the small protocol below.

Two serving modes share the pipeline:

* **Cooperative (default)** — callers pump the queue themselves
  (``ticket.result()`` → ``_pump_until``); simple and deterministic,
  but every maintenance slot and every other caller's batch sits on
  each request's critical path.
* **Async (``EngineConfig.async_serve``)** — a dedicated background
  pump thread owns ALL backend dispatches; callers only enqueue and
  block on a per-ticket event.  Search readbacks are deferred: a search
  is queued on the card and its results copied to pinned host memory
  behind an event, and the pump reads them at scatter time, so the card
  works on the batch while the host forms and dispatches the next one.
  Maintenance slots run in queue-idle gaps, with a backlog-pressure
  override, and durable update tickets ack only after the covering WAL
  fsync.  WAL appends and update dispatches stay in ONE serialized order
  on the pump thread, so crash replay is exactly as bit-deterministic as
  in sync mode.

On the card every dispatch runs on the pump thread's current stream.
The index writes its block pool in place, so a deferred search must be
ordered before the next update's writes: one stream orders them, with no
event between a search and the update after it.  No thread sets a stream,
so that stream is the device's default one, which a checkpoint under
``exclusive()`` on the caller's thread also queues its copies on (see
``storage/durability.py``), and so do the read replicas' worker threads
(``distributed/replication.py``): the pump offers each search batch to
them first.

Background maintenance (the Local Rebuilder) is scheduled by a
pluggable :class:`~repro_torch.serve.policy.MaintenancePolicy` — the
paper's 2:1 feed-forward pipeline (Fig. 12) is ``RatioPolicy(2)``; a
reactive ``BacklogPolicy`` fires only when oversized postings exist.

Metrics: per-op latency percentiles (bounded reservoir), queue depth,
padding waste, and maintenance throughput/overlap.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Callable, Protocol

import numpy as np
import torch

from repro_torch.core.index import SPFreshIndex, check_vids
from repro_torch.serve.ownership import (
    GUARDED, INIT, LIFECYCLE, PUMP, holds_work, install_lock_check,
)
from repro_torch.serve.policy import BacklogPolicy, MaintenancePolicy, RatioPolicy
from repro_torch.serve.queue import (
    DELETE, INSERT, SEARCH, MicroBatch, RequestQueue, Ticket, default_buckets,
)
from repro_torch.storage.durability import DurableBackend
from repro_torch.utils import trace
from repro_torch.utils.tree import clone_state

log = logging.getLogger("repro_torch.serve")


# ---------------------------------------------------------------------------
# Backend protocol + the single-host backend
# ---------------------------------------------------------------------------

class IndexBackend(Protocol):
    """What the engine needs from an index: fixed-shape batched ops, plus
    the durable lifecycle (``repro_torch.api.open`` drives the last five —
    every update dispatch is WAL-appended before it runs, ``checkpoint``
    commits an atomic snapshot stamping per-shard WAL seqnos, and
    ``replay`` re-applies a WAL tail through the same dispatches)."""

    def search(self, queries: np.ndarray, k: int, nprobe: int | None,
               valid: np.ndarray | None = None,
               ) -> tuple[np.ndarray, np.ndarray]: ...

    def search_begin(self, queries: np.ndarray, k: int, nprobe: int | None,
                     valid: np.ndarray | None = None,
                     ) -> Callable[[], tuple[np.ndarray, np.ndarray]]: ...

    def insert(self, vecs: np.ndarray, vids: np.ndarray, valid: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]: ...

    def delete(self, vids: np.ndarray, valid: np.ndarray) -> None: ...

    def log_update(self, op: str, payload: dict) -> None: ...

    def maintain(self, jobs: int) -> int: ...

    def drain(self) -> tuple[int, int]: ...

    def backlog(self) -> int: ...

    def stats(self) -> dict: ...

    def attach_durability(self, wal_set) -> None: ...

    def checkpoint(self, snapshot_dir: str, *, delta: bool = False) -> str: ...

    def wal_sync(self) -> None: ...

    def replay(self, records, after_seqno: int = -1) -> int: ...

    def close(self) -> None: ...


def _read_back_later(out):
    """Start copying device tensors ``out`` to pinned host buffers on the
    current stream; returns ``(host tensors, event)`` (``event`` None for
    CPU tensors, which are already on the host)."""
    if out[0].device.type != "cuda":
        return out, None
    host = []
    for x in out:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return host, done


class LocalBackend(DurableBackend):
    """Single-host SPFreshIndex behind the batched entry points.

    ``probe_chunk`` / ``use_pallas_scan`` / ``scan_schedule`` select the
    posting-scan data path for every search dispatch (engine knobs; the
    scan flags default to the index config when None).

    With a :class:`~repro_torch.storage.wal.WalSet` attached
    (``attach_durability`` — ``repro_torch.api.open`` does this) or a
    replication sink (``attach_replication``), every update DISPATCH
    (insert/delete/maintain/drain, with its padded arrays and masks) is
    logged before it runs.  The dispatches are deterministic functions of
    (state, batch), so replaying the stream on a snapshot reproduces the
    index bit for bit — including the engine's backpressure retries,
    whose interleaved maintenance slots appear at their true positions.
    """

    def __init__(
        self,
        index: SPFreshIndex,
        *,
        probe_chunk: int = 0,
        use_pallas_scan: bool | None = None,
        scan_schedule: str | None = None,
        track_access: bool = True,
    ):
        self.index = index
        self.probe_chunk = probe_chunk
        self.use_pallas_scan = use_pallas_scan
        self.scan_schedule = scan_schedule
        self.track_access = track_access
        # Per-posting probe counts accumulated since the last maintenance
        # dispatch.  Searches are not logged, so this buffer never touches
        # the index state directly: it is drained into the payload of the
        # next logged maintain/drain dispatch and folded inside that round
        # — live and on replay alike.
        self._pending_access = np.zeros(
            (index.state.cfg.num_postings_cap,), np.int64
        )

    def search(self, queries, k, nprobe, valid=None):
        return self.search_begin(queries, k, nprobe, valid)()

    def search_begin(self, queries, k, nprobe, valid=None):
        """Issue ONE search dispatch and return a zero-arg ``finalize``
        that materializes ``(dists, ids)`` on the host.  On the card the
        dispatch and the copy of its results to pinned memory are queued
        on the current stream when this returns, and nothing has waited
        for them; ``finalize`` waits on the copy's event.  Access
        telemetry is folded into ``_pending_access`` at finalize time,
        always before the next maintenance dispatch drains it."""
        with trace.span("search"):
            out = self.index.search_padded(
                queries, k, nprobe=nprobe, probe_chunk=self.probe_chunk,
                use_pallas_scan=self.use_pallas_scan,
                scan_schedule=self.scan_schedule, with_access=self.track_access,
                qvalid=valid if self.track_access else None, as_tensor=True,
            )
            with trace.span("search.readback_enqueue"):
                host, done = _read_back_later(out)

        def finalize():
            if done is not None:
                with trace.span("engine.readback"):
                    done.synchronize()
            arrs = [h.numpy() for h in host]
            if self.track_access:
                self._pending_access += arrs[2]
            return arrs[0], arrs[1]
        return finalize

    def _take_access(self) -> np.ndarray:
        """Drain the pending probe counts for a maintenance dispatch."""
        acc = np.minimum(
            self._pending_access, np.iinfo(np.int32).max
        ).astype(np.int32)
        self._pending_access[:] = 0
        return acc

    def insert(self, vecs, vids, valid):
        self._log("insert", {
            "vecs": np.asarray(vecs, np.float32),
            "vids": np.asarray(vids, np.int32),
            "valid": np.asarray(valid, bool),
        })
        landed = self.index.insert_padded(vecs, vids, valid)
        return np.asarray(vids), landed

    def delete(self, vids, valid):
        self._log("delete", {
            "vids": np.asarray(vids, np.int32),
            "valid": np.asarray(valid, bool),
        })
        self.index.delete_padded(vids, valid)

    def log_update(self, op, payload):
        """Request-level WAL hook for an index built with ``wal_path``
        (``SPFreshIndex``'s single log): the engine logs each update batch
        here once, before its first dispatch.  The dispatch-level
        ``WalSet`` log supersedes it under ``repro_torch.api.open``."""
        if self.index.wal is not None:
            self.index._wal_applied = self.index.wal.append(op, payload)

    def maintain(self, jobs):
        access = self._take_access()
        self._log("maintain", {
            "jobs": np.asarray(jobs, np.int32), "access": access,
        })
        return self.index.maintain_round(jobs, access=access)

    def drain(self):
        # The record carries the jobs-per-round it drained with: replay
        # re-runs the same round shapes under any config default.
        access = self._take_access()
        jpr = int(self.index.state.cfg.jobs_per_round)
        self._log("drain", {
            "jobs": np.asarray(jpr, np.int32), "access": access,
        })
        jobs = self.index.maintain(jobs_per_round=jpr, access=access)
        return jobs, self.index.last_drain_rounds

    def backlog(self):
        return self.index.backlog()

    def stats(self):
        return self.index.stats()

    # ---------------- replication hooks (replica cloning) ---------------
    def fork_state(self):
        """Deep copy of the index state: the index writes its pool in
        place, so a replica sharing tensors with the primary would see
        the primary's next update."""
        return clone_state(self.index.state)

    def adopt_state(self, state) -> None:
        self.index.state = state

    def clone(self) -> "LocalBackend":
        """A read replica of this backend: same scan config, its own
        deep-copied state, no access telemetry of its own (replayed
        ``maintain`` records carry the primary's logged access counts)."""
        twin = LocalBackend(
            SPFreshIndex(self.fork_state()),
            probe_chunk=self.probe_chunk,
            use_pallas_scan=self.use_pallas_scan,
            scan_schedule=self.scan_schedule,
            track_access=False,
        )
        twin._wal_applied = self._wal_applied
        return twin

    # --------------- durability hooks (DurableBackend) -----------------
    def _snapshot_state(self):
        return self.index.state

    def _set_snapshot_state(self, state):
        self.index.state = state

    def _snapshot_extra(self):
        return {"backend": "local"}

    def _lire_config(self):
        return self.index.state.cfg

    def _apply_record(self, rec) -> None:
        p = rec.payload
        if rec.op == "insert":
            self.index.insert_padded(p["vecs"], p["vids"], p["valid"])
        elif rec.op == "delete":
            self.index.delete_padded(p["vids"], p["valid"])
        elif rec.op == "maintain":
            self.index.maintain_round(int(p["jobs"]), access=p.get("access"))
        elif rec.op == "drain":
            self.index.maintain(
                jobs_per_round=int(p["jobs"]) if "jobs" in p else None,
                access=p.get("access"),
            )
        else:
            raise ValueError(f"unknown dispatch op {rec.op!r}")

    def close(self) -> None:
        super().close()
        if self.index.wal is not None:
            self.index.wal.close()


# ---------------------------------------------------------------------------
# Config + metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    """Pipeline knobs."""

    search_k: int = 10
    nprobe: int | None = None
    # --- search data path (threaded into every search dispatch) ---
    probe_chunk: int = 0                  # oracle-path streaming chunk (0 = off)
    use_pallas_scan: bool | None = None   # None = defer to LireConfig
    scan_schedule: str | None = None      # "per_query" | "batched" | None
    # --- micro-batching ---
    max_batch: int = 256         # largest bucket (rows per dispatch)
    min_bucket: int = 8          # smallest bucket
    # --- maintenance scheduling (used when no policy object is given) ---
    policy: str = "ratio"        # "ratio" | "backlog"
    fg_bg_ratio: int = 2         # foreground update batches per bg slot (2:1)
    # Jobs per background ROUND: each slot is ONE fused dispatch splitting
    # the top-`maintain_budget` oversized postings and merging the bottom-
    # `maintain_budget` undersized, with one fused reassign pass.
    maintain_budget: int = 8
    backlog_threshold: int = 1   # BacklogPolicy firing threshold
    # --- insert backpressure ---
    max_insert_retries: int = 4
    # --- async serving (background pump thread) ---
    async_serve: bool = False
    max_wait_ms: float = 0.0     # batch-formation window (async queue)
    max_inflight: int = 2        # deferred search readbacks in flight
    # --- read replicas (distributed/replication.py) ---
    max_lag: int = 64            # replica freshness bound (WAL seqnos)
    replica_inflight: int = 2    # routed batches per replica in flight
    # Deferred background slots tolerated before one runs inline even
    # under load — keeps the steady-state slot rate equal to sync mode's
    # when the queue never goes idle.
    maint_pressure: int = 8
    ack_batch: int = 32          # unacked update tickets per forced fsync
    lat_reservoir: int = 4096    # bounded latency sample size per op
    # Debug: enforce the engine's FIELD_OWNERSHIP map at runtime (owner-
    # tracking lock + checking __setattr__, serve/ownership.py).
    lock_check: bool = False

    def buckets(self) -> tuple[int, ...]:
        return default_buckets(self.min_bucket, self.max_batch)

    def make_policy(self) -> MaintenancePolicy:
        if self.policy == "backlog":
            return BacklogPolicy(self.backlog_threshold, self.maintain_budget)
        return RatioPolicy(self.fg_bg_ratio, self.maintain_budget)


class _LatReservoir:
    """Uniform bounded sample of a latency stream (Vitter's algorithm R)."""

    __slots__ = ("cap", "n", "_buf", "_rng")

    def __init__(self, cap: int = 4096, seed: int = 0):
        self.cap = int(cap)
        self.n = 0
        self._buf: list[float] = []
        self._rng = np.random.default_rng(seed)

    def add(self, x: float) -> None:
        self.n += 1
        if len(self._buf) < self.cap:
            self._buf.append(x)
        else:
            j = int(self._rng.integers(0, self.n))
            if j < self.cap:
                self._buf[j] = x

    def values(self) -> list[float]:
        return self._buf

    def __len__(self) -> int:
        return self.n


class ServeMetrics:
    """Aggregated pipeline observability (read via ``ServeEngine.report``)."""

    def __init__(self, reservoir: int = 4096):
        self.lat: dict[str, _LatReservoir] = {
            op: _LatReservoir(reservoir, seed=i)
            for i, op in enumerate((SEARCH, INSERT, DELETE))
        }
        self._note_lock = threading.Lock()
        self.maint_slots = 0
        self.maint_rounds = 0
        self.maint_steps = 0
        self.maint_time_s = 0.0
        # async-mode split: slots run in queue-idle gaps vs deferred/forced
        self.maint_idle_slots = 0
        self.maint_idle_time_s = 0.0
        self.maint_deferred = 0
        self.maint_forced = 0
        self.insert_retries = 0
        self.insert_stall_s = 0.0
        self.insert_dropped = 0

    def note_ticket(self, ticket: Ticket) -> None:
        if ticket.latency_s is not None:
            with self._note_lock:
                self.lat[ticket.op].add(ticket.latency_s)

    def note_maintenance(self, steps: int, dt: float, rounds: int = 1,
                         idle: bool = False) -> None:
        self.maint_slots += 1
        self.maint_rounds += rounds
        self.maint_steps += steps
        self.maint_time_s += dt
        if idle:
            self.maint_idle_slots += 1
            self.maint_idle_time_s += dt

    def percentiles(self, op: str) -> dict:
        res = self.lat.get(op)
        if res is None or not res.values():
            return {}
        with self._note_lock:
            arr = np.asarray(res.values()) * 1e3
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p99_ms": float(np.percentile(arr, 99)),
            "p999_ms": float(np.percentile(arr, 99.9)),
            "mean_ms": float(arr.mean()),
            "n": res.n,
        }


class ServeEngine:
    """Batched async serving pipeline over a local index.

    Async API: ``submit_search`` / ``submit_insert`` / ``submit_delete``
    return a :class:`Ticket`; ``ticket.result()`` blocks until that
    request completes.  In cooperative mode (default) the caller thread
    pumps the queue itself; with ``EngineConfig.async_serve`` a
    background pump thread owns all dispatches and ``pump()`` becomes a
    flush barrier.  The synchronous ``search`` / ``insert`` / ``delete``
    methods are submit-then-wait conveniences.

    Threading invariants (async mode):

    * ONLY the pump thread calls into the backend for serving work (and
      so only it touches the card) — logged update dispatches form one
      serialized order, so replay determinism is identical to sync mode.
    * External backend work (maintain/checkpoint/drain from the caller
      thread) must run under ``exclusive()``.
    * Durable update tickets are signaled only after the covering WAL
      fsync (group-commit ack); search tickets signal at readback.
    * With read replicas (a bound ``ReplicaSet``) the pump offers every
      search batch to ``replicas.route`` first; a routed batch is served,
      scattered and signaled on a replica worker thread.

    The map below is the machine-checked form of those invariants;
    ``EngineConfig.lock_check`` enforces it at runtime
    (serve/ownership.py).
    """

    LOCK_FIELD = "_work"
    PUMP_METHODS = ("_pump_loop",)
    LIFECYCLE_METHODS = ("start", "shutdown")
    FIELD_OWNERSHIP = {
        # bound once in __init__, immutable after
        "cfg": INIT, "backend": INIT, "policy": INIT, "queue": INIT,
        "metrics": INIT, "_work": INIT, "_stop": INIT, "replicas": INIT,
        # shared mutable pipeline state: only under _work
        "_inflight": GUARDED, "_unacked": GUARDED, "_maint_due": GUARDED,
        # pump-thread-only writes; racy reads are benign by design
        "_busy": PUMP, "_pump_error": PUMP,
        # written by start()/shutdown(), which run strictly outside the
        # pump thread's lifetime
        "_pump_thread": LIFECYCLE,
    }

    def __init__(
        self,
        backend: IndexBackend | SPFreshIndex,
        cfg: EngineConfig | None = None,
        policy: MaintenancePolicy | None = None,
        replicas=None,
    ):
        self.cfg = cfg or EngineConfig()
        if isinstance(backend, SPFreshIndex):
            backend = LocalBackend(
                backend,
                probe_chunk=self.cfg.probe_chunk,
                use_pallas_scan=self.cfg.use_pallas_scan,
                scan_schedule=self.cfg.scan_schedule,
            )
        self.backend = backend
        # read replicas (a bound ReplicaSet, distributed/replication.py):
        # the pump offers every SEARCH batch to replicas.route() first
        self.replicas = replicas
        self.policy = policy or self.cfg.make_policy()
        # the batch-formation window only makes sense with a dedicated
        # consumer: in cooperative mode it would stall the caller itself
        self.queue = RequestQueue(
            self.cfg.buckets(),
            max_wait_ms=self.cfg.max_wait_ms if self.cfg.async_serve else 0.0,
        )
        self.metrics = ServeMetrics(self.cfg.lat_reservoir)
        # --- async pump state (all mutated under _work on the pump) ---
        self._work = threading.RLock()   # serializes log append + dispatch
        self._inflight: deque[tuple[MicroBatch, Callable]] = deque()
        self._unacked: list[Ticket] = []
        self._maint_due = 0
        self._busy = False               # pump holds a popped batch
        self._stop = threading.Event()
        self._pump_error: BaseException | None = None
        self._pump_thread: threading.Thread | None = None
        if self.cfg.lock_check:
            install_lock_check(self)   # before the pump thread exists
        if self.cfg.async_serve:
            self.start()

    @property
    def index(self) -> SPFreshIndex | None:
        """The underlying single-host index."""
        return getattr(self.backend, "index", None)

    # ------------------------- pump thread lifecycle --------------------
    @property
    def is_async(self) -> bool:
        return self._pump_thread is not None

    def start(self) -> None:
        """Start the background pump thread (idempotent)."""
        if self._pump_thread is not None:
            return
        self._stop.clear()
        self._pump_error = None
        t = threading.Thread(
            target=self._pump_loop, name="spfresh-pump", daemon=True
        )
        self._pump_thread = t
        t.start()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the pump thread (and any replica workers).  Queued
        batches, in-flight readbacks and unacked tickets are drained
        first, so no waiter is stranded."""
        t = self._pump_thread
        if t is not None:
            self._stop.set()
            self.queue.wake()
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("serve pump thread failed to stop")
            self._pump_thread = None
        if self.replicas is not None:
            # after the pump: replica workers first finish any batch the
            # pump's shutdown drain routed to them
            self.replicas.stop(timeout)

    @contextlib.contextmanager
    def exclusive(self):
        """Serialize external backend work (maintain / checkpoint / drain
        / wal_sync from the caller thread) against the pump thread's
        dispatches.  Uncontended no-op in cooperative mode."""
        with self._work:
            yield

    def _check_alive(self) -> None:
        if self._pump_error is not None:
            raise RuntimeError(
                "serve pump thread died"
            ) from self._pump_error

    def _pump_loop(self) -> None:
        try:
            while not self._stop.is_set():
                if len(self.queue):
                    self._busy = True
                    # may hold the batch-formation window (max_wait_ms);
                    # deliberately outside _work so external callers are
                    # not blocked behind the window
                    with trace.span("engine.form"):
                        batch = self.queue.pop_batch()
                    if batch is not None:
                        with self._work:
                            self._process_async(batch)
                    continue
                # queue idle: land deferred readbacks, cross the ack
                # point, then give the rebuilder ONE slot (re-checking
                # for arrivals between slots keeps bursts unblocked)
                with self._work:
                    self._drain_inflight()
                    self._ack_updates()
                    if self._idle_maintenance():
                        continue
                self._busy = False
                with trace.span("engine.wait"):
                    self.queue.wait_nonempty(0.05)
            # shutdown drain: nothing may be stranded behind the stop
            with self._work:
                while True:
                    batch = self.queue.pop_batch(force=True)
                    if batch is None:
                        break
                    self._process_async(batch)
                self._drain_inflight()
                self._ack_updates()
                self._busy = False
        except BaseException as e:  # noqa: BLE001 — surfaced to waiters
            self._pump_error = e
            self._busy = False
            log.exception(
                "serve pump thread died; pending tickets will raise"
            )

    @holds_work
    def _process_async(self, batch: MicroBatch) -> None:
        """One pump iteration's processing: dispatch, land the oldest
        deferred readbacks past ``max_inflight``, and cross the ack point
        once ``ack_batch`` update tickets wait for it."""
        # updates are ordered before any later search: ack them before
        # the search dispatch so insert latency is bounded by the next
        # batch boundary, not the next idle gap
        if batch.op == SEARCH and self._unacked:
            self._ack_updates()
        self._process(batch)
        while len(self._inflight) > max(0, self.cfg.max_inflight):
            self._finish_one_inflight()
        if len(self._unacked) >= max(1, self.cfg.ack_batch):
            self._ack_updates()

    # ----------------------------- submit ------------------------------
    def _empty_ticket(self, op: str, key: tuple,
                      buffers: dict[str, np.ndarray]) -> Ticket:
        """Zero-row requests complete immediately (a no-op, not an error)."""
        t = Ticket(op, 0, key, engine=self)
        t._buffers = buffers
        t.t_done = t.t_submit
        t._signal()
        return t

    def submit_search(
        self, queries: np.ndarray, *, k: int | None = None,
        nprobe: int | None = None,
    ) -> Ticket:
        self._check_alive()
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        # `is None` (not falsiness): an explicit k=0 / nprobe=0 must not
        # silently become the config default
        kk = self.cfg.search_k if k is None else k
        key = (kk, self.cfg.nprobe if nprobe is None else nprobe)
        if len(q) == 0:
            return self._empty_ticket(SEARCH, key, {
                "dists": np.zeros((0, kk), np.float32),
                "ids": np.full((0, kk), -1, np.int32),
            })
        t = Ticket(SEARCH, len(q), key, engine=self)
        return self.queue.submit(t, {"queries": q})

    def submit_insert(self, vecs: np.ndarray, vids: np.ndarray) -> Ticket:
        self._check_alive()
        vecs = np.asarray(vecs, np.float32)
        vids = np.asarray(vids, np.int32)
        assert len(vecs) == len(vids)
        self._check_vids(vids)
        if len(vids) == 0:
            return self._empty_ticket(INSERT, (), {
                "ids": np.zeros((0,), np.int32),
                "landed": np.zeros((0,), bool),
            })
        t = Ticket(INSERT, len(vids), (), engine=self)
        return self.queue.submit(t, {"vecs": vecs, "vids": vids})

    def submit_delete(self, vids: np.ndarray) -> Ticket:
        self._check_alive()
        vids = np.asarray(vids, np.int32)
        self._check_vids(vids)
        if len(vids) == 0:
            return self._empty_ticket(DELETE, (), {})
        t = Ticket(DELETE, len(vids), (), engine=self)
        return self.queue.submit(t, {"vids": vids})

    def _check_vids(self, vids: np.ndarray) -> None:
        """Refuse out-of-range vids at submit, before a dispatch logs them."""
        if self.index is not None:
            check_vids(vids, self.index.state.cfg)

    # ------------------------------ pump -------------------------------
    def pump(self, max_batches: int | None = None) -> int:
        """Cooperative mode: process queued micro-batches; returns how
        many were processed.  Async mode: a flush barrier — returns 0
        after every queued batch is processed, every deferred readback
        has landed, every update ticket is acked, and due background
        slots have run."""
        if self.is_async:
            self.barrier()
            return 0
        n = 0
        while max_batches is None or n < max_batches:
            with trace.span("engine.form"):
                batch = self.queue.pop_batch()
            if batch is None:
                break
            # Cooperative pumping can race with another caller thread's
            # drain()/exclusive(); dispatch under _work like every other
            # path (uncontended re-entrant acquire when single-threaded).
            with self._work:
                self._process(batch)
            n += 1
        return n

    def barrier(self, timeout: float = 600.0) -> None:
        """Wait for pipeline quiescence (async mode's flush point)."""
        deadline = time.monotonic() + timeout
        while True:
            self._check_alive()
            if not self.is_async:
                return
            with self._work:
                idle = (
                    len(self.queue) == 0 and not self._busy
                    and not self._inflight and not self._unacked
                    and self._maint_due <= 0
                    and (self.replicas is None or self.replicas.idle())
                )
            if idle:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError("serve pipeline barrier timed out")
            time.sleep(0.001)

    def _pump_until(self, ticket: Ticket) -> None:
        while not ticket.done:
            if self.pump(max_batches=1) == 0:
                if self.replicas is not None:
                    # the batch was routed: wait for the replica worker's
                    # signal instead of spinning on an empty queue
                    if ticket._event.wait(timeout=60.0) or ticket.done:
                        continue
                raise RuntimeError("ticket still pending on an empty queue")

    def _applied(self):
        return getattr(self.backend, "_wal_applied", None)

    @holds_work
    def _process(self, batch: MicroBatch) -> None:
        with trace.span("engine.dispatch", batch=batch.id, tag=batch.op):
            self._dispatch(batch)

    @holds_work
    def _dispatch(self, batch: MicroBatch) -> None:
        if batch.op == SEARCH:
            if self.replicas is not None and self.replicas.route(batch):
                # served on a replica worker thread (which stamps, scatters,
                # notes metrics and signals) — nothing more to do here
                return
            k, nprobe = batch.key
            applied = self._applied()
            for part in batch.parts:
                if part.ticket.seqno is None:
                    part.ticket.seqno = applied
            # batch.valid masks padded rows out of the access telemetry
            # (their result rows are computed and discarded).
            if self.is_async:
                begin = getattr(self.backend, "search_begin", None)
                if begin is not None:
                    # dispatch now, read back at scatter time: the device
                    # overlaps this batch with whatever the pump does next
                    fin = begin(batch.arrays["queries"], k, nprobe,
                                batch.valid)
                    self._inflight.append((batch, fin))
                    return
            d, v = self.backend.search(
                batch.arrays["queries"], k, nprobe, batch.valid
            )
            with trace.span("engine.scatter"):
                batch.scatter({"dists": d, "ids": v})
        elif batch.op == INSERT:
            self._process_insert(batch)
            self._stamp(batch)
            self._tick_background()
        else:
            vids, valid = batch.arrays["vids"], batch.valid
            self.backend.log_update("delete", {"vids": vids[valid]})
            self.backend.delete(vids, valid)
            batch.scatter({})
            self._stamp(batch)
            self._tick_background()
        self._note_done(batch)

    @holds_work
    def _stamp(self, batch: MicroBatch) -> None:
        """An update ticket's seqno: the applied seqno once it ran."""
        applied = self._applied()
        for part in batch.parts:
            part.ticket.seqno = applied

    @holds_work
    def _note_done(self, batch: MicroBatch) -> None:
        """Record + release finished tickets.  Durable update tickets in
        async mode are held back until the WAL ack covers them."""
        hold = (
            self.is_async and batch.op != SEARCH
            and getattr(self.backend, "wal_set", None) is not None
        )
        for part in batch.parts:
            t = part.ticket
            if not t.done:
                continue
            if hold:
                self._unacked.append(t)
            else:
                self.metrics.note_ticket(t)
                t._signal()

    @holds_work
    def _ack_updates(self) -> None:
        """Group-commit ack point: fsync the WAL, then signal every held
        update ticket (latency includes the fsync wait)."""
        if not self._unacked:
            return
        with trace.span("engine.ack"):
            self.backend.wal_sync()
            now = time.perf_counter()
            for t in self._unacked:
                t.t_done = now
                self.metrics.note_ticket(t)
                t._signal()
            self._unacked.clear()

    @holds_work
    def _finish_one_inflight(self) -> None:
        batch, finalize = self._inflight.popleft()
        with trace.span("engine.land", batch=batch.id, tag=batch.op):
            d, v = finalize()
            with trace.span("engine.scatter"):
                batch.scatter({"dists": d, "ids": v})
                for part in batch.parts:
                    if part.ticket.done:
                        self.metrics.note_ticket(part.ticket)
                        part.ticket._signal()

    @holds_work
    def _drain_inflight(self) -> None:
        while self._inflight:
            self._finish_one_inflight()

    @holds_work
    def _process_insert(self, batch: MicroBatch) -> None:
        """Insert with pipeline backpressure: when primary appends hit a
        posting at hard capacity, give the rebuilder a slot (it splits the
        oversized posting) and retry the unlanded rows — the explicit
        backpressure form of the paper's Updater→Rebuilder pipeline."""
        vecs, vids = batch.arrays["vecs"], batch.arrays["vids"]
        valid = batch.valid
        self.backend.log_update(
            "insert", {"vecs": vecs[valid], "vids": vids[valid]}
        )
        ids = np.asarray(vids).copy()
        landed_all = np.zeros(batch.bucket, bool)
        pending = valid.copy()
        for attempt in range(self.cfg.max_insert_retries + 1):
            if not pending.any():
                break
            if attempt > 0:
                # stall: serve-path time burned waiting on the rebuilder,
                # the in-flight searches landed before its slot included
                with trace.timed("engine.stall") as stall:
                    self._run_maintenance("backpressure")
                self.metrics.insert_stall_s += stall.seconds
                self.metrics.insert_retries += 1
            got_ids, landed = self.backend.insert(vecs, vids, pending)
            newly = pending & landed
            ids[newly] = got_ids[newly]
            landed_all |= newly
            pending = pending & ~landed
        n_dropped = int(pending.sum())
        if n_dropped:
            self.metrics.insert_dropped += n_dropped
            off = 0
            for part in batch.parts:
                d = int(pending[off : off + part.n].sum())
                if d:
                    part.ticket.dropped += d
                off += part.n
            log.warning(
                "insert backpressure exhausted after %d retries: "
                "%d/%d row(s) dropped",
                self.cfg.max_insert_retries, n_dropped, batch.n_valid,
            )
        batch.scatter({"ids": ids, "landed": landed_all})

    # ------------------------ background pipeline -----------------------
    @holds_work
    def _tick_background(self) -> None:
        self.policy.note_foreground()
        if not self.policy.want_maintenance(self.backend.backlog):
            return
        if self.is_async:
            # Defer the slot to a queue-idle gap — unless enough slots
            # have piled up that the rebuilder would fall behind under
            # sustained load.
            self._maint_due += 1
            self.metrics.maint_deferred += 1
            if self._maint_due >= max(1, self.cfg.maint_pressure):
                self._maint_due -= 1
                self.metrics.maint_forced += 1
                self._run_maintenance("forced")
        else:
            self._run_maintenance("inline")

    @holds_work
    def _idle_maintenance(self) -> bool:
        """Run ONE deferred slot in a queue-idle gap; returns whether a
        slot ran."""
        if self._maint_due <= 0:
            return False
        self._maint_due -= 1
        self._run_maintenance("idle")
        return True

    @holds_work
    def _run_maintenance(self, kind: str) -> int:
        """One maintenance slot = ONE fused round of ``policy.budget`` jobs
        (a single dispatch; the host reads back one did-work scalar).
        ``kind`` says why it runs: ``idle`` (a queue-idle gap), ``forced``
        (deferred slots piled up), ``backpressure`` (an insert's retry) or
        ``inline`` (cooperative mode)."""
        # deferred search readbacks fold access telemetry at finalize —
        # land them before the maintain dispatch drains that buffer
        self._drain_inflight()
        with trace.timed("engine.maintain", tag=kind) as slot:
            jobs = self.backend.maintain(self.policy.budget)
        self.policy.note_maintenance(jobs)
        self.metrics.note_maintenance(jobs, slot.seconds, idle=kind == "idle")
        return jobs

    def drain(self) -> int:
        """Flush the queue, then run the rebuilder to quiescence (batched
        rounds, one readback per round); returns jobs executed."""
        self.pump()
        with self._work:
            self._drain_inflight()
            self._maint_due = 0    # quiescence supersedes deferred slots
            with trace.timed("engine.drain") as span:
                jobs, rounds = self.backend.drain()
            self.metrics.note_maintenance(jobs, span.seconds, rounds=rounds)
        return jobs

    # ------------------------- sync conveniences ------------------------
    def search(
        self, queries: np.ndarray, *, k: int | None = None,
        nprobe: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        t = self.submit_search(queries, k=k, nprobe=nprobe)
        return t.result()

    def insert(self, vecs: np.ndarray, vids: np.ndarray) -> None:
        t = self.submit_insert(vecs, vids)
        t.result()

    def delete(self, vids: np.ndarray) -> None:
        t = self.submit_delete(vids)
        t.result()

    # ----------------------------- metrics ------------------------------
    def latency_percentiles(self, which: str = SEARCH) -> dict:
        return self.metrics.percentiles(which)

    def report(self) -> dict:
        m = self.metrics
        mt = m.maint_time_s
        return {
            "search": m.percentiles(SEARCH),
            "insert": m.percentiles(INSERT),
            "delete": m.percentiles(DELETE),
            "queue": self.queue.accounting(),
            "maintenance": {
                "policy": self.policy.describe(),
                "slots": m.maint_slots,
                "rounds": m.maint_rounds,
                "steps": m.maint_steps,   # jobs that acted
                "time_s": mt,
                "steps_per_s": m.maint_steps / mt if mt > 0 else 0.0,
                # async-mode overlap: fraction of rebuilder time spent in
                # queue-idle gaps (off the serve path) vs inline
                "idle_slots": m.maint_idle_slots,
                "idle_time_s": m.maint_idle_time_s,
                "overlap_frac": m.maint_idle_time_s / mt if mt > 0 else 0.0,
                "deferred": m.maint_deferred,
                "forced": m.maint_forced,
            },
            "async": self.is_async,
            "insert_retries": m.insert_retries,
            "insert_stall_s": m.insert_stall_s,
            "insert_dropped": m.insert_dropped,
            "backlog": self.backend.backlog(),
            "replicas": (
                self.replicas.report() if self.replicas is not None else None
            ),
        }

    def stats(self) -> dict:
        return self.backend.stats()
