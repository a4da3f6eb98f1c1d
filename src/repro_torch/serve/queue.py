"""Micro-batching request queue for the serving pipeline (a copy of the
JAX package's ``serve/queue.py``; the port shares no module with it).

The engine's front door: callers ``submit`` search / insert / delete
requests of arbitrary size; the queue coalesces *contiguous runs of
same-kind requests* (order across kinds is preserved, so an insert
followed by a delete of the same id never reorders) and emits
fixed-shape **padded micro-batches**.

Padding is *pad-to-bucket*: batch rows are rounded up to the nearest
bucket in a small geometric ladder (default powers of two, e.g.
``8, 16, 32, 64, 128, 256``).  A fixed bucket ladder bounds the number
of distinct dispatch shapes (each distinct shape costs its own kernel
tiling and allocator blocks on the card) at the cost of a measurable
amount of padding waste — which the queue accounts for
(``padded_rows`` vs ``real_rows``) so the trade-off shows up in the
engine's metrics instead of being invisible.

Threading: the queue is safe for many producer threads and ONE consumer
(the engine's pump thread).  ``submit`` enqueues all parts of a request
atomically under the queue lock; ``pop_batch(block=True)`` waits on a
condition variable.  With ``max_wait_ms > 0`` the consumer additionally
holds a *batch-formation window*: a head run smaller than the top bucket
is kept on the queue until either the window since its first part
expires, the run fills ``max_batch``, or a different-kind part fences it
— so under open-loop load micro-batches fill toward the top bucket
instead of dispatching the head run immediately (less padding waste,
fewer dispatches).

Large requests are split into parts of at most the largest bucket; a
:class:`Ticket` tracks all parts of one request and reassembles per-row
results in submission order.  Queue depth (in rows and requests) is
tracked continuously for the engine's depth metrics.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from repro_torch.utils import trace

SEARCH, INSERT, DELETE = "search", "insert", "delete"
_PAD_FILL = {"queries": 0.0, "vecs": 0.0, "vids": -1}


def default_buckets(min_bucket: int = 8, max_batch: int = 256) -> tuple[int, ...]:
    """Geometric (×2) bucket ladder from ``min_bucket`` to ``max_batch``."""
    assert min_bucket >= 1 and max_batch >= min_bucket
    out = []
    b = min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class Ticket:
    """Handle for one submitted request (possibly split into parts).

    ``result()`` blocks until every part of the request has been
    processed, then returns the assembled per-row result (op-dependent;
    see :class:`ServeEngine`).  In cooperative (sync) mode the caller
    thread pumps the engine itself; with a background pump thread
    (``async_serve``) the caller waits on the ticket's event, which the
    engine sets after the batch is processed — and, for durable update
    tickets, only after the covering WAL fsync (the group-commit ack).
    """

    def __init__(self, op: str, n: int, key: tuple, engine: Any = None):
        self.op = op
        self.n = n
        self.key = key                    # (k, nprobe) for search, () else
        self.t_submit = time.perf_counter()
        self.t_done: float | None = None
        self.dropped = 0                  # insert rows lost to backpressure
        # the backend's applied dispatch seqno this request saw: for a
        # search, at its first dispatch; for an update, after it ran
        self.seqno: int | None = None
        self._engine = engine
        self._pending = 0                 # parts not yet processed
        self._buffers: dict[str, np.ndarray] = {}
        self._event = threading.Event()
        # Parts of one ticket may complete from different threads (the
        # pump and replica workers both scatter results), so the pending
        # count and buffer creation are guarded.
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._pending == 0

    def _complete_part(self, start: int, n: int, arrays: dict[str, np.ndarray]):
        with self._lock:
            for name, arr in arrays.items():
                if name not in self._buffers:
                    shape = (self.n,) + arr.shape[1:]
                    self._buffers[name] = np.zeros(shape, arr.dtype)
                self._buffers[name][start : start + n] = arr[:n]
            self._pending -= 1
            if self._pending == 0:
                self.t_done = time.perf_counter()

    def _signal(self) -> None:
        """Release waiters (engine-owned: the pump thread calls this after
        processing — or after the WAL ack for durable updates)."""
        self._event.set()

    def result(self, timeout: float | None = None):
        eng = self._engine
        if eng is not None and getattr(eng, "is_async", False):
            deadline = None if timeout is None else time.monotonic() + timeout
            # Poll in short slices so a dead pump thread surfaces as an
            # exception here instead of a silent hang.
            while not self._event.wait(0.2):
                err = getattr(eng, "_pump_error", None)
                if err is not None:
                    raise RuntimeError("serve pump thread died") from err
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{self.op} ticket ({self.n} rows) not done "
                        f"after {timeout}s"
                    )
            return self._assemble()
        if not self.done:
            if eng is None:
                raise RuntimeError("ticket not done and no engine attached")
            eng._pump_until(self)
        return self._assemble()

    def _assemble(self):
        if self.op == SEARCH:
            return self._buffers["dists"], self._buffers["ids"]
        if self.op == INSERT:
            return self._buffers["ids"], self._buffers["landed"]
        return None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclasses.dataclass
class _Part:
    """A contiguous slice of one ticket's rows, at most one bucket wide."""

    ticket: Ticket
    arrays: dict[str, np.ndarray]   # unpadded row arrays for this part
    start: int                      # row offset inside the ticket
    n: int
    t_enq: float = 0.0              # enqueue time, perf_counter (formation window)


@dataclasses.dataclass
class MicroBatch:
    """A padded, fixed-shape batch of same-kind parts ready for one dispatch."""

    op: str
    key: tuple                      # per-op static params (k, nprobe)
    parts: list[_Part]
    arrays: dict[str, np.ndarray]   # padded to ``bucket`` rows
    n_valid: int
    bucket: int
    id: int = 0                     # the queue's count of batches at formation

    @property
    def valid(self) -> np.ndarray:
        return np.arange(self.bucket) < self.n_valid

    def scatter(self, results: dict[str, np.ndarray]) -> None:
        """Write per-row results back into the owning tickets."""
        off = 0
        for part in self.parts:
            sliced = {k: v[off : off + part.n] for k, v in results.items()}
            part.ticket._complete_part(part.start, part.n, sliced)
            off += part.n


class RequestQueue:
    """FIFO of request parts + the batching/padding policy described above.

    Thread-safe for N producers × 1 consumer.  ``max_wait_ms`` is the
    batch-formation window (0 = dispatch the head run immediately, the
    pre-async behavior).  Batch staging buffers are cached per
    (op, bucket, dtype/shape) and reused across pops: the dispatch entry
    points copy host arrays onto the device at dispatch time, so the
    staging memory is dead the moment the dispatch is issued — reusing
    it cuts two allocations (concatenate + pad) per batch.
    """

    def __init__(self, buckets: tuple[int, ...] | None = None,
                 *, max_wait_ms: float = 0.0, reuse_staging: bool = True):
        self.buckets = tuple(sorted(buckets or default_buckets()))
        self.max_batch = self.buckets[-1]
        self.max_wait_ms = max_wait_ms
        self.reuse_staging = reuse_staging
        self._fifo: deque[_Part] = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._staging: dict[tuple, dict[str, np.ndarray]] = {}
        self._depth_rows = 0
        # cumulative accounting (engine metrics read these)
        self.real_rows = 0
        self.padded_rows = 0
        self.batches = 0
        self.window_waits = 0           # pops that held the formation window
        self.max_depth_rows = 0
        self._depth_sum = 0.0
        self._depth_samples = 0

    # ------------------------------------------------------------- submit
    def submit(self, ticket: Ticket, arrays: dict[str, np.ndarray]) -> Ticket:
        """Split a request into ≤ max_batch parts and enqueue them in order.
        All parts land atomically: the consumer can never observe (and
        complete) a prefix of a request whose tail is still being split,
        so ``ticket.done`` only flips once every row is accounted for."""
        n = ticket.n
        assert n >= 1, "empty request"
        parts = []
        now = time.perf_counter()
        for start in range(0, n, self.max_batch):
            stop = min(start + self.max_batch, n)
            parts.append(_Part(
                ticket=ticket,
                arrays={k: v[start:stop] for k, v in arrays.items()},
                start=start,
                n=stop - start,
                t_enq=now,
            ))
        with self._cond:
            with ticket._lock:
                ticket._pending += len(parts)
            self._fifo.extend(parts)
            self._depth_rows += n
            self.max_depth_rows = max(self.max_depth_rows, self._depth_rows)
            self._cond.notify_all()
        return ticket

    # -------------------------------------------------------------- state
    def __len__(self) -> int:
        return len(self._fifo)

    @property
    def depth_rows(self) -> int:
        return self._depth_rows

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def wake(self) -> None:
        """Wake a consumer blocked in ``pop_batch`` (e.g. for shutdown)."""
        with self._cond:
            self._cond.notify_all()

    def requeue(self, parts: list[_Part]) -> None:
        """Push already-submitted parts back onto the HEAD of the queue
        (a failed replica hands its routed batches back this way).  The
        owning tickets' pending counts still include these parts, so no
        re-accounting — they simply get popped and served again."""
        if not parts:
            return
        with self._cond:
            self._fifo.extendleft(reversed(parts))
            self._depth_rows += sum(p.n for p in parts)
            self.max_depth_rows = max(self.max_depth_rows, self._depth_rows)
            self._cond.notify_all()

    def wait_nonempty(self, timeout: float | None = None) -> bool:
        """Block until at least one part is queued (or timeout)."""
        with self._cond:
            if self._fifo:
                return True
            self._cond.wait(timeout)
            return bool(self._fifo)

    # ----------------------------------------------------------- batching
    def _head_run(self) -> tuple[int, bool]:
        """Rows in the coalescible head run and whether the run is fenced
        (a different-kind part queued behind it, or max_batch reached) —
        a fenced run cannot grow, so the window must not hold it."""
        head = self._fifo[0]
        op, key = head.ticket.op, head.ticket.key
        rows = 0
        for p in self._fifo:
            if p.ticket.op != op or p.ticket.key != key:
                return rows, True
            if rows + p.n > self.max_batch:
                return rows, True
            rows += p.n
        return rows, rows >= self.max_batch

    def pop_batch(self, *, block: bool = False, timeout: float | None = None,
                  force: bool = False) -> MicroBatch | None:
        """Coalesce the head run of same-kind/same-key parts into one
        padded batch.  Returns None when the queue is empty (after
        waiting up to ``timeout`` if ``block``).  With ``max_wait_ms``
        set, an unfenced head run that hasn't filled the top bucket is
        held until the window since its first part's enqueue expires —
        ``force=True`` skips the hold (flush/shutdown)."""
        deadline = (
            time.perf_counter() + timeout
            if (block and timeout is not None) else None
        )
        with self._cond:
            while True:
                if self._fifo:
                    rows, fenced = self._head_run()
                    if force or self.max_wait_ms <= 0 or fenced:
                        return self._form_batch()
                    window_end = (
                        self._fifo[0].t_enq + self.max_wait_ms / 1e3
                    )
                    wait = window_end - time.perf_counter()
                    if wait <= 0:
                        return self._form_batch()
                    self.window_waits += 1
                    self._cond.wait(wait)
                    continue
                if not block:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    def _form_batch(self) -> MicroBatch:
        """Pop + pad the head run.  Caller holds the lock."""
        self._depth_sum += self._depth_rows
        self._depth_samples += 1

        head = self._fifo[0]
        op, key = head.ticket.op, head.ticket.key
        parts: list[_Part] = []
        rows = 0
        while self._fifo:
            p = self._fifo[0]
            if p.ticket.op != op or p.ticket.key != key:
                break
            if rows + p.n > self.max_batch:
                break
            parts.append(self._fifo.popleft())
            rows += p.n
        bucket = self.bucket_for(rows)
        self._depth_rows -= rows
        self.real_rows += rows
        self.padded_rows += bucket - rows
        self.batches += 1
        bid = self.batches
        if trace.ON:
            # each part waited from its enqueue to this formation
            formed = time.perf_counter_ns()
            for p in parts:
                trace.record("queue.wait", round(p.t_enq * 1e9), formed, batch=bid, tag=op)
            trace.set_batch(bid)

        arrays: dict[str, np.ndarray] = {}
        if not self.reuse_staging:
            # legacy path: one concatenate + one pad allocation per batch
            for name in parts[0].arrays:
                chunks = [p.arrays[name] for p in parts]
                cat = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
                pad = bucket - rows
                if pad:
                    width = [(0, pad)] + [(0, 0)] * (cat.ndim - 1)
                    cat = np.pad(
                        cat, width, constant_values=_PAD_FILL.get(name, 0)
                    )
                arrays[name] = cat
            return MicroBatch(
                op=op, key=key, parts=parts, arrays=arrays,
                n_valid=rows, bucket=bucket, id=bid,
            )
        staging = self._staging.setdefault((op, key, bucket), {})
        for name in parts[0].arrays:
            first = parts[0].arrays[name]
            shape = (bucket,) + first.shape[1:]
            buf = staging.get(name)
            if buf is None or buf.shape != shape or buf.dtype != first.dtype:
                buf = np.empty(shape, first.dtype)
                staging[name] = buf
            off = 0
            for p in parts:
                buf[off : off + p.n] = p.arrays[name]
                off += p.n
            if rows < bucket:
                buf[rows:] = _PAD_FILL.get(name, 0)
            arrays[name] = buf
        return MicroBatch(
            op=op, key=key, parts=parts, arrays=arrays,
            n_valid=rows, bucket=bucket, id=bid,
        )

    # ------------------------------------------------------------ metrics
    def accounting(self) -> dict:
        total = self.real_rows + self.padded_rows
        return {
            "batches": self.batches,
            "rows": self.real_rows,
            "padded_rows": self.padded_rows,
            "padding_waste_frac": self.padded_rows / total if total else 0.0,
            "window_waits": self.window_waits,
            "depth_rows_now": self._depth_rows,
            "depth_rows_max": self.max_depth_rows,
            "depth_rows_avg": (
                self._depth_sum / self._depth_samples
                if self._depth_samples else 0.0
            ),
        }
