"""The one traffic generator: it reads a traffic mix (a JSON file under
``cardbench/traffic/``) and drives a serving engine's tickets with it.

A mix has a ``search`` stream and, optionally, an ``ingest`` stream:

* ``search.loop = "closed"``: ``clients`` clients, each sending its next
  request when its last resolves; a request's time runs from when it was
  sent.
* ``search.loop = "open"``: requests due at Poisson arrivals of
  ``rate_per_s``, sent on schedule whatever the engine does; a request's
  time runs from when it was due, so a stall shows in every request behind
  it.  How late the generator sent is kept as well.
* ``ingest``: open loop at ``rate_per_s``: an insert ticket of
  ``insert_rows`` fresh rows (the data's pool, in row order), then at once
  a delete ticket of ``delete_rows`` base vids, drawn without replacement.

Every seed gets the same set of request sizes and inter-arrival gaps (the
quantiles of their distributions), in an order drawn from the seed, so
the seed changes the order of the work and not its amount.

Few threads drive the load: the engine resolves the tickets of one kind
in the order they were submitted (searches at their readback, updates as
they run), so one collector thread a kind waits on its tickets in that
order and stamps each as it resolves.  The closed loop's clients are
callbacks on the search collector: each sends its next request as soon as
its last resolves.  The open loop adds one thread that sends on schedule.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
import time
from collections import deque

import numpy as np

GRACE_S = 60.0            # how long after the close an answer may still come
QUANTILES = 4096          # size of the fixed sets of sizes and gaps


@dataclasses.dataclass
class Request:
    """One ticket as the harness saw it (times on ``time.perf_counter``)."""

    kind: str                     # "search" | "insert" | "delete"
    due: float
    rows: int
    arg: np.ndarray               # query rows (pool offsets), insert or delete vids
    sent: float = math.nan
    done: float = math.nan        # nan: never resolved
    seqno: int | None = None
    out: tuple | None = None      # search (dists, ids); insert (ids, landed)
    error: str | None = None

    @property
    def latency_s(self) -> float:
        return self.done - self.due


def row_sizes(spec: dict, seed: int) -> np.ndarray:
    """The request sizes: the quantiles of the size distribution, permuted
    by ``seed``."""
    u = (np.arange(QUANTILES) + 0.5) / QUANTILES
    if spec["dist"] == "log_uniform":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        sizes = np.exp(lo + u * (hi - lo))
    elif spec["dist"] == "fixed":
        sizes = np.full(QUANTILES, float(spec["min"]))
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    sizes = np.clip(np.round(sizes), spec["min"], spec["max"]).astype(np.int64)
    return np.random.default_rng([seed, 1]).permutation(sizes)


def poisson_gaps(rate: float, seed: int) -> np.ndarray:
    """Inter-arrival gaps of a Poisson stream: the exponential's quantiles,
    permuted by ``seed``."""
    u = (np.arange(QUANTILES) + 0.5) / QUANTILES
    return np.random.default_rng([seed, 2]).permutation(-np.log1p(-u) / rate)


class Collector(threading.Thread):
    """Waits on tickets in the order they were put, stamping each request
    when its ticket resolves; ``then(req)`` runs on this thread after."""

    def __init__(self, name: str):
        super().__init__(name=name, daemon=True)
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closing = False
        self.error: BaseException | None = None

    def put(self, req: "Request", ticket, then=None) -> None:
        with self._cond:
            self._items.append((req, ticket, then))
            self._cond.notify()

    def close(self) -> None:
        """Stop once every request put so far has resolved."""
        with self._cond:
            self._closing = True
            self._cond.notify()

    def run(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._items and not self._closing:
                        self._cond.wait()
                    if not self._items:
                        return
                    req, ticket, then = self._items.popleft()
                try:
                    out = ticket.result(timeout=GRACE_S + 1.0)
                    req.done = time.perf_counter()
                    req.out = out
                    req.seqno = ticket.seqno
                except (TimeoutError, RuntimeError) as e:
                    req.error = f"{type(e).__name__}: {e}"
                if then is not None:
                    then(req)
        except BaseException as e:  # noqa: BLE001 — raised in Traffic.finish()
            self.error = e


class Traffic:
    """Drives ``engine`` with ``mix`` from ``start`` until ``stop`` (host
    clock); every request goes into ``log``.  ``queries`` is the pool the
    searches draw runs of rows from, ``pool`` the insert rows (vids from
    ``n_base``), ``n_base`` the base vids the deletes draw from."""

    def __init__(self, engine, mix: dict, data: dict, seed: int):
        self.engine = engine
        self.mix = mix
        self.data = data
        self.seed = seed
        self.n_base = len(data["base"])
        self.log: list[Request] = []
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._collectors: dict[str, Collector] = {}
        self._errors: list[BaseException] = []
        self._next_insert = 0
        self._victims = np.random.default_rng([seed, 3]).permutation(self.n_base).astype(np.int32)
        self._next_victim = 0

    # ------------------------------------------------------------ requests
    def _queries(self, rng, m: int) -> np.ndarray:
        n = len(self.data["queries"])
        return (int(rng.integers(0, n)) + np.arange(m)) % n

    def _submit(self, req: Request):
        eng = self.engine
        if req.kind == "search":
            t = eng.submit_search(self.data["queries"][req.arg])
        elif req.kind == "insert":
            t = eng.submit_insert(self.data["pool"][req.arg - self.n_base], req.arg)
        else:
            t = eng.submit_delete(req.arg)
        req.sent = time.perf_counter()
        return t

    def _record(self, req: Request) -> None:
        with self._lock:
            self.log.append(req)

    # ------------------------------------------------------------- streams
    def _closed_clients(self, start: float, stop: float) -> None:
        """``clients`` closed-loop clients as callbacks on the search
        collector: each sends its next request when its last resolves."""
        spec = self.mix["search"]
        sizes = row_sizes(spec["rows"], self.seed)
        col = self._collectors["search"]

        def client(cid: int):
            rng = np.random.default_rng([self.seed, 4, cid])
            i = [cid * (QUANTILES // spec["clients"])]

            def send(_prev=None):
                if (_prev is not None and _prev.error is not None) \
                        or time.perf_counter() >= stop:
                    return
                m = int(sizes[i[0] % QUANTILES])
                i[0] += 1
                req = Request("search", 0.0, m, self._queries(rng, m))
                ticket = self._submit(req)
                req.due = req.sent
                self._record(req)
                col.put(req, ticket, send)
            return send

        now = time.perf_counter()
        if now < start:
            time.sleep(start - now)
        for c in range(spec["clients"]):
            client(c)()

    def _open_events(self, start: float):
        """``(due, kind)`` in due order, without end; the ingest stream
        starts half a period in."""
        streams = []
        s = self.mix.get("search")
        if s is not None and s["loop"] == "open":
            gaps = poisson_gaps(s["rate_per_s"], self.seed)
            streams.append(("search", itertools.cycle(gaps.tolist())))
        ing = self.mix.get("ingest")
        if ing is not None:
            period = 1.0 / ing["rate_per_s"]
            streams.append(("ingest", itertools.repeat(period)))
        heap = [(start + next(g) * (0.5 if kind == "ingest" else 1.0), n, kind, g)
                for n, (kind, g) in enumerate(streams)]
        heapq.heapify(heap)
        while heap:
            due, n, kind, g = heapq.heappop(heap)
            yield due, kind
            heapq.heappush(heap, (due + next(g), n, kind, g))

    def _open_loop(self, start: float, stop: float) -> None:
        spec = self.mix.get("search") or {}
        sizes = row_sizes(spec["rows"], self.seed) if spec else None
        rng = np.random.default_rng([self.seed, 5])
        ing = self.mix.get("ingest")
        n_search = 0
        try:
            for due, kind in self._open_events(start):
                if due >= stop:
                    break
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
                if kind == "search":
                    m = int(sizes[n_search % QUANTILES])
                    n_search += 1
                    reqs = [Request("search", due, m, self._queries(rng, m))]
                else:
                    r = ing["insert_rows"]
                    vids = np.arange(self._next_insert, self._next_insert + r, dtype=np.int32)
                    self._next_insert += r
                    dr = ing["delete_rows"]
                    gone = self._victims[self._next_victim:self._next_victim + dr]
                    self._next_victim += dr
                    reqs = [Request("insert", due, r, vids + self.n_base),
                            Request("delete", due, dr, gone)]
                for req in reqs:
                    ticket = self._submit(req)
                    self._record(req)
                    self._collectors[req.kind if req.kind == "search" else "update"].put(
                        req, ticket)
        except BaseException as e:  # noqa: BLE001 — raised in finish()
            self._errors.append(e)

    # ------------------------------------------------------------ lifecycle
    def start(self, start: float, stop: float) -> None:
        """Start every stream: requests are due from ``start`` until
        ``stop``."""
        s = self.mix.get("search")
        self._stop = stop
        self._collectors = {"search": Collector("search-collector"),
                            "update": Collector("update-collector")}
        for c in self._collectors.values():
            c.start()
        if s is not None and s["loop"] == "closed":
            self._threads.append(threading.Thread(target=self._closed_clients,
                                                  args=(start, stop), name="closed-loop",
                                                  daemon=True))
        if (s is not None and s["loop"] == "open") or self.mix.get("ingest") is not None:
            self._threads.append(threading.Thread(target=self._open_loop, args=(start, stop),
                                                  name="open-loop", daemon=True))
        for t in self._threads:
            t.start()

    def finish(self) -> None:
        """Wait until every stream has stopped sending and every request
        sent has resolved or timed out."""
        for t in self._threads:
            t.join(timeout=max(0.0, self._stop - time.perf_counter()) + GRACE_S)
        now = time.perf_counter()
        if now < self._stop:
            time.sleep(self._stop - now)
        for c in self._collectors.values():
            c.close()
        for c in self._collectors.values():
            c.join(timeout=GRACE_S + 30.0)
        alive = [t.name for t in self._threads + list(self._collectors.values())
                 if t.is_alive()]
        if alive:
            raise RuntimeError(f"traffic threads outlived their join timeout: {alive}")
        errors = self._errors + [c.error for c in self._collectors.values() if c.error]
        if errors:
            raise errors[0]
