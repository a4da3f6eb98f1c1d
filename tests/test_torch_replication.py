"""The port's read replicas: twins of the reference's replication cases
(``tests/test_replication.py``) on ``repro_torch.distributed.replication``.

1. **Logic** — ``ReplicaSet``'s routing, window, catch-up and failure
   machinery through duck-typed fake backends: round-robin order, the
   inflight cap, the ``max_lag`` freshness bound, window eviction →
   ``_GAP``, ordered replay, failure rerouting, each pinned as the
   reference's tests pin them.
2. **Services** — a replicated service on ``repro_torch.api`` on the CPU:
   bit-parity at equal seqno, induced-lag fallback, window-overflow
   catch-up, parity across a checkpoint, recovery; an ephemeral service
   minting its own seqnos; and the 2-shard × 2-replica service of the
   reference's ``tests/replica_script.py``.

Every join and ``result()`` has a timeout.
"""
import dataclasses
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.types import LireConfig
from repro_torch.distributed.replication import _GAP, ReplicaSet, states_equal
from repro_torch.serve.queue import MicroBatch
from repro_torch.storage.wal import WalRecord
from repro_torch.utils.tree import clone_state
from tests.conftest import make_clustered
from tests.test_torch_service import tiny_kw, tiny_spec

DEV = "cpu"
TIMEOUT = 60


# ---------------------------------------------------------------------------
# Fakes
# ---------------------------------------------------------------------------

class FakeBackend:
    """Duck-typed DurableBackend: ordered replay + forkable state."""

    def __init__(self, marker: int = 0):
        self.marker = marker
        self._wal_applied = -1
        self.replayed: list[WalRecord] = []
        self.adopted = None

    def replay(self, records, after_seqno: int = -1) -> int:
        n = 0
        for r in records:
            if r.seqno <= after_seqno:
                continue
            assert r.seqno == self._wal_applied + 1, (
                "out-of-order replay", r.seqno, self._wal_applied)
            self.replayed.append(r)
            self._wal_applied = r.seqno
            n += 1
        return n

    def search(self, queries, k, nprobe, valid=None):
        n = len(queries)
        return np.zeros((n, k), np.float32), np.full((n, k), self.marker, np.int32)

    def fork_state(self):
        return ("fork", self._wal_applied)

    def adopt_state(self, state):
        self.adopted = state


class FailingBackend(FakeBackend):
    def search(self, queries, k, nprobe, valid=None):
        raise RuntimeError("replica scan exploded")


class FakeQueue:
    def __init__(self):
        self.requeued = []

    def requeue(self, parts):
        self.requeued.append(list(parts))


class FakeEngine:
    def __init__(self):
        self.queue = FakeQueue()
        self.metrics = type("M", (), {"note_ticket": lambda s, t: None})()

    @contextmanager
    def exclusive(self):
        yield


def rec(seqno: int) -> WalRecord:
    return WalRecord("delete", {"vids": np.asarray([seqno])}, seqno)


def search_batch(n: int = 4, k: int = 5) -> MicroBatch:
    return MicroBatch(op="search", key=(k, None), parts=[],
                      arrays={"queries": np.zeros((n, 4), np.float32)}, n_valid=n, bucket=n)


def make_set(n_replicas=1, *, cls=FakeBackend, **kw) -> ReplicaSet:
    return ReplicaSet(FakeBackend(marker=-1), [cls(marker=i) for i in range(n_replicas)], **kw)


# ---------------------------------------------------------------------------
# Routing (workers never started: pure bookkeeping)
# ---------------------------------------------------------------------------

def test_route_round_robins_over_replicas():
    rs = make_set(2, inflight=8)
    for _ in range(4):
        assert rs.route(search_batch())
    assert [len(r.batches) for r in rs.replicas] == [2, 2]
    assert rs.routed == 4 and rs.fallback == 0
    assert [r.inflight for r in rs.replicas] == [2, 2]


def test_route_ignores_non_search_ops():
    rs = make_set(1)
    assert not rs.route(MicroBatch(op="insert", key=(), parts=[], arrays={}, n_valid=4,
                                   bucket=4))
    assert rs.routed == 0 and rs.fallback == 0   # not even counted


def test_route_inflight_cap_then_fallback():
    rs = make_set(2, inflight=1)
    assert rs.route(search_batch()) and rs.route(search_batch())
    assert not rs.route(search_batch())          # both at the cap
    assert rs.fallback == 1 and rs.routed == 2


def test_route_skips_replica_past_max_lag():
    rs = make_set(2, max_lag=3, inflight=8)
    rs.primary._wal_applied = 10
    rs.replicas[0].backend._wal_applied = 5      # lag 5 > 3: stale
    rs.replicas[1].backend._wal_applied = 8      # lag 2: fresh
    for _ in range(3):
        assert rs.route(search_batch())
    assert len(rs.replicas[0].batches) == 0
    assert len(rs.replicas[1].batches) == 3
    rs.replicas[1].backend._wal_applied = 0      # everyone stale: the primary
    assert not rs.route(search_batch())
    assert rs.fallback == 1


def test_route_skips_failed_replica():
    rs = make_set(2, inflight=8)
    rs.replicas[0].error = RuntimeError("dead")
    for _ in range(3):
        assert rs.route(search_batch())
    assert len(rs.replicas[1].batches) == 3


def test_route_copies_out_of_staging_buffers():
    """The queue reuses per-bucket staging arrays: a routed batch holds its
    own copy, or the next pop would overwrite the queries under the
    replica worker."""
    rs = make_set(1)
    b = search_batch()
    staging = b.arrays["queries"]
    assert rs.route(b)
    staging[:] = 7.0                             # the buffer reused
    routed = rs.replicas[0].batches[0]
    assert not np.shares_memory(routed.arrays["queries"], staging)
    assert (routed.arrays["queries"] == 0.0).all()


# ---------------------------------------------------------------------------
# Window / publish / gap detection
# ---------------------------------------------------------------------------

def test_publish_window_is_bounded_and_gap_detected():
    rs = make_set(1, window=4)
    for s in range(10):
        rs.publish(s, "delete", {"vids": np.asarray([s])})
    assert [r.seqno for r in rs._window] == [6, 7, 8, 9]
    r = rs.replicas[0]
    assert rs._next_record(r) is _GAP            # cursor -1, tail evicted
    r.backend._wal_applied = 6
    nxt = rs._next_record(r)
    assert nxt is not _GAP and nxt.seqno == 7    # contiguous from 6
    r.backend._wal_applied = 9
    assert rs._next_record(r) is None            # caught up
    assert rs.published == 10


def test_publish_copies_payload_arrays():
    rs = make_set(1, window=8)
    vids = np.asarray([1, 2, 3])
    rs.publish(0, "delete", {"vids": vids})
    vids[:] = -9                                 # the engine reuses the buffer
    np.testing.assert_array_equal(rs._window[0].payload["vids"], [1, 2, 3])


def test_worker_replays_in_seqno_order_and_redelivery_is_noop():
    rs = make_set(1, window=64)
    rs.start()
    try:
        for s in range(20):
            rs.primary._wal_applied = s
            rs.publish(s, "delete", {"vids": np.asarray([s])})
        rs.wait_sync(timeout=10)
        r = rs.replicas[0]
        assert [x.seqno for x in r.backend.replayed] == list(range(20))
        # redelivery (at-least-once window semantics) must not re-apply
        assert r.backend.replay([rec(3), rec(19)], after_seqno=r.applied) == 0
        assert r.applied == 19
    finally:
        rs.stop()


def test_catch_up_forks_primary_on_window_overflow():
    rs = make_set(1, window=2)
    rs.pause(0)
    rs.start()
    try:
        for s in range(8):
            rs.primary._wal_applied = s
            rs.publish(s, "delete", {"vids": np.asarray([s])})
        rs.resume(0)
        rs.wait_sync(timeout=10)
        r = rs.replicas[0]
        assert r.catchups >= 1
        assert r.backend.adopted == ("fork", 7)  # forked AT the head seqno
        assert r.applied == 7
        assert rs.report()["per_replica"][0]["lag"] == 0
    finally:
        rs.stop()


def test_failed_worker_reroutes_pending_batches():
    rs = make_set(1, cls=FailingBackend, inflight=8)
    eng = FakeEngine()
    rs.bind(eng)
    b1 = search_batch()
    b2 = dataclasses.replace(search_batch(), parts=["p2"])
    b3 = dataclasses.replace(search_batch(), parts=["p3"])
    for b in (b1, b2, b3):
        assert rs.route(b)
    rs.start()
    try:
        deadline = time.monotonic() + 10
        while rs.replicas[0].error is None:
            assert time.monotonic() < deadline, "replica never failed"
            time.sleep(0.005)
    finally:
        rs.stop()
    # b1 crashed in flight; b2 and b3 went back to the engine's queue
    assert eng.queue.requeued == [["p2"], ["p3"]]
    assert not rs.route(search_batch())          # out of rotation
    assert rs.fallback == 1


def test_wait_sync_times_out_on_a_stuck_replica():
    rs = make_set(1)
    rs.primary._wal_applied = 5
    with pytest.raises(TimeoutError):
        rs.wait_sync(timeout=0.05)


def test_report_shape():
    rs = make_set(2, max_lag=7, inflight=3, window=32)
    rs.primary._wal_applied = 4
    rep = rs.report()
    assert rep["n_replicas"] == 3                # total copies incl. the primary
    assert rep["max_lag"] == 7 and rep["inflight_cap"] == 3
    assert rep["window"] == 32 and rep["primary_seqno"] == 4
    assert [x["lag"] for x in rep["per_replica"]] == [5, 5]


def test_states_equal_is_bitwise():
    a = {"x": np.arange(4, dtype=np.float32), "y": np.ones(2, np.int32)}
    b = {"x": np.arange(4, dtype=np.float32), "y": np.ones(2, np.int32)}
    assert states_equal(a, b)
    b["y"] = np.ones(2, np.int64)                # dtype drift
    assert not states_equal(a, b)
    b["y"] = np.asarray([1, 2], np.int32)        # value drift
    assert not states_equal(a, b)
    # port states: bit for bit (-0.0 is not 0.0), the dirty bitmap ignored
    # unless asked, and lists of per-shard states leaf by leaf
    from repro_torch.core.index import SPFreshIndex

    st = SPFreshIndex.build(LireConfig(**tiny_kw()), make_clustered(np.random.default_rng(1),
                                                                     300, 16),
                            device="cpu").state
    twin = clone_state(st)
    assert states_equal(st, twin) and states_equal([st, st], [twin, twin])
    dirty = twin.pool.dirty.clone()
    dirty[0] = ~dirty[0]
    moved = twin.replace(pool=twin.pool.replace(dirty=dirty))
    assert states_equal(st, moved) and not states_equal(st, moved, ignore_dirty=False)
    cen = twin.centroids.clone()
    cen[0, 0] = -0.0 if float(cen[0, 0]) == 0.0 else cen[0, 0] * -1
    assert not states_equal(st, twin.replace(centroids=cen))
    assert not states_equal([st, st], [twin])


# ---------------------------------------------------------------------------
# Services
# ---------------------------------------------------------------------------

def open_(spec, **kw):
    return api.open(spec, device=DEV, **kw)


@pytest.fixture
def replicated_spec(tmp_path):
    spec = tiny_spec(tmp_path / "svc")
    spec = dataclasses.replace(spec, serve=dataclasses.replace(spec.serve, async_serve=True))
    return spec.with_replicas(2, max_lag=4)


def test_replicated_service_parity_fallback_catchup_recovery(replicated_spec, rng):
    """One durable replicated service through the whole replica life
    cycle: parity at equal seqno, the freshness-bound fallback under
    induced lag, window-overflow catch-up, parity across a primary
    checkpoint, and a recovery whose replica starts bit-identical at the
    recovered seqno."""
    base = make_clustered(rng, 600, 16, n_clusters=4)
    svc = open_(replicated_spec, vectors=base)
    rs = svc.replicas
    assert rs is not None and len(rs.replicas) == 1
    try:
        vecs = make_clustered(rng, 24, 16, n_clusters=2)
        for s in range(0, 24, 8):
            svc.insert(vecs[s:s + 8], np.arange(2000 + s, 2008 + s, dtype=np.int32))
        svc.drain()
        rs.wait_sync(timeout=TIMEOUT)
        assert states_equal(svc.backend.index.state, rs.replicas[0].backend.index.state)

        routed0 = rs.routed
        q = np.concatenate([vecs[:8], base[:8]])
        d0, v0 = svc.search(q, k=10)
        assert rs.routed > routed0
        with svc.engine.exclusive():
            dp, vp = svc.backend.search(q, 10, None)
        np.testing.assert_array_equal(v0, vp)
        np.testing.assert_allclose(d0, dp, rtol=1e-5)

        rs.pause(0)                              # lag beyond max_lag: the primary
        wave = make_clustered(rng, 24, 16, n_clusters=2)
        for s in range(0, 24, 4):
            svc.insert(wave[s:s + 4], np.arange(3000 + s, 3004 + s, dtype=np.int32))
        svc.drain()
        assert rs.report()["per_replica"][0]["lag"] > replicated_spec.serve.max_lag
        fb0, routed1 = rs.fallback, rs.routed
        _, hit = svc.search(wave[:6], k=1)
        assert rs.fallback > fb0 and rs.routed == routed1
        assert (hit[:, 0] == np.arange(3000, 3006)).all()   # the primary answered

        rs.window_cap = 4                        # overflow while paused → catch-up
        for s in range(5):
            svc.insert(make_clustered(rng, 4, 16),
                       np.arange(4000 + 4 * s, 4004 + 4 * s, dtype=np.int32))
        svc.drain()
        rs.resume(0)
        rs.wait_sync(timeout=TIMEOUT)
        rep = rs.report()["per_replica"][0]
        assert rep["catchups"] >= 1 and rep["lag"] == 0
        assert states_equal(svc.backend.index.state, rs.replicas[0].backend.index.state)

        svc.checkpoint()                         # the dirty ledger: parity holds
        svc.insert(make_clustered(rng, 8, 16), np.arange(4050, 4058, dtype=np.int32))
        svc.drain()
        rs.wait_sync(timeout=TIMEOUT)
        assert states_equal(svc.backend.index.state, rs.replicas[0].backend.index.state)
        want = svc.search(q, k=10)
    finally:
        svc.close()

    twin = open_(replicated_spec)
    try:
        assert twin.recovered
        rs2 = twin.replicas
        assert states_equal(twin.backend.index.state, rs2.replicas[0].backend.index.state)
        assert rs2.replicas[0].applied == int(twin.backend._wal_applied)
        got = twin.search(q, k=10)
        np.testing.assert_array_equal(want[1], got[1])
        np.testing.assert_allclose(want[0], got[0], rtol=1e-5)
    finally:
        twin.close()


def test_ephemeral_replication_mints_local_seqnos(rng):
    """No durable root: ``_log`` mints a contiguous local seqno stream, so
    the replica stays consistent without a WAL (cooperative engine: the
    pump routes there too)."""
    spec = tiny_spec().with_replicas(2, max_lag=8)
    svc = open_(spec, vectors=make_clustered(rng, 500, 16, n_clusters=4))
    rs = svc.replicas
    try:
        assert svc.backend.wal_set is None
        vecs = make_clustered(rng, 16, 16)
        for s in range(0, 16, 8):
            svc.insert(vecs[s:s + 8], np.arange(2000 + s, 2008 + s, dtype=np.int32))
        svc.drain()
        rs.wait_sync(timeout=TIMEOUT)
        assert rs.report()["primary_seqno"] >= 1     # minted, not WAL-assigned
        assert states_equal(svc.backend.index.state, rs.replicas[0].backend.index.state)
        routed0 = rs.routed
        _, hit = svc.search(vecs[:8], k=1)
        assert rs.routed > routed0
        assert (hit[:, 0] == np.arange(2000, 2008)).all()
        assert svc.report()["replicas"]["routed_batches"] == rs.routed
    finally:
        svc.close()


def test_replicas_over_two_shards_and_two_copies(tmp_path):
    """The reference's ``tests/replica_script.py`` on the port: 2 shards ×
    2 copies (every shard of both copies on the CPU): bit-parity at equal
    seqno, routing fan-out with the replica answering like the primary,
    the lag-bound fallback, catch-up after induced lag."""
    cfg = LireConfig(**tiny_kw())
    spec = (api.ServiceSpec(index=api.IndexSpec(config=cfg),
                            serve=api.ServeSpec(search_k=10, max_batch=64, min_bucket=16,
                                                async_serve=True))
            .with_durability(str(tmp_path / "svc")).with_shards(2).with_replicas(2, max_lag=4))
    rng = np.random.default_rng(0)
    base = make_clustered(rng, 1000, 16, n_clusters=10)
    svc = open_(spec, vectors=base)
    rs = svc.replicas
    try:
        assert rs is not None and len(rs.replicas) == 1 and svc.index is None
        assert rs.replicas[0].backend.states[0] is not svc.backend.states[0]

        new = make_clustered(rng, 60, 16, n_clusters=3)
        handles = []
        for s in range(0, 60, 20):
            h, landed = svc.insert(new[s:s + 20])
            assert landed.all()
            handles.extend(h.tolist())
        svc.delete(np.asarray(handles[:8], np.int32))
        svc.drain()
        rs.wait_sync(timeout=TIMEOUT)
        rep = rs.report()
        assert rep["per_replica"][0]["lag"] == 0 and rep["published"] > 0
        assert states_equal(svc.backend.states, rs.replicas[0].backend.states)

        routed0 = rs.routed
        queries = np.concatenate([new[8:16], base[:8]])
        d0, v0 = svc.search(queries, k=10)
        for _ in range(3):
            d1, v1 = svc.search(queries, k=10)
            np.testing.assert_array_equal(v0, v1)
            np.testing.assert_allclose(d0, d1, rtol=1e-5)
        assert rs.routed > routed0 and rs.report()["per_replica"][0]["batches"] > 0
        with svc.engine.exclusive():
            dp, vp = svc.backend.search(queries, 10, None)
        np.testing.assert_array_equal(v0, vp)
        np.testing.assert_allclose(d0, dp, rtol=1e-5)

        rs.pause(0)
        wave = make_clustered(rng, 48, 16, n_clusters=2)
        h2 = []
        for s in range(0, 48, 6):                # 8 dispatches: lag > max_lag
            h, landed = svc.insert(wave[s:s + 6])
            assert landed.all()
            h2.extend(h.tolist())
        svc.drain()
        assert rs.report()["per_replica"][0]["lag"] > spec.serve.max_lag
        fb0, routed1 = rs.fallback, rs.routed
        _, hit = svc.search(wave[:8], k=1)
        assert rs.fallback > fb0 and rs.routed == routed1
        assert (hit[:, 0] == np.asarray(h2[:8])).all()

        rs.window_cap = 4
        for _ in range(6):
            svc.insert(make_clustered(rng, 8, 16, n_clusters=2))
        svc.drain()
        rs.resume(0)
        rs.wait_sync(timeout=TIMEOUT)
        rep = rs.report()["per_replica"][0]
        assert rep["catchups"] >= 1 and rep["lag"] == 0 and not rep["failed"]
        assert states_equal(svc.backend.states, rs.replicas[0].backend.states)
        routed2 = rs.routed
        for _ in range(3):
            svc.search(base[:16], k=5)
        assert rs.routed > routed2
    finally:
        svc.close()


def test_engine_replicas_hooks_route_barrier_and_shutdown(rng):
    """The engine's four hooks on a live ReplicaSet: the pump routes a
    search batch first, ``barrier`` waits for the routed batch, a routed
    ticket carries the replica's seqno, ``shutdown`` stops the workers,
    ``report()`` has the ``replicas`` block."""
    from repro_torch.core.index import SPFreshIndex
    from repro_torch.serve import EngineConfig, LocalBackend, ServeEngine

    base = make_clustered(rng, 400, 16, n_clusters=4)
    be = LocalBackend(SPFreshIndex.build(LireConfig(**tiny_kw()), base, device=DEV))
    rs = ReplicaSet(be, [be.clone()], max_lag=4)
    be.attach_replication(rs)
    eng = ServeEngine(be, EngineConfig(search_k=5, max_batch=32, async_serve=True), replicas=rs)
    rs.bind(eng)
    rs.start()
    try:
        eng.insert(base[:8] + 0.01, np.arange(3000, 3008, dtype=np.int32))
        rs.wait_sync(timeout=TIMEOUT)
        tk = eng.submit_search(base[:8])
        eng.barrier()
        assert rs.idle() and tk.done and rs.routed >= 1
        assert tk.seqno == rs.replicas[0].applied
        _, v = tk.result(timeout=TIMEOUT)
        assert (v[:, 0] == np.arange(8)).all()
        assert eng.report()["replicas"]["routed_batches"] == rs.routed
    finally:
        eng.shutdown(timeout=TIMEOUT)
    assert all(r.thread is None for r in rs.replicas)
    assert torch.equal(be.index.state.pool.blocks, rs.replicas[0].backend.index.state.pool.blocks)


def test_routing_bookkeeping_survives_a_threaded_stress(rng):
    """More submitter threads than cores on an async engine with one
    replica, the interpreter switching threads every 10 µs: every search
    batch is counted once (routed or fallback), the replica's served rows
    add up, nothing stays in flight, and every ticket gets its answer."""
    import os
    import sys
    import threading

    from repro_torch.core.index import SPFreshIndex
    from repro_torch.serve import EngineConfig, LocalBackend, ServeEngine

    base = make_clustered(rng, 400, 16, n_clusters=4)
    be = LocalBackend(SPFreshIndex.build(LireConfig(**tiny_kw()), base, device=DEV))
    rs = ReplicaSet(be, [be.clone()], max_lag=2, inflight=1)
    be.attach_replication(rs)
    eng = ServeEngine(be, EngineConfig(search_k=5, max_batch=16, min_bucket=4,
                                       async_serve=True), replicas=rs)
    rs.bind(eng)
    rs.start()
    n_threads = 2 * (os.cpu_count() or 4)
    errors, wrong, sent, on_primary = [], [], [0], [0]
    lock = threading.Lock()
    begin = be.search_begin

    def counted_begin(queries, k, nprobe, valid=None):
        on_primary[0] += int(np.asarray(valid).sum())      # the pump thread only
        return begin(queries, k, nprobe, valid)

    be.search_begin = counted_begin

    def worker(tid):
        trng = np.random.default_rng(tid)
        try:
            for i in range(6):
                if i % 3 == 2:
                    vids = np.arange(3000 + 8 * (6 * tid + i), 3008 + 8 * (6 * tid + i),
                                     dtype=np.int32)
                    eng.submit_insert(base[trng.integers(0, 400, 8)] + 0.01,
                                      vids).result(timeout=TIMEOUT)
                    continue
                rows = trng.integers(0, 400, int(trng.integers(1, 6)))
                with lock:
                    sent[0] += len(rows)
                _, v = eng.submit_search(base[rows]).result(timeout=TIMEOUT)
                if v.shape != (len(rows), 5):
                    wrong.append(v.shape)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads), "a submitter hung"
        eng.barrier()
    finally:
        sys.setswitchinterval(old)
        eng.shutdown(timeout=TIMEOUT)
    assert not errors and not wrong, (errors, wrong)
    r = rs.replicas[0]
    assert r.error is None and r.inflight == 0 and not r.batches
    assert r.batches_served == rs.routed > 0
    assert r.rows_served + on_primary[0] == sent[0]
