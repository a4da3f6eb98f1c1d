"""The port's serving layer against the reference's: the request queue,
the maintenance policies, the ownership checker, the cooperative engine,
the async pump and the recorded dispatch stream.

* The queue is held to the reference's by trace: the same submissions
  through both queues give the same micro-batches (op, key, bucket,
  parts, padded arrays) and the same ``accounting()``.
* The cooperative engine, from one reference build carried across with
  ``convert.state_from_numpy`` and with no maintenance
  (``fg_bg_ratio=0``, no backpressure retries), answers every ticket as
  the reference's does — ids equal up to distance ties, distances within
  ``1e-5 * |d|`` on the gather oracle and ``1e-5 * (|d| + ||q||²)`` on the
  kernel path (its f32 expansion's error scales with the terms) — and ends in the same state leaf for leaf (integer
  leaves equal; the telemetry's ``drift_vec`` within ``1e-5``).
* With maintenance on, the reference's own engine checks run on the port.
* The async stress twin counts ordering violations (a search dispatched
  before an insert its submitter had already awaited: must be 0) apart
  from ANN misses (the vid is not in the top-k of a search dispatched
  after its insert: counted, bounded), so an ANN miss cannot fail it.
* The engine over a 2-shard index runs the reference's
  ``tests/serve_sharded_script.py`` checks on the port.

Everything runs on the CPU, where the port's kernels run their plain
versions; every ``join`` and ``result()`` has a timeout.
"""
import dataclasses
import logging
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core.index import SPFreshIndex as RIndex
from repro.serve import queue as rqueue
from repro.serve.engine import EngineConfig as REngineConfig
from repro.serve.engine import ServeEngine as RServeEngine
from repro.serve.policy import BacklogPolicy as RBacklogPolicy
from repro.serve.policy import RatioPolicy as RRatioPolicy
from repro_torch import convert
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.types import LireConfig as TConfig
from repro_torch.data.vectors import make_shifting_stream, make_sift_like
from repro_torch.serve import (
    BacklogPolicy, EngineConfig, LocalBackend, RatioPolicy, RequestQueue, ServeEngine,
    Ticket, default_buckets,
)
from repro_torch.serve import queue as tqueue
from repro_torch.serve.engine import ServeMetrics, _LatReservoir
from repro_torch.serve.ownership import CheckedRLock, LockDisciplineError
from repro_torch.serve.queue import DELETE, INSERT, SEARCH
from repro_torch.storage.durability import RecordingSink
from repro_torch.utils.tree import clone_state, tensor_leaves
from tests.conftest import make_clustered
from tests.test_lire import small_cfg
from tests.test_torch_storage import assert_leaves_equal, ref_leaves

DIM = 16
TIMEOUT = 120


def tcfg(**kw):
    return TConfig(**dataclasses.asdict(small_cfg(**kw)))


def port_index(base, **kw):
    return TIndex.build(tcfg(**kw), base, device="cpu")


# ---------------------------------------------------------------------------
# RequestQueue: the same trace through both queues
# ---------------------------------------------------------------------------

def _trace(seed, n_req):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        op = ("search", "insert", "delete")[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 90))
        key = ((10, None), (5, 8))[int(rng.integers(0, 2))] if op == "search" else ()
        if op == "search":
            arrays = {"queries": rng.normal(size=(n, 4)).astype(np.float32)}
        elif op == "insert":
            arrays = {"vecs": rng.normal(size=(n, 4)).astype(np.float32),
                      "vids": rng.integers(0, 1000, n).astype(np.int32)}
        else:
            arrays = {"vids": rng.integers(0, 1000, n).astype(np.int32)}
        out.append((op, n, key, arrays, int(rng.integers(0, 4)) == 0))
    return out


def _batches(mod, buckets, trace, reuse):
    q = mod.RequestQueue(buckets, reuse_staging=reuse)
    tickets, got = [], []

    def drain(n_max=None):
        while n_max is None or n_max > 0:
            b = q.pop_batch()
            if b is None:
                return
            got.append((b.op, b.key, b.bucket, b.n_valid,
                        [(tickets.index(p.ticket), p.start, p.n) for p in b.parts],
                        {k: v.copy() for k, v in b.arrays.items()}, b.valid.copy()))
            b.scatter({})
            if n_max is not None:
                n_max -= 1

    for op, n, key, arrays, pop_one in trace:
        t = mod.Ticket(op, n, key)
        tickets.append(t)
        q.submit(t, arrays)
        if pop_one:
            drain(1)
    drain()
    assert all(t.done for t in tickets)
    return got, q.accounting()


@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("buckets", [(8, 16, 32, 64), (4, 100)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_forms_the_reference_micro_batches(seed, buckets, reuse):
    trace = _trace(seed, 40)
    ref, ref_acc = _batches(rqueue, buckets, trace, reuse)
    got, acc = _batches(tqueue, buckets, trace, reuse)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[:5] == r[:5]
        assert set(g[5]) == set(r[5])
        for name in r[5]:
            np.testing.assert_array_equal(g[5][name], r[5][name])
        np.testing.assert_array_equal(g[6], r[6])
    assert acc == ref_acc


# ---------------------------------------------------------------------------
# The reference's queue, window and policy cases, run on the port
# ---------------------------------------------------------------------------

def _submit(q, op, n, key=(), tag=0.0):
    t = Ticket(op, n, key)
    if op == "search":
        arrays = {"queries": np.full((n, 4), tag, np.float32)}
    elif op == "insert":
        arrays = {"vecs": np.full((n, 4), tag, np.float32),
                  "vids": np.arange(n, dtype=np.int32)}
    else:
        arrays = {"vids": np.arange(n, dtype=np.int32)}
    return q.submit(t, arrays)


def case_default_buckets_ladder():
    assert default_buckets(8, 256) == (8, 16, 32, 64, 128, 256)
    assert default_buckets(8, 100) == (8, 16, 32, 64, 100)
    assert default_buckets(4, 4) == (4,)


def case_pads_to_bucket_and_accounts_waste():
    q = RequestQueue(buckets=(8, 16, 32))
    _submit(q, "search", 11, key=(10, None))
    assert q.depth_rows == 11
    b = q.pop_batch()
    assert b.bucket == 16 and b.n_valid == 11
    assert b.arrays["queries"].shape == (16, 4)
    assert b.valid.sum() == 11
    assert (b.arrays["queries"][11:] == 0).all()
    acc = q.accounting()
    assert acc["rows"] == 11 and acc["padded_rows"] == 5
    assert acc["padding_waste_frac"] == pytest.approx(5 / 16)
    assert q.depth_rows == 0


def case_coalesces_contiguous_same_op_runs_only():
    q = RequestQueue(buckets=(8, 16, 32))
    _submit(q, "insert", 5, tag=1.0)
    _submit(q, "insert", 6, tag=2.0)
    _submit(q, "delete", 3)
    _submit(q, "insert", 4, tag=3.0)
    b1 = q.pop_batch()
    assert b1.op == "insert" and b1.n_valid == 11 and b1.bucket == 16
    assert (b1.arrays["vecs"][:5] == 1.0).all()
    assert (b1.arrays["vecs"][5:11] == 2.0).all()
    b2 = q.pop_batch()
    assert b2.op == "delete" and b2.n_valid == 3
    b3 = q.pop_batch()
    assert b3.op == "insert" and b3.n_valid == 4
    assert q.pop_batch() is None


def case_never_mixes_search_keys():
    q = RequestQueue(buckets=(8, 16))
    _submit(q, "search", 4, key=(10, None))
    _submit(q, "search", 4, key=(5, None))
    b1, b2 = q.pop_batch(), q.pop_batch()
    assert b1.key == (10, None) and b1.n_valid == 4
    assert b2.key == (5, None) and b2.n_valid == 4


def case_splits_oversized_requests_into_parts():
    q = RequestQueue(buckets=(8, 16))
    t = _submit(q, "delete", 40)
    sizes = []
    while (b := q.pop_batch()) is not None:
        sizes.append((b.n_valid, b.bucket))
        b.scatter({})
    assert sizes == [(16, 16), (16, 16), (8, 8)]
    assert t.done
    acc = q.accounting()
    assert acc["rows"] == 40 and acc["batches"] == 3


def case_vid_padding_is_minus_one():
    q = RequestQueue(buckets=(8,))
    _submit(q, "delete", 3)
    b = q.pop_batch()
    assert (b.arrays["vids"][3:] == -1).all()


def case_requeue_puts_parts_back_at_the_head():
    q = RequestQueue(buckets=(8, 16))
    _submit(q, "delete", 4)
    _submit(q, "insert", 4)
    b = q.pop_batch()
    q.requeue(b.parts)
    assert q.depth_rows == 8
    assert q.pop_batch().op == "delete" and q.pop_batch().op == "insert"


def case_window_coalesces_head_run():
    q = RequestQueue(default_buckets(8, 8), max_wait_ms=500.0)
    q.submit(Ticket(SEARCH, 4, (10, None)), {"queries": np.zeros((4, DIM), np.float32)})

    def late_submit():
        time.sleep(0.05)
        q.submit(Ticket(SEARCH, 4, (10, None)), {"queries": np.ones((4, DIM), np.float32)})

    th = threading.Thread(target=late_submit, daemon=True)
    th.start()
    t0 = time.perf_counter()
    b = q.pop_batch()
    took = time.perf_counter() - t0
    th.join(TIMEOUT)
    assert b.n_valid == 8 and b.bucket == 8
    assert took < 0.4, "window did not release on coalesced fill"
    assert q.accounting()["window_waits"] >= 1
    assert q.pop_batch() is None


def case_window_fenced_by_other_op_releases_immediately():
    q = RequestQueue(default_buckets(8, 64), max_wait_ms=500.0)
    q.submit(Ticket(SEARCH, 4, (10, None)), {"queries": np.zeros((4, DIM), np.float32)})
    q.submit(Ticket(INSERT, 4, ()), {"vecs": np.zeros((4, DIM), np.float32),
                                     "vids": np.arange(4, dtype=np.int32)})
    t0 = time.perf_counter()
    b = q.pop_batch()
    assert b.op == SEARCH and time.perf_counter() - t0 < 0.25
    assert q.pop_batch().op == INSERT


def case_window_force_pop_skips_wait():
    q = RequestQueue(default_buckets(8, 64), max_wait_ms=500.0)
    q.submit(Ticket(SEARCH, 2, (10, None)), {"queries": np.zeros((2, DIM), np.float32)})
    t0 = time.perf_counter()
    b = q.pop_batch(force=True)
    assert b.n_valid == 2 and time.perf_counter() - t0 < 0.25


def case_window_expires_and_releases_partial_batch():
    q = RequestQueue(default_buckets(8, 64), max_wait_ms=40.0)
    q.submit(Ticket(SEARCH, 2, (10, None)), {"queries": np.zeros((2, DIM), np.float32)})
    t0 = time.perf_counter()
    b = q.pop_batch()
    assert b.n_valid == 2
    assert time.perf_counter() - t0 >= 0.02, "window never held the under-filled head run"


def case_ratio_policy_fires_every_n_foreground_batches():
    pol = RatioPolicy(ratio=3, budget=8)
    fired = []
    for _ in range(9):
        pol.note_foreground()
        fired.append(pol.want_maintenance(lambda: 99))
    assert fired == [False, False, True] * 3
    assert pol.budget == 8


def case_ratio_policy_zero_disables_maintenance():
    pol = RatioPolicy(ratio=0, budget=8)
    for _ in range(10):
        pol.note_foreground()
        assert not pol.want_maintenance(lambda: 99)
    assert pol.describe() == "ratio:off"


def case_ratio_policy_never_reads_backlog():
    pol = RatioPolicy(ratio=1, budget=4)

    def boom():
        raise AssertionError("ratio policy must not probe the backlog")

    pol.note_foreground()
    assert pol.want_maintenance(boom)


def case_backlog_policy_fires_iff_threshold_reached():
    pol = BacklogPolicy(threshold=2, budget=16)
    backlog = {"v": 0}
    pol.note_foreground()
    assert not pol.want_maintenance(lambda: backlog["v"])
    backlog["v"] = 1
    pol.note_foreground()
    assert not pol.want_maintenance(lambda: backlog["v"])
    backlog["v"] = 2
    pol.note_foreground()
    assert pol.want_maintenance(lambda: backlog["v"])


def case_backlog_policy_rate_limits_probes():
    pol = BacklogPolicy(threshold=1, budget=4, check_every=4)
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        return 5

    fired = 0
    for _ in range(8):
        pol.note_foreground()
        fired += bool(pol.want_maintenance(probe))
    assert calls["n"] == 2 and fired == 2


def case_latency_reservoir_is_bounded_and_counts_all():
    r = _LatReservoir(cap=64, seed=0)
    for i in range(10_000):
        r.add(float(i))
    assert len(r.values()) == 64 and r.n == 10_000
    assert 2000 < float(np.mean(r.values())) < 8000
    m = ServeMetrics(reservoir=32)
    for i in range(500):
        tk = Ticket(SEARCH, 1, ())
        tk.t_done = tk.t_submit + 0.001 * (i + 1)
        m.note_ticket(tk)
    p = m.percentiles(SEARCH)
    assert set(p) == {"p50_ms", "p90_ms", "p99_ms", "p999_ms", "mean_ms", "n"}
    assert p["n"] == 500 and len(m.lat[SEARCH].values()) == 32


def case_checked_lock_knows_its_owner():
    lock = CheckedRLock()
    assert not lock.held_by_me
    with lock:
        with lock:
            assert lock.held_by_me
        assert lock.held_by_me
    assert not lock.held_by_me
    seen = []
    with lock:
        th = threading.Thread(target=lambda: seen.append(lock.held_by_me))
        th.start()
        th.join(TIMEOUT)
    assert seen == [False]


CASES = {f.__name__[5:]: f for f in (
    case_default_buckets_ladder, case_pads_to_bucket_and_accounts_waste,
    case_coalesces_contiguous_same_op_runs_only, case_never_mixes_search_keys,
    case_splits_oversized_requests_into_parts, case_vid_padding_is_minus_one,
    case_requeue_puts_parts_back_at_the_head, case_window_coalesces_head_run,
    case_window_fenced_by_other_op_releases_immediately, case_window_force_pop_skips_wait,
    case_window_expires_and_releases_partial_batch,
    case_ratio_policy_fires_every_n_foreground_batches,
    case_ratio_policy_zero_disables_maintenance, case_ratio_policy_never_reads_backlog,
    case_backlog_policy_fires_iff_threshold_reached, case_backlog_policy_rate_limits_probes,
    case_latency_reservoir_is_bounded_and_counts_all, case_checked_lock_knows_its_owner,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_queue_window_and_policy_cases(case):
    CASES[case]()


@pytest.mark.parametrize("ratio,budget", [(2, 8), (3, 4), (0, 8)])
def test_ratio_policy_fires_as_the_reference(ratio, budget):
    ref, got = RRatioPolicy(ratio, budget), RatioPolicy(ratio, budget)
    for _ in range(12):
        ref.note_foreground()
        got.note_foreground()
        assert got.want_maintenance(lambda: 0) == ref.want_maintenance(lambda: 0)
    assert got.describe() == ref.describe()


def test_backlog_policy_fires_as_the_reference():
    ref, got = RBacklogPolicy(2, 16, check_every=3), BacklogPolicy(2, 16, check_every=3)
    for i in range(15):
        ref.note_foreground()
        got.note_foreground()
        assert got.want_maintenance(lambda: i % 4) == ref.want_maintenance(lambda: i % 4)
    assert (got.probes, got.describe()) == (ref.probes, ref.describe())


# ---------------------------------------------------------------------------
# Cooperative engine: the reference's answers and final state
# ---------------------------------------------------------------------------

def _requests(rng, base):
    fresh = make_shifting_stream(120, DIM, seed=21)
    vids = np.arange(3000, 3120, dtype=np.int32)
    out = []
    for i in range(4):
        out.append(("search", base[rng.integers(0, len(base), 10 + 7 * i)], None))
        out.append(("insert", fresh[30 * i:30 * i + 30], vids[30 * i:30 * i + 30]))
        out.append(("delete", None, np.arange(10 * i, 10 * i + 6, dtype=np.int32)))
        out.append(("search", fresh[30 * i:30 * i + 5], None))
    return out


def _drive(engine, requests):
    tickets = []
    for op, arr, vids in requests:
        if op == "search":
            tickets.append(engine.submit_search(arr))
        elif op == "insert":
            tickets.append(engine.submit_insert(arr, vids))
        else:
            tickets.append(engine.submit_delete(vids))
    return [t.result() for t in tickets]


@pytest.mark.parametrize("scan", ["oracle", "batched"])
def test_cooperative_engine_equals_the_reference(rng, scan):
    base = make_sift_like(1200, DIM, seed=9)
    ridx = RIndex.build(small_cfg(), base)
    tidx = TIndex(convert.state_from_numpy(tcfg(), ref_leaves(ridx.state), device="cpu"))
    knobs = dict(search_k=5, max_batch=64, fg_bg_ratio=0, max_insert_retries=0)
    if scan == "batched":
        knobs.update(use_pallas_scan=True, scan_schedule="batched")
    reng = RServeEngine(ridx, REngineConfig(**knobs))
    teng = ServeEngine(tidx, EngineConfig(**knobs))
    reqs = _requests(rng, base)
    want, got = _drive(reng, reqs), _drive(teng, reqs)
    for (op, arr, _), w, g in zip(reqs, want, got):
        if op == "search":
            wd, wv = w
            gd, gv = g
            # the oracle takes diff² directly; the kernel path expands
            # ||q||² - 2 q.b + ||b||², whose f32 error scales with the terms
            scale = np.abs(wd)
            if scan == "batched":
                scale = scale + np.sum(arr.astype(np.float64) ** 2, axis=1, keepdims=True)
            tol = 1e-5 * scale + 1e-6
            assert (np.abs(gd - wd) <= tol).all()
            swap = gv != wv
            assert (np.abs(gd - wd)[swap] <= tol[swap]).all()
        elif op == "insert":
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
        else:
            assert g is None and w is None
    assert_leaves_equal(tidx.state, ridx.state, close=("telemetry.drift_vec",))
    np.testing.assert_array_equal(teng.backend._pending_access, reng.backend._pending_access)
    assert teng.queue.accounting() == reng.queue.accounting()
    assert teng.report()["maintenance"]["slots"] == 0


def test_engine_search_matches_direct_index(rng):
    base = make_sift_like(1200, DIM, seed=11)
    idx = port_index(base)
    eng = ServeEngine(idx, EngineConfig(search_k=10))
    q = base[rng.integers(0, 1200, 40)]
    d_eng, v_eng = eng.search(q)
    d_ref, v_ref = idx.search(q, 10)
    np.testing.assert_array_equal(d_eng, d_ref)
    np.testing.assert_array_equal(v_eng, v_ref)


# ---------------------------------------------------------------------------
# Engine with maintenance on: the reference's own checks on the port
# ---------------------------------------------------------------------------

def test_engine_tickets_and_metrics():
    base = make_sift_like(1500, DIM, seed=9)
    eng = ServeEngine(port_index(base), EngineConfig(search_k=5, max_batch=64))
    t1 = eng.submit_search(base[:10])
    t2 = eng.submit_insert(make_shifting_stream(30, DIM, seed=10),
                           np.arange(4000, 4030, dtype=np.int32))
    t3 = eng.submit_delete(np.arange(5, dtype=np.int32))
    assert not (t1.done or t2.done or t3.done)
    assert eng.queue.depth_rows == 45
    d, v = t1.result()
    assert t1.done and d.shape == (10, 5)
    assert (v[:, 0] == np.arange(10)).all()
    ids, landed = t2.result()
    assert landed.all() and (ids == np.arange(4000, 4030)).all()
    assert t3.result() is None and t3.done
    rep = eng.report()
    assert rep["search"]["n"] == 1 and rep["insert"]["n"] == 1
    assert rep["queue"]["rows"] == 45 and rep["queue"]["depth_rows_now"] == 0
    assert rep["queue"]["padded_rows"] > 0


@pytest.mark.parametrize("policy", ["ratio", "backlog"])
def test_engine_pipeline_keeps_postings_bounded(policy):
    base = make_sift_like(2000, DIM, seed=5)
    idx = port_index(base)
    pol = BacklogPolicy(threshold=1, budget=16) if policy == "backlog" else None
    eng = ServeEngine(idx, EngineConfig(fg_bg_ratio=2, maintain_budget=8), policy=pol)
    inserts = make_shifting_stream(600, DIM, seed=6)
    ids = np.arange(5000, 5600, dtype=np.int32)
    for s in range(0, 600, 100):
        eng.insert(inserts[s:s + 100], ids[s:s + 100])
    eng.drain()
    assert idx.backlog() == 0
    lens = idx.state.pool.posting_len[idx.state.centroid_valid]
    assert bool((lens <= idx.state.cfg.split_limit).all())
    rep = eng.report()
    assert rep["maintenance"]["policy"].startswith(policy)
    assert rep["maintenance"]["steps"] > 0
    assert eng.latency_percentiles("insert")["n"] == 6


def test_engine_ratio_off_accumulates_backlog_then_drains():
    base = make_sift_like(2000, DIM, seed=5)
    idx = port_index(base)
    eng = ServeEngine(idx, EngineConfig(fg_bg_ratio=0, max_insert_retries=0))
    eng.insert(make_shifting_stream(400, DIM, seed=8), np.arange(6000, 6400, dtype=np.int32))
    assert eng.report()["maintenance"]["slots"] == 0
    eng.drain()
    assert idx.backlog() == 0


def test_drain_equals_the_fused_slots():
    """Fused one-dispatch slots run to quiescence leave the same index as
    one ``drain()`` from the same state (both bounded, same leaves)."""
    base = make_sift_like(1500, DIM, seed=13)
    idx = port_index(base)
    idx.insert(make_shifting_stream(300, DIM, seed=14), np.arange(3000, 3300, dtype=np.int32))
    twin = TIndex(clone_state(idx.state))
    while idx.maintain_fused(8):
        pass
    twin.maintain(jobs_per_round=8)
    for i in (idx, twin):
        assert i.backlog() == 0
        lens = i.state.pool.posting_len[i.state.centroid_valid]
        assert bool((lens <= i.state.cfg.split_limit).all())
    a, b = tensor_leaves(idx.state), tensor_leaves(twin.state)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_engine_empty_requests_are_noops():
    base = make_sift_like(800, DIM, seed=15)
    eng = ServeEngine(port_index(base), EngineConfig(search_k=7))
    d, v = eng.submit_search(np.zeros((0, DIM), np.float32)).result()
    assert d.shape == (0, 7) and v.shape == (0, 7)
    ids, landed = eng.submit_insert(np.zeros((0, DIM), np.float32),
                                    np.zeros(0, np.int32)).result()
    assert ids.shape == (0,) and landed.shape == (0,)
    assert eng.submit_delete(np.zeros(0, np.int32)).result() is None
    eng.delete(np.zeros(0, np.int32))
    assert eng.queue.accounting()["batches"] == 0


def test_submit_search_explicit_zero_k_nprobe_not_replaced(rng):
    base = make_clustered(rng, 400, DIM)
    eng = ServeEngine(port_index(base), EngineConfig(search_k=10, nprobe=8))
    empty = np.zeros((0, DIM), np.float32)
    t = eng.submit_search(empty, k=0, nprobe=0)
    assert t.key == (0, 0)
    d, v = t.result()
    assert d.shape == (0, 0) and v.shape == (0, 0)
    assert eng.submit_search(empty).key == (10, 8)


def test_insert_backpressure_exhaustion_counts_drops(rng, caplog):
    base = make_clustered(rng, 400, DIM)
    eng = ServeEngine(port_index(base), EngineConfig(max_insert_retries=2))

    def never_lands(vecs, vids, valid):
        return np.asarray(vids).copy(), np.zeros(len(vids), bool)

    eng.backend.insert = never_lands
    eng.backend.maintain = lambda budget: 0
    tk = eng.submit_insert(make_clustered(rng, 4, DIM), np.arange(4, dtype=np.int32))
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        ids, landed = tk.result()
    assert not landed.any()
    assert tk.dropped == 4 and eng.metrics.insert_dropped == 4
    assert eng.report()["insert_retries"] == 2
    assert any("backpressure exhausted" in r.message for r in caplog.records)


def test_recorded_dispatch_stream_replays_bit_identically():
    base = make_sift_like(1500, DIM, seed=17)
    idx = port_index(base)
    before = clone_state(idx.state)
    eng = ServeEngine(idx, EngineConfig(search_k=5, fg_bg_ratio=2, maintain_budget=4))
    sink = RecordingSink()
    eng.backend.attach_replication(sink)
    fresh = make_shifting_stream(400, DIM, seed=18)
    for s in range(0, 400, 80):
        eng.search(base[s:s + 20])
        eng.insert(fresh[s:s + 80], np.arange(4000 + s, 4080 + s, dtype=np.int32))
        eng.delete(np.arange(s // 4, s // 4 + 10, dtype=np.int32))
    eng.drain()
    ops = [r.op for r in sink.records]
    assert "maintain" in ops and ops[-1] == "drain"
    assert [r.seqno for r in sink.records] == list(range(len(ops)))
    assert eng.backend.wal_seqnos() == [len(ops) - 1]
    assert int(sink.records[-1].payload["access"].sum()) >= 0
    twin = LocalBackend(TIndex(before), track_access=False)
    assert twin.replay(sink.records) == len(ops)
    assert twin.replay(sink.records, after_seqno=len(ops) - 1) == 0
    a, b = tensor_leaves(idx.state), tensor_leaves(twin.index.state)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad
    clone = eng.backend.clone()
    assert clone._wal_applied == eng.backend._wal_applied and not clone.track_access
    assert clone.index.state.pool.blocks is not idx.state.pool.blocks


def test_search_access_telemetry_folds_into_the_next_maintain():
    base = make_sift_like(1000, DIM, seed=19)
    eng = ServeEngine(port_index(base), EngineConfig(search_k=5, min_bucket=8))
    sink = RecordingSink()
    eng.backend.attach_replication(sink)
    eng.search(base[:3])                      # 3 real rows in a bucket of 8
    pending = eng.backend._pending_access.copy()
    assert pending.sum() == 3 * eng.index.state.cfg.nprobe
    eng.drain()
    np.testing.assert_array_equal(sink.records[-1].payload["access"], pending)
    assert eng.backend._pending_access.sum() == 0


def test_port_lifecycle_parts_not_yet_ported_raise(tmp_path):
    """Nothing of the lifecycle raises any more: an engine takes read
    replicas (``replicas=``, reported under ``report()["replicas"]``), and
    the durable lifecycle is real: attach a one-log WalSet, log dispatches
    into it, checkpoint (base, then delta), and replay the tail on the
    snapshot."""
    from repro_torch.distributed.replication import ReplicaSet
    from repro_torch.storage.snapshot import SnapshotStore
    from repro_torch.storage.wal import WalSet, iter_wal

    base = make_sift_like(400, DIM, seed=20)
    idx = port_index(base)
    rbe = LocalBackend(port_index(base))
    rs = ReplicaSet(rbe, [rbe.clone()])
    eng = ServeEngine(rbe, replicas=rs)
    assert eng.report()["replicas"]["n_replicas"] == 2 and eng.replicas is rs
    eng.shutdown()
    be = LocalBackend(idx)
    with pytest.raises(ValueError, match="2 logs"):
        be.attach_durability(WalSet(str(tmp_path / "wal2"), 2))
    ws = WalSet(str(tmp_path / "wal"), 1)
    be.attach_durability(ws)
    assert be.wal_seqnos() == [-1]
    snap = str(tmp_path / "snap")
    assert be.checkpoint(snap).startswith("base-")
    fresh = make_sift_like(40, DIM, seed=21)
    be.insert(fresh[:32], np.arange(3000, 3032, dtype=np.int32), np.ones(32, bool))
    be.delete(np.arange(3000, 3004, dtype=np.int32), np.ones(4, bool))
    assert be.wal_seqnos() == [1]
    assert [r.op for r in iter_wal(ws.shard_path(0))] == ["insert", "delete"]
    assert bool(idx.state.pool.dirty.any())
    assert be.checkpoint(snap, delta=True).startswith("delta-")
    assert list(iter_wal(ws.shard_path(0))) == [] and not bool(be.index.state.pool.dirty.any())
    be.maintain(2)
    tail = list(iter_wal(ws.shard_path(0)))
    assert [r.seqno for r in tail] == [2]
    store = SnapshotStore(snap)
    assert store.chain_len() == 1 and store.read_manifest()["extra"]["wal_seqnos"] == [1]
    from repro_torch.core.types import make_empty_state
    state, _ = store.load(make_empty_state(idx.state.cfg, device="meta"), device="cpu")
    twin = LocalBackend(TIndex(state), track_access=False)
    assert twin.replay(tail, after_seqno=1) == 1
    a, b = tensor_leaves(be.index.state), tensor_leaves(twin.index.state)
    assert not [k for k in a if not torch.equal(a[k], b[k])]
    be.wal_sync()
    be.close()


# ---------------------------------------------------------------------------
# Async pump
# ---------------------------------------------------------------------------

def _async_engine(rng, n_base=600, **cfg_kw):
    base = make_clustered(rng, n_base, DIM, n_clusters=4)
    cfg = dict(search_k=10, max_batch=32, min_bucket=8, policy="ratio", fg_bg_ratio=2,
               maintain_budget=4, async_serve=True, lock_check=True)
    cfg.update(cfg_kw)
    return ServeEngine(port_index(base), EngineConfig(**cfg)), base


def test_async_engine_roundtrip_and_shutdown(rng):
    eng, base = _async_engine(rng)
    try:
        assert eng.is_async and eng.report()["async"]
        d, v = eng.submit_search(base[:4], k=5).result(timeout=TIMEOUT)
        assert v.shape == (4, 5) and (v[:, 0] == np.arange(4)).all()
        vecs = make_clustered(rng, 8, DIM)
        ids = np.arange(5000, 5008, dtype=np.int32)
        got_ids, landed = eng.submit_insert(vecs, ids).result(timeout=TIMEOUT)
        assert landed.all() and (got_ids == ids).all()
        _, hit = eng.submit_search(vecs, k=3).result(timeout=TIMEOUT)
        assert (hit[:, 0] == ids).all()
    finally:
        eng.shutdown(timeout=TIMEOUT)
    assert not eng.is_async
    _, hit = eng.search(vecs[:2], k=1)
    assert (hit[:, 0] == ids[:2]).all()


def test_async_pump_error_surfaces_at_result(rng):
    eng, _ = _async_engine(rng)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected backend failure")

        eng.backend.insert = boom
        tk = eng.submit_insert(make_clustered(rng, 4, DIM), np.arange(4, dtype=np.int32))
        with pytest.raises(RuntimeError, match="pump thread died"):
            tk.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="pump thread died"):
            eng.submit_search(np.zeros((1, DIM), np.float32))
    finally:
        object.__setattr__(eng, "_pump_error", None)
        eng.shutdown(timeout=TIMEOUT)


def test_async_lock_check_refuses_writes_off_the_ownership_map(rng):
    eng, _ = _async_engine(rng)
    try:
        with pytest.raises(LockDisciplineError, match="guarded"):
            eng._maint_due = 3
        with pytest.raises(LockDisciplineError, match="init-only"):
            eng.cfg = None
        with pytest.raises(LockDisciplineError, match="pump-thread-only"):
            eng._busy = True
        with eng.exclusive():
            eng._maint_due = 0
    finally:
        eng.shutdown(timeout=TIMEOUT)


def test_async_multithreaded_stress_counts_ordering_apart_from_misses(rng):
    eng, base = _async_engine(rng, n_base=800, max_wait_ms=1.0)
    st0 = eng.stats()
    before = clone_state(eng.index.state)
    sink = RecordingSink()
    eng.backend.attach_replication(sink)

    def vecs_for(trng, m):
        return make_clustered(trng, m, DIM, n_clusters=4)

    try:
        tally, live, dead = chip_smoke.async_clients(
            np, eng, vecs_for, 4, 60, vid0=2000, stride=1000, max_rows=4, pool=base,
            nprobe=32)
        eng.pump()
        assert eng._pump_error is None
        assert tally["violations"] == 0 and tally["resurrected"] == 0
        assert tally["misses"] <= 0.05 * tally["checks"], tally
        st = eng.stats()
        ins = [r for r in sink.records if r.op == "insert"]
        dels = [r for r in sink.records if r.op == "delete"]
        assert st["n_inserts"] - st0["n_inserts"] == sum(int(r.payload["valid"].sum()) for r in ins)
        assert sum(int(r.payload["valid"].sum()) for r in ins) >= len(live) + len(dead)
        assert st["n_deletes"] - st0["n_deletes"] == len(dead)
        assert sum(int(r.payload["valid"].sum()) for r in dels) == len(dead)
        assert eng.report()["insert_dropped"] == 0
        gone = sorted(dead)
        _, hit = eng.submit_search(np.stack([dead[v] for v in gone]), k=5,
                                   nprobe=32).result(timeout=TIMEOUT)
        assert not set(gone) & set(hit.reshape(-1).tolist()), "delete resurrected"
        _, hit = eng.submit_search(np.stack([live[v] for v in sorted(live)]), k=5,
                                   nprobe=32).result(timeout=TIMEOUT)
        found = np.mean([v in row for v, row in zip(sorted(live), hit.tolist())])
        assert found >= 0.95, "survivors lost"
    finally:
        eng.shutdown(timeout=TIMEOUT)
    twin = LocalBackend(TIndex(before), track_access=False)
    twin.replay(sink.records)
    a, b = tensor_leaves(eng.index.state), tensor_leaves(twin.index.state)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad


# ---------------------------------------------------------------------------
# The engine over a sharded index (the reference's serve_sharded_script.py)
# ---------------------------------------------------------------------------

def test_engine_over_a_two_shard_index():
    """The same ServeEngine drives the sharded backend through the same
    micro-batched padded pipeline: batched search against brute force,
    inserts that come back with ``(shard, slot)`` handles and are found,
    deletes by handle, maintenance slots, the report and stats, and the
    backlog policy."""
    from repro_torch.distributed.sharded_index import ShardedIndex

    cfg = TConfig(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=1024,
                  num_postings_cap=128, num_vectors_cap=4096, split_limit=48, merge_limit=6,
                  reassign_range=8, reassign_budget=128, replica_count=2, nprobe=8)
    rng = np.random.default_rng(0)
    base = make_clustered(rng, 1200, DIM, n_clusters=10)
    sidx, handles = ShardedIndex.build(cfg, base, 2, device="cpu")
    engine = ServeEngine(sidx, EngineConfig(search_k=10, max_batch=64, min_bucket=16))
    assert engine.index is None                     # no single index
    queries = base[rng.integers(0, len(base), 48)] + 0.01 * rng.normal(
        size=(48, DIM)).astype(np.float32)
    d, v = engine.submit_search(queries).result(timeout=TIMEOUT)
    assert d.shape == (48, 10) and v.shape == (48, 10)
    bf = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = handles[np.argsort(bf, axis=1)[:, :10]]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), v.tolist())])
    assert recall > 0.85, recall

    new = make_clustered(rng, 40, DIM, n_clusters=3)
    new_h, landed = engine.submit_insert(new, np.full(40, -1, np.int32)).result(timeout=TIMEOUT)
    assert landed.all() and (new_h >= 0).all()
    _, v2 = engine.search(new)
    assert sum(int(new_h[i]) in v2[i].tolist() for i in range(40)) >= 36
    engine.delete(new_h[:20])
    _, v3 = engine.search(new[:20])
    assert not set(new_h[:20].tolist()) & set(v3.reshape(-1).tolist())

    engine.drain()
    rep = engine.report()
    assert rep["queue"]["depth_rows_now"] == 0 and rep["backlog"] == 0
    assert rep["queue"]["rows"] >= 48 + 40 + 20 + 40
    st = engine.stats()
    assert st["n_shards"] == 2 and st["n_inserts"] >= 40

    eng2 = ServeEngine(sidx, EngineConfig(search_k=10, max_batch=64),
                       policy=BacklogPolicy(threshold=1, budget=8))
    more = make_clustered(rng, 120, DIM, n_clusters=2)
    for s in range(0, 120, 40):
        eng2.insert(more[s:s + 40], np.full(40, -1, np.int32))
    eng2.drain()
    assert eng2.backend.backlog() == 0
