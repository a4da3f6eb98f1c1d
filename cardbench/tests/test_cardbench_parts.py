"""The harness's parts on the CPU: the frozen data, the generator's timing,
the roofline arithmetic, the reference."""
from __future__ import annotations

import hashlib
import math
import threading
import time

import numpy as np
import pytest
import torch

from conftest import SEED


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def test_frozen_data_reproduces_its_digests():
    from cardbench import data

    x = data.spacev_like_bytes(3000, 100, SEED)
    q = data.queries_near(x[:2000], 256, SEED)
    assert (_digest(x), _digest(q)) == ("cbd123af97167a9e", "d86e26d2d2128cc7")
    assert np.array_equal(x, np.round(x)) and np.abs(x).max() <= 127


def test_frozen_data_matches_the_port_it_was_copied_from():
    from repro_torch.data import vectors

    from cardbench import data

    x = data.spacev_like_bytes(3000, 100, 5)
    assert np.array_equal(x, vectors.make_spacev_like_bytes(3000, 100, seed=5))
    assert np.array_equal(data.queries_near(x, 64, 5), vectors.make_queries(x, 64, seed=5))


def test_every_seed_gets_the_same_sizes_and_gaps_in_another_order():
    from cardbench import generator

    spec = {"dist": "log_uniform", "min": 16, "max": 256}
    a, b = generator.row_sizes(spec, 1), generator.row_sizes(spec, 2)
    assert not np.array_equal(a, b) and np.array_equal(np.sort(a), np.sort(b))
    assert a.min() == 16 and a.max() == 256 and 84 < a.mean() < 90
    g1, g2 = generator.poisson_gaps(50.0, 1), generator.poisson_gaps(50.0, 2)
    assert np.array_equal(np.sort(g1), np.sort(g2))
    assert abs(g1.mean() - 1 / 50.0) < 1e-3


class _Ticket:
    def __init__(self, ready, out):
        self._ready, self._out, self.seqno = ready, out, 0

    def result(self, timeout=None):
        assert self._ready.wait(timeout)
        return self._out


class _StallingEngine:
    """Answers every ticket at once, except during ``stall``: a window in
    which nothing is answered, as a long maintenance slot would."""

    def __init__(self, stall):
        self.stall = stall

    def _ticket(self, out):
        ready = threading.Event()
        delay = max(0.0, self.stall[1] - time.perf_counter()) \
            if self.stall[0] <= time.perf_counter() < self.stall[1] else 0.0
        threading.Timer(delay, ready.set).start()
        return _Ticket(ready, out)

    def submit_search(self, q):
        return self._ticket((np.zeros((len(q), 10)), np.zeros((len(q), 10), int)))

    def submit_insert(self, v, ids):
        return self._ticket((ids, np.ones(len(ids), bool)))

    def submit_delete(self, ids):
        return self._ticket(None)


def test_open_loop_times_each_request_from_when_it_was_due():
    from cardbench import generator

    base = np.zeros((100, 4), np.float32)
    dat = {"base": base, "pool": base, "queries": base}
    mix = {"search": {"loop": "open", "rate_per_s": 200.0,
                      "rows": {"dist": "fixed", "min": 4, "max": 4}},
           "ingest": {"rate_per_s": 20.0, "insert_rows": 2, "delete_rows": 2}}
    t0 = time.perf_counter() + 0.05
    stall = (t0 + 0.3, t0 + 0.6)
    tr = generator.Traffic(_StallingEngine(stall), mix, dat, SEED)
    tr.start(t0, t0 + 1.0)
    tr.finish()
    due = np.array([r.due for r in tr.log])
    assert len(tr.log) > 150 and (np.diff(sorted(due)) >= 0).all()
    assert all(r.sent >= r.due for r in tr.log)           # never sent early
    caught = [r for r in tr.log if stall[0] + 0.05 <= r.due < stall[1] - 0.05]
    assert caught
    for r in caught:            # the stall counts in full from the due time
        assert r.latency_s >= stall[1] - r.due - 0.01
    assert {r.kind for r in tr.log} == {"search", "insert", "delete"}
    ins = [r for r in tr.log if r.kind == "insert"]
    assert np.array_equal(np.concatenate([r.arg for r in ins]),
                          100 + np.arange(2 * len(ins)))   # pool rows in order


def test_roofline_arithmetic_against_a_hand_count():
    from cardbench import roofline

    # Q=2 queries, 3 live centroids, d=4, k=2: 2*2*3*4 operations; queries
    # 2*4*4 B, centroids 3*4*4 B, norms 3*4 B, 2*2 (distance, id) pairs of 8 B
    assert roofline.l2_topk(2, 3, 4, 2) == (48.0, 32 + 48 + 12 + 32)
    # 5 pages of 2 slots, 3 queries, d=4, int8: 2*5*3*2*4 operations; pages
    # 5*2*4 B, queries 3*4*4 B, 3*2 results of 8 B; q8 adds 5 pairs of 8 B
    assert roofline.scan_batched(5, 3, 2, 4, 1, 2) == (240.0, 40 + 48 + 48)
    assert roofline.scan_batched(5, 3, 2, 4, 1, 2, q8=True) == (240.0, 40 + 48 + 48 + 40)
    assert roofline.least_s(495e12, 1.0, roofline.TF32_FLOP_PER_S) == 1.0
    assert roofline.least_s(1.0, 3.35e12, roofline.TF32_FLOP_PER_S) == 1.0


def test_template_arguments_tell_the_batched_scans_apart():
    from cardbench.readers import template_args

    name = "void scan_batched_topk_tc<signed char, 16, true, false>(int const*, float const*)"
    assert template_args(name) == ["signed char", "16", "true", "false"]
    assert template_args("l2_topk_tiles_kernel(float const*)") == []


def test_reference_against_brute_force_over_changing_live_sets():
    from cardbench import reference

    rng = np.random.default_rng(0)
    base = rng.integers(-20, 20, (300, 8)).astype(np.float32)
    pool = rng.integers(-20, 20, (50, 8)).astype(np.float32)
    live = reference.LiveSets(base, pool, 45)
    live.insert(np.arange(300, 320), np.ones(20, bool), 3)
    live.insert(np.arange(320, 345), np.arange(25) < 20, 7)     # the last 5 did not land
    live.delete(np.arange(0, 30), 5)
    q = rng.normal(0, 10, (64, 8)).astype(np.float32)
    seq = rng.integers(0, 10, 64)
    d, v = reference.exact_topk(live, q, seq, 10, device="cpu")
    allv = np.concatenate([base, pool[:45]]).astype(np.float64)
    for i in range(64):
        ok = np.array([(j < 300 and not (j < 30 and seq[i] >= 5)) or (300 <= j < 320 and seq[i] >= 3)
                       or (320 <= j < 340 and seq[i] >= 7) for j in range(345)])
        dd = ((allv - q[i].astype(np.float64)) ** 2).sum(1)
        dd[~ok] = np.inf
        assert set(v[i].tolist()) == set(np.argsort(dd, kind="stable")[:10].tolist())
        assert np.allclose(np.sort(dd)[:10], d[i], rtol=1e-5, atol=1e-3)
    assert live.may_return(np.array([342, 29]), 7).tolist() == [True, False]
    assert live.may_return(np.array([342, 29]), 4).tolist() == [False, True]
    ex, scale = reference.exact_dists(live, q, v)
    assert np.allclose(ex, d, rtol=1e-5, atol=1e-3) and (scale > 0).all()
    assert math.isnan(reference.exact_dists(live, q[:1], np.array([[-1]]))[0][0, 0])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from cardbench import reference

    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.14159265, -7.5e-3])
    got = reference.to_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10 and got[2] == 1.0
    assert torch.all((got - x).abs() <= x.abs() * 2.0 ** -11)


def test_device_busy_union_and_idle_by_host_span():
    from cardbench import trace

    spans = np.array([[1_000, 90_000], [50_000, 150_000], [260_000, 265_000]], np.int64)
    runs = trace.busy_runs(spans)
    assert runs.tolist() == [[1_000, 150_000], [260_000, 265_000]]
    # window 0-400 us in 100 us bins: a paints bin 0 (1 us idle), no span
    # bin 1 (50 us idle), b bins 2-3 (195 us idle)
    idle = trace.idle_by_span(runs, [("a", 0.0, 100e-6), ("b", 200e-6, 400e-6)], 0, 400_000)
    assert idle == pytest.approx({"a": 1e-6, "engine_other": 50e-6, "b": 195e-6})
    assert sum(idle.values()) == pytest.approx(400e-6 - 149e-6 - 5e-6)


def _req(kind, due, done, sent=None, landed=True):
    from cardbench import generator

    r = generator.Request(kind, due, 1, np.zeros(1, np.int32))
    r.sent = due if sent is None else sent
    r.done = done
    if kind == "insert":
        r.out = (np.zeros(1, np.int32), np.array([landed]))
    return r


def _trial_log(fault):
    """A 10-second trial: a search every 0.05 s, an insert and a delete every
    0.5 s, each answered 0.02 s after it was due, but for ``fault``."""
    log = []
    for i in range(200):
        t = i * 0.05
        log.append(_req("search", t, t + 0.02))
    for i in range(20):
        t = i * 0.5
        grows = fault == "updates_queue" and t >= 5.0
        done = t + 0.02 + (t - 5.0) * 0.8 if grows else t + 0.02
        log.append(_req("insert", t, done, landed=not (fault == "insert_dropped" and i % 5 == 0)))
        log.append(_req("delete", t, done))
    if fault == "searches_late":
        for r in log[:10]:
            r.done = math.nan
    return log


@pytest.mark.parametrize("fault, passes", [
    (None, True),
    ("updates_queue", False),        # searches keep up, updates fall behind
    ("insert_dropped", False),       # acknowledged, a fifth of the rows never landed
    ("searches_late", False),
])
def test_knee_test_holds_searches_inserts_and_deletes(fault, passes):
    from cardbench import sweep

    res = sweep.knee(_trial_log(fault), 0.0, 10.0)
    assert res["pass"] is passes, res
    assert set(res) == {"search", "insert", "delete", "pass"}


def _open_small(cfg, tmp_path):
    from conftest import small_config

    from cardbench import data, system

    cfg = small_config(cfg)
    dat = data.make(cfg, SEED)
    return system.open_service(cfg, dat["base"], SEED, "cpu", workdir=tmp_path), dat


def test_a_durable_configuration_opens_a_durable_service(tmp_path):
    """A configuration file's ``durability`` section is served: its relative
    root lies under the work directory, every update goes through the WAL,
    and its ticket carries the log's seqno."""
    from conftest import ROOT

    from cardbench import spec

    cfg = spec.Benchmark(ROOT).config("spacev-shard")
    cfg["durability"] = {"root": "wal_root", "checkpoint_on_close": False}
    svc, dat = _open_small(cfg, tmp_path)
    try:
        assert svc.spec.durability.enabled and svc.backend.wal_set is not None
        assert (tmp_path / "spacev-shard" / "wal_root" / "wal").is_dir()
        vids = np.arange(2000, 2016, dtype=np.int32)
        t = svc.engine.submit_insert(dat["pool"][:16], vids)
        t.result(timeout=60.0)
        svc.engine.barrier()
        assert t.seqno is not None and t.seqno >= 0
        assert svc.backend.wal_set.next_seqno > 0
    finally:
        svc.close()


@pytest.mark.parametrize("edit, error", [
    (lambda c: c.update(replicas={"n": 2}), ValueError),          # a key no one reads
    (lambda c: c["durability"].update(fsync_every=1), TypeError),  # not the spec's
    (lambda c: c.update(shards={"n_shards": 4}), NotImplementedError),
])
def test_a_configuration_the_harness_cannot_serve_is_refused(edit, error, tmp_path):
    from conftest import ROOT

    from cardbench import spec

    cfg = spec.Benchmark(ROOT).config("spacev-shard")
    cfg["durability"] = {}
    edit(cfg)
    with pytest.raises(error):
        _open_small(cfg, tmp_path)
