"""The port's span recorder (``repro_torch.utils.trace``) on the CPU: off it
records nothing, reads no clock at a span site and leaves every result
bit for bit as it was; on, a served search, an insert and a maintenance
round give their spans with the right parents, batch ids and clock; and
``scripts/spans_on_card.py``'s readings of them."""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.index import SPFreshIndex
from repro_torch.core.types import LireConfig
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.serve.queue import SEARCH, RequestQueue, Ticket, default_buckets
from repro_torch.utils import trace
from repro_torch.utils.tree import clone_state, tensor_leaves

ROOT = Path(__file__).resolve().parents[1]
DIM = 16
TIMEOUT = 120
SEARCH_CHILDREN = ("search.upload", "search.navigate", "search.pages", "search.scan",
                   "search.gather", "search.topk", "search.readback_enqueue")
ROUND_CHILDREN = ("round.select", "round.split", "round.merge", "round.reassign",
                  "round.readback")


def _cfg(**kw) -> LireConfig:
    args = dict(dim=DIM, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                num_postings_cap=256, num_vectors_cap=8192, split_limit=48, merge_limit=6,
                reassign_range=8, reassign_budget=128, replica_count=2, nprobe=8,
                use_pallas_nav=True, use_pallas_scan=True, scan_schedule="batched",
                scan_page_budget=512)
    args.update(kw)
    return LireConfig(**args)


def _clustered(rng, n, n_clusters=6, spread=0.05):
    centers = rng.normal(size=(n_clusters, DIM)).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, size=n)]
    return (x + spread * rng.normal(size=(n, DIM))).astype(np.float32)


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    base = _clustered(rng, 900)
    return SPFreshIndex.build(_cfg(), base, device="cpu").state, base


def _index(built):
    return SPFreshIndex(clone_state(built[0]))


def _ops(idx, base):
    """A search, an insert that overfills postings and a maintenance round;
    their outputs."""
    rng = np.random.default_rng(9)
    valid = np.ones(32, bool)
    valid[-5:] = False
    d, v = idx.search_padded(base[:32], 10, qvalid=valid)
    near = np.repeat(base[:4], 40, axis=0) + 0.01 * rng.normal(size=(160, DIM))
    landed = idx.insert_padded(near.astype(np.float32), np.arange(5000, 5160, dtype=np.int32),
                               np.ones(160, bool))
    idx.delete_padded(np.arange(0, 16, dtype=np.int32), np.ones(16, bool))
    did = idx.maintain_round(4)
    return d, v, landed, did


def test_off_records_nothing_and_reads_no_clock_at_a_span_site(built, monkeypatch):
    reads = []

    class Clock:
        @staticmethod
        def perf_counter_ns():
            reads.append(1)
            return time.perf_counter_ns()

    monkeypatch.setattr(trace, "time", Clock)
    idx = _index(built)
    _ops(idx, built[1])
    idx.maintain(jobs_per_round=4)
    assert reads == [] and trace.take() == []
    # every site shares one no-op context: nothing is allocated
    assert trace.span("search") is trace.span("round", tag="x")
    # a timed site reads its two clock reads for its counter, and records nothing
    with trace.timed("engine.maintain", tag="idle") as t:
        pass
    assert len(reads) == 2 and t.seconds >= 0 and trace.take() == []


def test_results_are_bitwise_equal_with_the_recorder_off_and_on(built):
    outs, states = [], []
    for on in (False, True):
        if on:
            trace.enable()
        idx = _index(built)
        outs.append(_ops(idx, built[1]))
        idx.maintain(jobs_per_round=4)
        states.append(idx.state)
        trace.disable()
    assert trace.take(), "the recorder recorded nothing while on"
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    leaves = [tensor_leaves(st) for st in states]
    assert list(leaves[0]) == list(leaves[1])
    for name, a in leaves[0].items():
        assert torch.equal(a, leaves[1][name]), name


def test_int8_search_with_rerank_gives_its_rerank_span(built):
    rng = np.random.default_rng(2)
    base = _clustered(rng, 600)
    idx = SPFreshIndex.build(_cfg(codec="int8", rerank_factor=4, vector_dtype="float32"),
                             base, device="cpu")
    ref = idx.search_padded(base[:16], 10)
    trace.enable()
    got = idx.search_padded(base[:16], 10)
    trace.disable()
    assert all(np.array_equal(a, b) for a, b in zip(ref, got))
    names = [s.name for s in trace.take()]
    assert {"search.topk", "search.rerank", "search.scan"} <= set(names)


def test_async_search_yields_form_dispatch_search_and_its_children(built):
    eng = ServeEngine(_index(built), EngineConfig(search_k=10, max_batch=64, min_bucket=8,
                                                  async_serve=True, max_wait_ms=1.0))
    try:
        eng.submit_search(built[1][:4]).result(timeout=TIMEOUT)    # warm
        eng.barrier()
        trace.enable()
        t0 = time.perf_counter_ns()
        eng.submit_search(built[1][:20]).result(timeout=TIMEOUT)
        eng.barrier()
        eng.shutdown()      # closes the pump's last idle wait
        t1 = time.perf_counter_ns()
    finally:
        trace.disable()
        eng.shutdown()
    spans = trace.take()
    by_id = {s.id: s for s in spans}
    dispatch = [s for s in spans if s.name == "engine.dispatch"]
    assert len(dispatch) == 1 and dispatch[0].tag == SEARCH and dispatch[0].parent is None
    bid = dispatch[0].batch
    form = [s for s in spans if s.name == "engine.form" and s.batch == bid]
    assert len(form) == 1 and form[0].end_ns <= dispatch[0].start_ns
    (search,) = [s for s in spans if s.name == "search"]
    assert search.parent == dispatch[0].id and search.batch == bid
    kids = [s for s in spans if s.parent == search.id]
    assert [s.name for s in kids] == list(SEARCH_CHILDREN)
    assert all(s.batch == bid and s.thread == search.thread for s in kids)
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    (land,) = [s for s in spans if s.name == "engine.land"]
    assert land.batch == bid and land.start_ns >= dispatch[0].end_ns
    # on the CPU the results are on the host already: no readback to wait for
    assert [s.name for s in spans if s.parent == land.id] == ["engine.scatter"]
    (wait,) = [s for s in spans if s.name == "queue.wait" and s.batch == bid]
    assert wait.tag == SEARCH and wait.end_ns <= form[0].end_ns


def test_self_time_is_length_less_what_children_cover():
    trace.enable()
    with trace.span("outer"):
        with trace.span("a"):
            time.sleep(0.002)
        time.sleep(0.001)
        with trace.span("b"):
            with trace.span("b.inner"):
                time.sleep(0.001)
    trace.disable()
    spans = {s.name: s for s in trace.take()}
    own = trace.self_ns(list(spans.values()))
    length = {n: s.end_ns - s.start_ns for n, s in spans.items()}
    assert own[spans["outer"].id] == length["outer"] - length["a"] - length["b"]
    assert own[spans["b"].id] == length["b"] - length["b.inner"]
    assert own[spans["a"].id] == length["a"] and own[spans["b.inner"].id] == length["b.inner"]
    # children that overlap count once
    s = [trace.Span("p"), trace.Span("c1"), trace.Span("c2")]
    for sp, (i, a, b, parent) in zip(s, [(1, 0, 100, None), (2, 10, 50, 1), (3, 40, 70, 1)]):
        sp.id, sp.start_ns, sp.end_ns, sp.parent = i, a, b, parent
    assert trace.self_ns(s)[1] == 100 - 60


@pytest.mark.parametrize("how", ["maintain_round", "drain"])
def test_a_round_yields_its_phases_and_its_readback(built, how):
    idx = _index(built)
    rng = np.random.default_rng(3)
    near = np.repeat(built[1][:4], 40, axis=0) + 0.01 * rng.normal(size=(160, DIM))
    idx.insert_padded(near.astype(np.float32), np.arange(6000, 6160, dtype=np.int32),
                      np.ones(160, bool))
    trace.enable()
    if how == "maintain_round":
        idx.maintain_round(4)
    else:
        idx.maintain(jobs_per_round=4)
    trace.disable()
    spans = trace.take()
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == 1 if how == "maintain_round" else len(rounds) > 1
    for r in rounds:
        assert r.parent is None
        assert [s.name for s in spans if s.parent == r.id] == list(ROUND_CHILDREN)
        (rb,) = [s for s in spans if s.parent == r.id and s.name == "round.readback"]
        assert rb.end_ns <= r.end_ns


def test_queue_waits_end_at_their_batch_formation():
    q = RequestQueue(default_buckets(8, 64))
    tickets = [Ticket(SEARCH, n, (10, 8)) for n in (5, 9, 70)]
    for t, n in zip(tickets, (5, 9, 70)):
        q.submit(t, {"queries": np.zeros((n, DIM), np.float32)})
    trace.enable()
    batches = []
    for _ in range(2):
        with trace.span("engine.form"):
            batches.append(q.pop_batch())
    trace.disable()
    spans = trace.take()
    forms = [s for s in spans if s.name == "engine.form"]
    assert [f.batch for f in forms] == [b.id for b in batches] == [1, 2]
    for f, b in zip(forms, batches):
        waits = [s for s in spans if s.name == "queue.wait" and s.batch == b.id]
        assert len(waits) == len(b.parts) and all(w.tag == SEARCH for w in waits)
        assert len({w.end_ns for w in waits}) == 1
        assert f.start_ns <= waits[0].end_ns <= f.end_ns
        for w, p in zip(waits, b.parts):
            assert w.start_ns == round(p.t_enq * 1e9) and w.parent is None


def test_engine_timers_read_their_span(built):
    """The maintenance slot, the drain and an insert's backpressure stall
    take their counters from the span at their boundary; the stall's span
    holds its maintenance slot."""
    eng = ServeEngine(_index(built), EngineConfig(search_k=10, max_batch=64, policy="ratio",
                                                  fg_bg_ratio=1, maintain_budget=4))
    rng = np.random.default_rng(4)
    near = np.repeat(built[1][:2], 40, axis=0) + 0.01 * rng.normal(size=(80, DIM))
    trace.enable()
    eng.insert(near.astype(np.float32), np.arange(7000, 7080, dtype=np.int32))
    eng.drain()
    trace.disable()
    spans = trace.take()
    slots = [s for s in spans if s.name == "engine.maintain"]
    drains = [s for s in spans if s.name == "engine.drain"]
    assert slots and len(drains) == 1
    m = eng.metrics
    assert m.maint_time_s == pytest.approx(sum(s.seconds for s in slots + drains), abs=1e-12)
    assert {s.tag for s in slots} == {"inline", "backpressure"} and m.insert_retries >= 1
    stalls = [s for s in spans if s.name == "engine.stall"]
    assert len(stalls) == m.insert_retries
    assert m.insert_stall_s == pytest.approx(sum(s.seconds for s in stalls), abs=1e-12)
    held = {s.parent for s in slots if s.tag == "backpressure"}
    assert held == {s.id for s in stalls}


# ---------------------------------------------------------------------------
# scripts/spans_on_card.py's readings
# ---------------------------------------------------------------------------

def _script():
    spec = importlib.util.spec_from_file_location("spans_on_card",
                                                  ROOT / "scripts" / "spans_on_card.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, a, b, i, parent=None, tag=None):
    s = trace.Span(name, tag=tag)
    s.start_ns, s.end_ns, s.id, s.parent = a, b, i, parent
    return s


def test_readings_of_synthetic_spans():
    mod = _script()
    ms = 1_000_000
    spans = [
        _span("engine.dispatch", 10 * ms, 20 * ms, 1),
        _span("search", 11 * ms, 19 * ms, 2, parent=1),
        _span("search.scan", 12 * ms, 14 * ms, 3, parent=2),
        _span("search", 200 * ms, 204 * ms, 4),                 # outside the window
        _span("queue.wait", 2 * ms, 10 * ms, 5, tag="search"),
        _span("queue.wait", 0, 10 * ms, 6, tag="insert"),
        _span("round", 30 * ms, 90 * ms, 7),
        _span("round.readback", 80 * ms, 90 * ms, 8, parent=7),
        _span("round", 95 * ms, 900 * ms, 9),                   # runs past the close
    ]
    window = (0.0, 0.1)
    # the card busy 0-12 ms and 16-100 ms: idle 12-16 ms, under search.scan
    # (12-14) and search (14-16); the window's rest is busy
    runs = np.array([[0, 12 * ms], [16 * ms, 100 * ms]], np.int64)
    harness = [("search_dispatch", 0.0105, 0.0195)]
    out = mod.program_numbers(spans, window, runs, harness, (0, 100 * ms))
    assert out["search_enqueue_ms"] == pytest.approx(8.0)
    assert out["queue_wait_ms"] == pytest.approx(8.0)
    assert out["round_enqueue_ms"] == pytest.approx(50.0)
    assert out["round_readback_ms"] == pytest.approx(10.0) and out["round_ms"] == 60.0
    assert out["idle_by_span"] == pytest.approx({"search.scan": 0.002, "search": 0.002})
    assert out["dispatch_idle"] == pytest.approx(0.004 / 0.1)
    assert out["harness_idle_share"] == 0.0
    assert out["self_s"]["search"] == pytest.approx(0.006)
    assert out["count"] == {"engine.dispatch": 1, "search": 1, "search.scan": 1,
                            "queue.wait": 2, "round": 1, "round.readback": 1}
    # (the last round, open at the close, paints nothing: the card is busy)
    # without the program's spans the harness's take the idle, and the
    # queue's waits are never painted
    idle = mod.painted_idle(runs, harness, [spans[4]], 0, 100 * ms)
    assert idle == pytest.approx({"search_dispatch": 0.004})


_HARNESS_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/scripts"]
import spans_on_card
from repro_torch.utils import trace


def small_config(cfg):
    cfg["data"].update(n_base=2000, pool_rows=2000, query_pool=1024)
    cfg["lire"].update(num_blocks=4096, num_postings_cap=512, num_vectors_cap=8192,
                       scan_page_budget=1024)
    cfg["serve"].update(max_batch=128)
    return cfg


def small_mix(mix):
    mix["warmup_s"] = 0.5
    mix["search"]["rate_per_s"] = 15.0
    mix["ingest"]["rate_per_s"] = 3.0
    mix["search"]["rows"].update(min=8, max=24)
    return mix


row, spans = spans_on_card.measure({root!r}, "spacev.update_mix", 2**31 + 17, 2.0, True,
                                   device="cpu", edit_config=small_config,
                                   edit_mix=small_mix)
w0, w1 = row["window"]
row["outside"] = sum(not (w0 * 1e9 <= s.start_ns < w1 * 1e9 or w0 * 1e9 <= s.end_ns < w1 * 1e9)
                     for s in spans)
row["costs"] = spans_on_card.span_costs(2000)
row["on_after"] = trace.ON
print(json.dumps(row))
"""


def test_a_run_through_the_harness_on_the_cpu():
    """``spacev.update_mix`` shrunk to the CPU through ``bench.run``: the
    recorder on in the window only, the answers still correct, and every
    reading present.  In a process of its own: the harness refuses to run
    in one that has loaded JAX, as another test file may have."""
    p = subprocess.run([sys.executable, "-c", _HARNESS_RUN.format(root=str(ROOT))],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    assert row["correct"] and not row["on_after"] and row["outside"] == 0
    assert set(row["costs"]) == {"span_off_us", "span_on_us", "timed_off_us"}
    assert row["n_spans"] > 0 and row["count"]["search"] > 0
    assert row["search_enqueue_ms"] > 0 and row["queue_wait_ms"] > 0
    assert {"recall_at_10", "round_ms.mix"} <= set(row["metrics"])
    if row["count"].get("round"):
        assert row["round_enqueue_ms"] + row["round_readback_ms"] == \
            pytest.approx(row["round_ms"])
