"""Port vs reference for the index slice: build fill, search on converted
reference states (oracle path and both kernel schedules), insert and
delete, and an end-to-end build compared by recall.

The port runs on the CPU (each kernel wrapper's plain version); the
reference runs its Pallas kernels in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lire as rlire
from repro.core.clustering import hierarchical_balanced_kmeans as r_hbk
from repro.core.index import SPFreshIndex as RIndex
from repro.core.index import _build_routing as r_build_routing
from repro.core.index import build_state as r_build_state
from repro.core.types import LireConfig as RConfig
from repro_torch import convert
from repro_torch.core import index as tindex
from repro_torch.core import lire as tlire
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.distance import MASK_DISTANCE
from repro_torch.core.types import LireConfig as TConfig
from repro_torch.kernels.posting_scan import ops as tops
from repro_torch.storage import versionmap as tvm
from repro_torch.utils.tree import clone_state
from tests.conftest import make_clustered
from tests.test_torch_storage import assert_leaves_equal, port_leaves, ref_leaves

# Tie-tolerant search parity (the reference's `_assert_tie_tolerant`,
# tests/test_search_pallas.py): unit-scale data, f32 expansion noise.
TOL = 1e-4


def _cfg_kw(**kw):
    args = dict(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                num_postings_cap=256, num_vectors_cap=8192, split_limit=48,
                merge_limit=6, reassign_range=8, reassign_budget=128,
                replica_count=2, nprobe=8)
    args.update(kw)
    return args


def _pair(**kw):
    return RConfig(**_cfg_kw(**kw)), TConfig(**_cfg_kw(**kw))


def _to_port(ref_state, tcfg):
    return convert.state_from_numpy(tcfg, ref_leaves(ref_state), device="cpu")


def assert_tie_tolerant(d0, v0, d1, v1, tol=TOL):
    d0, v0, d1, v1 = map(np.asarray, (d0, v0, d1, v1))
    np.testing.assert_allclose(d0, d1, atol=tol)
    bad = v0 != v1
    assert (np.abs(d0 - d1)[bad] < tol).all(), (v0[bad], v1[bad])


def _base(rng):
    """Build data shared by the build, search and recall tests: with one
    data set the reference's clustering compiles once per process."""
    return make_clustered(rng, 500, 16, n_clusters=8)


# ---------------------------------------------------------------------------
# build: routing + fill given the reference's clustering (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec,dtype", [
    ("fp32", "float32"), ("fp32", "int8"), ("bf16", "float32"), ("int8", "float32"),
])
def test_build_fill_equals_reference_given_its_clustering(codec, dtype):
    base = _base(np.random.default_rng(7))
    if dtype == "int8":
        base = np.clip(np.round(base * 40), -127, 127).astype(np.float32)
    rcfg, tcfg = _pair(codec=codec, vector_dtype=dtype, replica_count=3)
    ref = r_build_state(rcfg, base, seed=1)
    target = max(rcfg.merge_limit + 1, int(rcfg.split_limit * 0.6))
    centroids, assign = r_hbk(base, max_posting_size=target, seed=1)
    port = tindex._state_from_clustering(tcfg, base, centroids, assign,
                                         seed=1, device="cpu")
    assert_leaves_equal(port, ref)


def test_build_routing_respects_capacity():
    """Replicas fill a posting only up to its capacity, in (vid, j) order."""
    rng = np.random.default_rng(4)
    base = make_clustered(rng, 120, 16, n_clusters=2, spread=0.01)
    rcfg, tcfg = _pair(block_size=4, max_blocks_per_posting=2, replica_count=4,
                       split_limit=8, merge_limit=2, replica_rng=10.0)
    target = 8
    centroids, assign = r_hbk(base, max_posting_size=target, seed=0)
    pid, vid = tindex._build_routing(base, centroids, assign, tcfg, device="cpu")
    ref_members = r_build_routing(base, centroids, assign, rcfg)
    want = [(p, v) for p, mem in enumerate(ref_members) for v in mem]
    assert list(zip(pid.tolist(), vid.tolist())) == want


# ---------------------------------------------------------------------------
# search on converted reference states
# ---------------------------------------------------------------------------

_CACHE = {}


def _churned():
    """A reference index after build + insert + delete + maintenance
    (splits, stale replicas, GC'd postings, freed pages)."""
    if "idx" not in _CACHE:
        rng = np.random.default_rng(7)
        base = _base(rng)
        rcfg, tcfg = _pair()
        idx = RIndex.build(rcfg, base)
        extra = make_clustered(rng, 150, 16, n_clusters=4)
        idx.insert(extra, np.arange(3000, 3150, dtype=np.int32))
        idx.delete(rng.choice(500, size=70, replace=False).astype(np.int32))
        idx.maintain()
        queries = (np.concatenate([base[100:116], extra[:16]])
                   + 0.01 * rng.normal(size=(32, 16))).astype(np.float32)
        _CACHE["idx"] = (idx, tcfg, queries)
    return _CACHE["idx"]


@pytest.mark.parametrize("path", ["oracle", "oracle_chunked", "per_query", "batched", "nav"])
def test_search_on_converted_state_matches(path):
    idx, tcfg, queries = _churned()
    kw = dict(k=10, nprobe=8)
    if path in ("per_query", "batched"):
        kw.update(use_pallas_scan=True, scan_schedule=path)
    if path == "oracle_chunked":
        kw.update(probe_chunk=4)
    rstate = idx.state
    if path == "nav":
        rstate = rstate.replace(cfg=dataclasses.replace(rstate.cfg, use_pallas_nav=True))
        tcfg = dataclasses.replace(tcfg, use_pallas_nav=True)
    port = _to_port(idx.state, tcfg)
    d0, v0 = rlire.search(rstate, jnp.asarray(queries), **kw)
    d1, v1 = tlire.search(port, torch.as_tensor(queries), **kw)
    assert_tie_tolerant(d0, v0, d1.numpy(), v1.numpy())


def test_kernel_path_agrees_with_oracle_path():
    """Kernel path vs gather oracle on one state: id overlap >= 0.95 (the
    reference's own criterion, tests/test_kernel_integration.py)."""
    idx, tcfg, queries = _churned()
    port = _to_port(idx.state, dataclasses.replace(tcfg, use_pallas_nav=True))
    q = torch.as_tensor(queries)
    _, v0 = tlire.search(port, q, k=10, nprobe=8, use_pallas_scan=False)
    for sched in ("per_query", "batched"):
        _, v1 = tlire.search(port, q, k=10, nprobe=8, use_pallas_scan=True,
                             scan_schedule=sched)
        overlap = np.mean([len(set(a) & set(b)) / 10
                           for a, b in zip(v0.tolist(), v1.tolist())])
        assert overlap >= 0.95, (sched, overlap)


def test_scan_page_stats_and_probe_histogram_match():
    idx, tcfg, queries = _churned()
    port = _to_port(idx.state, tcfg)
    for budget in (0, 16):
        want = rlire.scan_page_stats(idx.state, jnp.asarray(queries), nprobe=8,
                                     scan_page_budget=budget)
        got = tlire.scan_page_stats(port, torch.as_tensor(queries), nprobe=8,
                                    scan_page_budget=budget)
        assert {k: int(got[k]) for k in want} == {k: int(v) for k, v in want.items()}
        assert set(got) == set(want) | {"n_pairs"}
    qvalid = np.arange(32) < 20
    *_, rh = rlire.search(idx.state, jnp.asarray(queries), k=10, nprobe=8,
                          with_access=True, qvalid=jnp.asarray(qvalid))
    *_, th = tlire.search(port, torch.as_tensor(queries), k=10, nprobe=8,
                          with_access=True, qvalid=torch.as_tensor(qvalid))
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh))


@pytest.mark.parametrize("budget", [0, 16])
def test_scan_page_stats_counts_the_probed_pairs(budget):
    """``n_pairs`` is the count of ``member_pos >= 0``: the (page, query)
    pairs the batched scan's pairs form selects and stores, at most
    ``n_pages`` and at most ``min(n_unique, budget) x Q``."""
    idx, tcfg, queries = _churned()
    port = _to_port(idx.state, tcfg)
    q = torch.as_tensor(queries)
    got = tlire.scan_page_stats(port, q, nprobe=8, scan_page_budget=budget)
    nav_d, pids = tlire.navigate(port, q, 8)
    flat = tlire._page_table(port, pids, nav_d < MASK_DISTANCE / 2)
    cap = budget or min(flat.numel(), tcfg.num_blocks)
    _, member_pos, n_unique, _ = tops.dedup_pages(flat.reshape(-1), budget=cap,
                                                  num_blocks=tcfg.num_blocks)
    assert int(got["n_pairs"]) == int((member_pos >= 0).sum())
    assert 0 < int(got["n_pairs"]) <= int(got["n_pages"])
    assert int(got["n_pairs"]) <= min(int(n_unique), cap) * q.shape[0]
    if budget:
        assert int(got["n_pairs"]) < int(got["n_pages"])


def test_batched_budget_overflow_matches_reference():
    idx, tcfg, queries = _churned()
    rcfg = dataclasses.replace(idx.state.cfg, scan_page_budget=16)
    port = _to_port(idx.state, dataclasses.replace(tcfg, scan_page_budget=16))
    kw = dict(k=10, nprobe=8, use_pallas_scan=True, scan_schedule="batched")
    d0, v0 = rlire.search(idx.state.replace(cfg=rcfg), jnp.asarray(queries), **kw)
    d1, v1 = tlire.search(port, torch.as_tensor(queries), **kw)
    assert_tie_tolerant(d0, v0, d1.numpy(), v1.numpy())


def test_dedup_topk_matches_reference(rng):
    for n, k in [(150, 10), (150, 10), (40, 3)]:    # few shapes: few compiles
        vids = rng.integers(0, max(2, n // 3), size=(3, n)).astype(np.int32)
        dists = rng.integers(0, 50, size=(3, n)).astype(np.float32)   # ties
        live = rng.random(size=(3, n)) < 0.8
        m = rlire._dedup_prefilter(RConfig(replica_count=2), k, n)
        assert m == tlire._dedup_prefilter(TConfig(replica_count=2), k, n)
        td, tv, ti = tlire._dedup_topk_1d_full(
            torch.as_tensor(dists), torch.as_tensor(vids), torch.as_tensor(live), k, m)
        for row in range(3):
            rd, rv, ri = rlire._dedup_topk_1d_full(
                jnp.asarray(dists[row]), jnp.asarray(vids[row]),
                jnp.asarray(live[row]), k, m)
            np.testing.assert_array_equal(td[row].numpy(), np.asarray(rd))
            np.testing.assert_array_equal(tv[row].numpy(), np.asarray(rv))
            np.testing.assert_array_equal(ti[row].numpy(), np.asarray(ri))


# ---------------------------------------------------------------------------
# insert / delete on converted states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nav", [False, True])
def test_insert_and_delete_match_reference(nav):
    idx, tcfg, _ = _churned()
    rng = np.random.default_rng(11)
    rstate = idx.state.replace(cfg=dataclasses.replace(idx.state.cfg, use_pallas_nav=nav))
    port = _to_port(idx.state, dataclasses.replace(tcfg, use_pallas_nav=nav))
    vecs = make_clustered(rng, 64, 16, n_clusters=3)
    vids = np.arange(5000, 5064, dtype=np.int32)
    vids[5] = 12                            # re-insert of a live id
    valid = np.arange(64) < 60
    rstate, rl = rlire.insert_batch(rstate, jnp.asarray(vecs), jnp.asarray(vids),
                                    jnp.asarray(valid))
    port, tl = tlire.insert_batch(port, torch.as_tensor(vecs), torch.as_tensor(vids),
                                  torch.as_tensor(valid))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(rl))
    dv = np.concatenate([vids[:20], [-1, 3, 3]]).astype(np.int32)
    dvalid = np.ones(len(dv), bool)
    dvalid[-1] = False
    rstate = rlire.delete_batch(rstate, jnp.asarray(dv), jnp.asarray(dvalid))
    port = tlire.delete_batch(port, torch.as_tensor(dv), torch.as_tensor(dvalid))
    # drift_vec: the same f32 adds in another order than XLA's scatter-add
    assert_leaves_equal(port, rstate, close=("telemetry.drift_vec",), rtol=1e-5, atol=1e-5)


def test_insert_is_deterministic():
    idx, tcfg, _ = _churned()
    port = _to_port(idx.state, tcfg)
    rng = np.random.default_rng(5)
    vecs = torch.as_tensor(make_clustered(rng, 64, 16, n_clusters=2))
    vids = torch.arange(6000, 6064, dtype=torch.int32)
    valid = torch.ones(64, dtype=torch.bool)
    a, _ = tlire.insert_batch(clone_state(port), vecs, vids, valid)
    b, _ = tlire.insert_batch(clone_state(port), vecs, vids, valid)
    pa, pb = port_leaves(a), port_leaves(b)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


# ---------------------------------------------------------------------------
# end to end: SPFreshIndex
# ---------------------------------------------------------------------------

def _recall(got, base, vids, queries, k=10):
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = vids[np.argsort(d, axis=1)[:, :k]]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(gt.tolist(), got.tolist())])


def test_port_build_recall_matches_reference_build():
    """Different random bits, same algorithm: recall@10 within 0.03.
    nprobe=3 keeps recall below 1 (at the default 8 both saturate)."""
    base = _base(np.random.default_rng(7))
    rng = np.random.default_rng(21)
    queries = (base[rng.integers(0, 500, size=48)]
               + 0.02 * rng.normal(size=(48, 16))).astype(np.float32)
    rcfg, tcfg = _pair()
    ridx = RIndex.build(rcfg, base, seed=0)
    tidx = TIndex.build(tcfg, base, seed=0, device="cpu")
    vids = np.arange(500)
    r_rec = _recall(ridx.search(queries, 10, nprobe=3)[1], base, vids, queries)
    t_rec = _recall(tidx.search(queries, 10, nprobe=3)[1], base, vids, queries)
    assert r_rec < 1.0
    assert abs(r_rec - t_rec) <= 0.03, (r_rec, t_rec)
    ts, rs = tidx.stats(), ridx.stats()
    assert abs(ts["n_postings"] - rs["n_postings"]) <= 0.2 * rs["n_postings"]
    assert tidx.memory_bytes() == ridx.memory_bytes()
    assert tidx.backlog() == int(((tidx.state.pool.posting_len > 48)
                                  & tidx.state.centroid_valid).sum())


def test_index_insert_delete_search_and_padded_entry_points():
    rng = np.random.default_rng(8)
    base = make_clustered(rng, 400, 16, n_clusters=4)
    # capacity 128 > the build's replica fill, so the inserts land
    tcfg = TConfig(**_cfg_kw(max_blocks_per_posting=16, use_pallas_nav=True,
                             use_pallas_scan=True, scan_schedule="batched"))
    idx = TIndex.build(tcfg, base, device="cpu")
    new = make_clustered(rng, 20, 16, n_clusters=2)
    ids = np.arange(2000, 2020, dtype=np.int32)
    idx.insert(new, ids)
    _, got = idx.search(new, 5)
    assert sum(int(ids[i]) in got[i] for i in range(20)) >= 18
    idx.delete(ids[:5])
    _, got = idx.search(new, 5)
    assert not set(ids[:5].tolist()) & set(got.reshape(-1).tolist())
    d, v, hist = idx.search_padded(new, 5, with_access=True,
                                   qvalid=np.arange(20) < 10)
    assert d.shape == (20, 5) and int(hist.sum()) == 10 * tcfg.nprobe
    st = idx.stats()
    assert st["n_inserts"] == 20 and st["n_deletes"] == 5
    assert idx.maintain() >= 0 and idx.backlog() == 0


def _reference_split_draw(rng, k, n):
    """The reference round's split draw for key ``rng``: its next key and
    each job's Gumbel noise, as ``lire.split_draw`` returns the port's."""
    nxt, sub = jax.random.split(jnp.asarray(rng.cpu().numpy()))
    g = jax.vmap(lambda key: jax.random.gumbel(key, (n,)))(jax.random.split(sub, k))
    return torch.from_numpy(np.array(nxt)), torch.from_numpy(np.array(g))


def _live(state):
    vids = state.pool.block_vid.reshape(-1)
    ok = (vids >= 0) & ~tvm.is_stale(state.versions, vids, state.pool.block_ver.reshape(-1))
    return set(vids[ok].tolist())


def test_insert_into_full_posting_raises_instead_of_dropping(monkeypatch):
    """An insert whose primary posting is full is neither dropped nor
    refused: the index drains the Local Rebuilder (which splits the
    posting) and retries the rows that did not land, as the reference's
    does.  With the reference's split draws fed in, the port's insert
    leaves the reference's live set and state (floats within 1e-5), and a
    later ``maintain()`` runs the reference's job count."""
    monkeypatch.setattr(tlire, "split_draw", _reference_split_draw)
    rng = np.random.default_rng(9)
    base = make_clustered(rng, 60, 16, n_clusters=1, spread=0.3)
    kw = _cfg_kw(block_size=4, max_blocks_per_posting=4, split_limit=14, merge_limit=3,
                 num_blocks=128)
    ridx = RIndex.build(RConfig(**kw), base)
    idx = TIndex(_to_port(ridx.state, TConfig(**kw)))
    more = (base[:1] + 0.3 * rng.normal(size=(80, 16))).astype(np.float32)
    ids = np.arange(1000, 1080, dtype=np.int32)
    assert not idx.insert_padded(more[:16], ids[:16], np.ones(16, bool)).all()
    idx = TIndex(_to_port(ridx.state, TConfig(**kw)))
    ridx.insert(more, ids)
    idx.insert(more, ids)
    assert idx.last_drain_rounds > 0 and idx.retried_rows > 0
    assert _live(idx.state) == _live(_to_port(ridx.state, TConfig(**kw))) \
        == set(range(60)) | set(ids.tolist())
    jobs = ridx.maintain()
    assert jobs > 0 and idx.maintain() == jobs
    assert idx.backlog() == 0
