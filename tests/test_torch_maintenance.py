"""Port vs reference for the LIRE maintenance round: NPA, the reassign
dedup, balanced 2-means, job selection, whole rounds, drains and the
SPFreshIndex backpressure path.

States are built and churned by the reference and carried across with
``convert.state_from_numpy``; the port runs on the CPU.  A round draws
random bits for its 2-means seeds: where a test compares a split round
with the reference leaf for leaf it injects the reference's draw (its
next key and Gumbel scores) through ``draw=``.  Ids and integer leaves
must be equal; float leaves (the two frameworks sum and fuse in another
order: 2-means centroids, ``drift_vec``, the quant scales) are held to
``rtol = atol = 1e-5``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lire as rlire
from repro.core import npa as rnpa
from repro.core.clustering import balanced_two_means as r_two_means
from repro.core.index import SPFreshIndex as RIndex
from repro.core.types import LireConfig as RConfig
from repro_torch import convert
from repro_torch.core import lire as tlire
from repro_torch.core import npa as tnpa
from repro_torch.core.clustering import balanced_two_means
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.types import LireConfig as TConfig
from repro_torch.storage import versionmap as tvm
from repro_torch.utils.tree import clone_state
from tests.test_torch_storage import assert_leaves_equal, port_leaves, ref_leaves

TOL = 1e-5


def _cfg_kw(**kw):
    args = dict(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                num_postings_cap=256, num_vectors_cap=8192, split_limit=48,
                merge_limit=6, merge_fanout=4, reassign_range=8, reassign_budget=128,
                replica_count=2, nprobe=8, jobs_per_round=4)
    args.update(kw)
    return args


def _clustered(rng, n, dim=16, n_clusters=8):
    centers = rng.normal(size=(n_clusters, dim)) * 5
    return (centers[rng.integers(0, n_clusters, n)]
            + rng.normal(size=(n, dim))).astype(np.float32)


_CACHE = {}


def _churned():
    """A reference index with a split and a merge backlog: hot inserts
    without backpressure (``max_retries=0``) and a deleted cluster."""
    if "churn" not in _CACHE:
        rng = np.random.default_rng(3)
        base = _clustered(rng, 1000)
        idx = RIndex.build(RConfig(**_cfg_kw()), base)
        cen = np.asarray(idx.state.centroids)[np.asarray(idx.state.centroid_valid)]
        hot = np.concatenate([(c[None] + 0.05 * rng.normal(size=(40, 16))).astype(np.float32)
                              for c in cen[:4]])
        idx.insert(hot, np.arange(4000, 4000 + len(hot), dtype=np.int32), max_retries=0)
        d = ((base - base[0]) ** 2).sum(-1)
        idx.delete(np.argsort(d)[:150].astype(np.int32))
        _CACHE["churn"] = (idx.state, base)
    return _CACHE["churn"]


def _with(rstate, **kw):
    """The reference state under a changed config, and its port twin."""
    rcfg = dataclasses.replace(rstate.cfg, **kw)
    tcfg = TConfig(**dataclasses.asdict(rcfg))
    rstate = rstate.replace(cfg=rcfg)
    return rstate, convert.state_from_numpy(tcfg, ref_leaves(rstate), device="cpu")


def _ref_draw(rstate, k):
    """The reference round's split draw: its next key and each job's
    Gumbel noise (``lire._split_jobs`` → ``balanced_kmeans``)."""
    rng, sub = jax.random.split(rstate.rng)
    keys = jax.random.split(sub, k)
    cap = rstate.cfg.posting_capacity
    g = jax.vmap(lambda key: jax.random.gumbel(key, (cap,)))(keys)
    return (torch.from_numpy(np.array(rng)), torch.from_numpy(np.array(g)))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_npa_conditions_match(rng):
    v = rng.normal(size=(3, 40, 16)).astype(np.float32)
    old = rng.normal(size=(3, 16)).astype(np.float32)
    new = (old[:, None] + 0.5 * rng.normal(size=(3, 2, 16))).astype(np.float32)
    v[:, 0] = old                                       # on the old centroid
    for fn in ("split_old_posting_candidates", "split_neighbor_candidates"):
        want = np.stack([np.asarray(getattr(rnpa, fn)(jnp.asarray(v[j]), jnp.asarray(old[j]),
                                                      jnp.asarray(new[j]))) for j in range(3)])
        got = getattr(tnpa, fn)(torch.as_tensor(v), torch.as_tensor(old), torch.as_tensor(new))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_vid_mask_matches_its_ref_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    vids = rng.integers(-1, 6, size=24).astype(np.int32)
    mask = rng.random(24) < 0.7
    want = np.asarray(rlire._dedup_vid_mask(jnp.asarray(vids), jnp.asarray(mask)))
    got = tlire._dedup_vid_mask(torch.as_tensor(vids), torch.as_tensor(mask))
    ref = tlire._dedup_vid_mask_ref(torch.as_tensor(vids), torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.numpy(), want)


def test_balanced_two_means_with_the_reference_init_matches(rng):
    k, n = 4, 64
    x = np.concatenate([rng.normal(size=(k, n // 2, 16)) - 2,
                        rng.normal(size=(k, n // 2, 16)) + 2], axis=1).astype(np.float32)
    x = x[:, rng.permutation(n)]
    valid = rng.random(size=(k, n)) < 0.9
    valid[1, 40:] = False                               # a short posting
    valid[2] = True
    keys = jax.random.split(jax.random.PRNGKey(5), k)
    g = jax.vmap(lambda key: jax.random.gumbel(key, (n,)))(keys)
    want_c, want_a = jax.vmap(lambda key, xx, vv: r_two_means(key, xx, vv, iters=8))(
        keys, jnp.asarray(x), jnp.asarray(valid))
    got_c, got_a = balanced_two_means(torch.as_tensor(x), torch.as_tensor(valid),
                                      init_scores=torch.from_numpy(np.array(g)), iters=8)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=TOL, atol=TOL)
    # balance is hard: no side above ceil(n_valid / 2)
    for j in range(k):
        for side in (0, 1):
            assert int((got_a[j] == side).sum()) <= (int(valid[j].sum()) + 1) // 2


def test_split_draw_is_a_function_of_the_key():
    key = torch.from_numpy(np.array([0, 7], np.uint32))
    n1, s1 = tlire.split_draw(key, 4, 32)
    n2, s2 = tlire.split_draw(key.clone(), 4, 32)
    assert torch.equal(n1, n2) and torch.equal(s1, s2)
    assert n1.dtype == torch.uint32 and not torch.equal(n1, key)
    n3, s3 = tlire.split_draw(n1, 4, 32)
    assert not torch.equal(s1, s3)
    assert bool((s1 >= 0).all() & (s1 < 2 ** 32).all())
    assert len(set(s1.reshape(-1).tolist())) > 120      # 128 draws, ~no repeats


@pytest.mark.parametrize("policy,k", [("size", 1), ("size", 4), ("drift", 4), ("drift", 8)])
def test_select_jobs_bit_equal(policy, k):
    rstate, _ = _churned()
    access = np.random.default_rng(k).integers(0, 40, size=256).astype(np.int32)
    tel = rstate.telemetry
    rstate = rstate.replace(telemetry=tel.replace(access_count=jnp.asarray(access)))
    rstate, port = _with(rstate, maintain_policy=policy, maintain_alpha=4.0)
    want = rlire._select_jobs(rstate, k)
    got = tlire._select_jobs(port, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(np.asarray(want[1]).any()) and bool(np.asarray(want[3]).any())


@pytest.mark.parametrize("policy", ["size", "drift"])
def test_select_jobs_ties_go_to_the_lowest_pid(policy):
    rstate, _ = _churned()
    rstate, port = _with(rstate, maintain_policy=policy)
    lens = port.pool.posting_len.clone()
    valid = port.centroid_valid
    lens[valid] = 60                                   # every posting tied and oversized
    lens[torch.nonzero(valid).flatten()[-3:]] = 3            # three tied runts
    port = port.replace(pool=port.pool.replace(posting_len=lens),
                        telemetry=port.telemetry.replace(
                            drift_vec=torch.zeros_like(port.telemetry.drift_vec)))
    sp, se, mp, me = tlire._select_jobs(port, 4)
    ids = torch.nonzero(valid).flatten()
    assert sp.tolist() == ids[:4].tolist() and bool(se.all())
    assert mp[:3].tolist() == ids[-3:].tolist() and me.tolist() == [True] * 3 + [False]


# ---------------------------------------------------------------------------
# whole rounds against the reference
# ---------------------------------------------------------------------------

def _assert_round_equal(port, rstate, tdid=0, rdid=0):
    """Integer and bool leaves equal, float leaves within ``TOL``."""
    assert int(tdid) == int(rdid)
    floats = [name for name, x in port_leaves(port).items() if x.dtype.kind == "f"]
    assert_leaves_equal(port, rstate, close=floats, rtol=TOL, atol=TOL)


def test_round_without_split_equals_the_reference_leaf_for_leaf():
    """Merges, GC write-backs and reassigns, no 2-means: the reference's
    next key is the only draw."""
    rstate, _ = _churned()
    rstate, port = _with(rstate, enable_split=False)
    rout, rdid = rlire.maintenance_round(rstate, 4)
    draw = (_ref_draw(rstate, 4)[0], torch.zeros(4, rstate.cfg.posting_capacity))
    tout, tdid = tlire.maintenance_round(port, 4, draw=draw)
    for name in ("n_merges", "n_reassign_candidates"):
        assert int(getattr(rout.stats, name)) > int(getattr(rstate.stats, name)), name
    _assert_round_equal(tout, rout, tdid, rdid)


@pytest.mark.parametrize("policy,access", [("size", False), ("drift", True)])
def test_split_round_with_the_reference_draw_equals_the_reference(policy, access):
    rstate, _ = _churned()
    rstate, port = _with(rstate, maintain_policy=policy, maintain_alpha=4.0)
    acc = np.random.default_rng(2).integers(0, 30, size=256).astype(np.int32) if access else None
    rout, rdid = rlire.maintenance_round(rstate, 4, None if acc is None else jnp.asarray(acc))
    tout, tdid = tlire.maintenance_round(port, 4, None if acc is None else torch.as_tensor(acc),
                                         draw=_ref_draw(rstate, 4))
    for name in ("n_splits", "n_reassigned", "n_reassign_overflow"):
        assert int(getattr(rout.stats, name)) > int(getattr(rstate.stats, name)), name
    _assert_round_equal(tout, rout, tdid, rdid)


def test_split_and_merge_posting_equal_the_reference():
    rstate, _ = _churned()
    rstate, port = _with(rstate)
    lens = np.asarray(rstate.pool.posting_len)
    valid = np.asarray(rstate.centroid_valid)
    big = int(np.argmax(np.where(valid, lens, -1)))
    small = int(np.argmin(np.where(valid & (lens > 0), lens, 1 << 30)))
    rout, racted = rlire.merge_posting(rstate, jnp.asarray(small), jnp.asarray(True))
    tout, tacted = tlire.merge_posting(port, small, True)
    assert bool(racted) and bool(tacted)
    _assert_round_equal(tout, rout)
    # split_posting draws from its own state's key: inject nothing, compare
    # the invariants the draw cannot move
    tout, tacted = tlire.split_posting(port, big, True)
    assert bool(tacted) and int(tout.stats.n_splits) == int(port.stats.n_splits) + 1
    assert _live(tout) == _live(port)


def test_maintenance_step_matches_reference_counts():
    rstate, _ = _churned()
    rstate, port = _with(rstate)
    rout, rdid = rlire.maintenance_step(rstate)
    tout, tdid = tlire.maintenance_step(port)
    assert bool(tdid) == bool(rdid)
    for name in ("n_splits", "n_gc_writebacks", "n_merges"):
        assert int(getattr(tout.stats, name)) == int(getattr(rout.stats, name)), name
    assert _live(tout) == _live(port)


# ---------------------------------------------------------------------------
# drains: round vs sequential invariants (the reference's round-parity gate)
# ---------------------------------------------------------------------------

def _live(state) -> set:
    vids = state.pool.block_vid.reshape(-1)
    vers = state.pool.block_ver.reshape(-1)
    ok = (vids >= 0) & ~tvm.is_stale(state.versions, vids, vers)
    return set(vids[ok].tolist())


def _check_invariants(state):
    cfg = state.cfg
    lens = state.pool.posting_len.numpy()
    valid = state.centroid_valid.numpy()
    assert (lens[valid] <= cfg.split_limit).all()
    used = cfg.num_blocks - int(state.pool.free_top)
    assert used == int(sum(-(-int(n) // cfg.block_size) for n in lens[valid] if n > 0))
    assert int(state.n_postings) == cfg.num_postings_cap - int(state.pid_free_top)
    assert (state.pool.posting_blocks.numpy()[~valid] == -1).all()
    tel = state.telemetry
    for leaf in (tel.access_count, tel.update_count, tel.drift_vec):
        assert not leaf[~state.centroid_valid].any()


def _seq_drain(state):
    for _ in range(2 * state.cfg.num_postings_cap):
        state, did = tlire.maintenance_step(state)
        if not bool(did):
            break
    return state


def _recall(state, base, live, queries):
    ids = np.array(sorted(v for v in live if v < len(base)))
    d = ((queries[:, None, :] - base[ids][None]) ** 2).sum(-1)
    gt = ids[np.argsort(d, axis=1)[:, :10]]
    _, got = tlire.search(state, torch.as_tensor(queries), k=10, nprobe=16)
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), got.tolist())])


def test_round_drain_keeps_the_sequential_drains_invariants():
    rstate, base = _churned()
    _, port = _with(rstate)
    live0 = _live(port)
    queries = base[sorted(v for v in live0 if v < 1000)[::40]]
    rdrained, rjobs, _ = rlire.rebuild_drain(rstate, jobs_per_round=4)
    drained = {"seq": _seq_drain(port)}
    for j in (1, 4):
        s, jobs, rounds = tlire.rebuild_drain(port, jobs_per_round=j)
        assert jobs > 0 and rounds >= 2
        drained[f"round_j{j}"] = s
    want_recall = _recall(convert.state_from_numpy(port.cfg, ref_leaves(rdrained), device="cpu"),
                          base, live0, queries)
    for name, s in drained.items():
        assert _live(s) == live0, name
        _check_invariants(s)
        v0, v1 = port.versions.numpy(), s.versions.numpy()
        lv = np.array(sorted(live0))
        assert ((v1[lv] & 0x7F) >= (v0[lv] & 0x7F)).all(), name
        np.testing.assert_array_equal(v1 & 0x80, v0 & 0x80)
        _, did = tlire.maintenance_round(s, 4)
        assert int(did) == 0, name
        assert abs(_recall(s, base, live0, queries) - want_recall) <= 0.1, name


def test_drain_rounds_read_back_once_and_beat_single_jobs():
    rstate, _ = _churned()
    _, port = _with(rstate)
    _, jobs4, rounds4 = tlire.rebuild_drain(port, jobs_per_round=4)
    _, jobs1, rounds1 = tlire.rebuild_drain(port, jobs_per_round=1)
    assert jobs4 >= 2 and jobs1 >= 2 and rounds4 < rounds1
    # a round runs up to 2K jobs (K splits, K merges): the cap overshoots
    # by at most 2K - 1
    _, jobs_cap, rounds_cap = tlire.rebuild_drain(port, max_steps=3, jobs_per_round=1)
    assert 3 <= jobs_cap <= 4 and rounds_cap < rounds1


# ---------------------------------------------------------------------------
# telemetry: conservation and the access fold
# ---------------------------------------------------------------------------

def test_split_round_conserves_access_and_zeroes_freed_pids():
    rstate, _ = _churned()
    _, port = _with(rstate, maintain_policy="drift", enable_merge=False)
    access = np.random.default_rng(4).integers(0, 50, size=256).astype(np.int32)
    access[~port.centroid_valid.numpy()] = 0
    total = int(port.telemetry.access_count.sum()) + int(access.sum())
    out, did = tlire.maintenance_round(port, 4, torch.as_tensor(access))
    assert int(did) > 0 and int(out.stats.n_splits) > 0
    assert int(out.telemetry.access_count.sum()) == total
    _check_telemetry_zero_off_valid(out)


def _check_telemetry_zero_off_valid(state):
    off = ~state.centroid_valid
    tel = state.telemetry
    assert not tel.access_count[off].any()
    assert not tel.update_count[off].any()
    assert not tel.drift_vec[off].any()


def test_merge_moves_access_to_its_target():
    rstate, _ = _churned()
    rstate, port = _with(rstate, maintain_policy="drift", enable_split=False)
    lens = port.pool.posting_len.numpy()
    valid = port.centroid_valid.numpy()
    runt = int(np.flatnonzero(valid & (lens < 6) & (lens > 0))[0])
    access = np.zeros(256, np.int32)
    access[runt] = 77
    out, did = tlire.maintenance_round(port, 4, torch.as_tensor(access))
    rout, _ = rlire.maintenance_round(rstate, 4, jnp.asarray(access))
    assert int(did) > 0 and not bool(out.centroid_valid[runt])
    assert int(out.telemetry.access_count[runt]) == 0
    # the 77 probes moved to the target, nothing else appeared
    assert int(out.telemetry.access_count.sum()) == int(port.telemetry.access_count.sum()) + 77
    np.testing.assert_array_equal(out.telemetry.access_count.numpy(),
                                  np.asarray(rout.telemetry.access_count))
    _check_telemetry_zero_off_valid(out)


def test_update_count_tracks_landed_appends_in_a_round():
    rstate, _ = _churned()
    _, port = _with(rstate)
    out, _ = tlire.maintenance_round(port, 4)
    valid = out.centroid_valid
    # a round's appends land on valid postings, or on ones it frees later
    assert int(out.telemetry.update_count[valid].sum()) <= (
        int(port.telemetry.update_count.sum())
        + int(out.stats.n_appends) - int(port.stats.n_appends))


# ---------------------------------------------------------------------------
# in place vs functional; determinism
# ---------------------------------------------------------------------------

def _port_churned(codec):
    """The reference churn, replayed on a port-built index in ``codec``."""
    rng = np.random.default_rng(3)
    base = _clustered(rng, 1000)
    idx = TIndex.build(TConfig(**_cfg_kw(codec=codec, rerank_factor=2)), base, device="cpu")
    cen = idx.state.centroids[idx.state.centroid_valid].numpy()
    hot = np.concatenate([(c[None] + 0.05 * rng.normal(size=(40, 16))).astype(np.float32)
                          for c in cen[:4]])
    idx.insert(hot, np.arange(4000, 4000 + len(hot), dtype=np.int32), max_retries=0)
    d = ((base - base[0]) ** 2).sum(-1)
    idx.delete(np.argsort(d)[:150].astype(np.int32))
    return idx.state


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
def test_inplace_round_equals_the_functional_round(codec):
    port = _port_churned(codec)
    before = port_leaves(port)
    func, fdid = tlire.maintenance_round(port, 4)
    for name, arr in port_leaves(port).items():       # input untouched
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    owned = clone_state(port)
    inpl, idid = tlire.maintenance_round(owned, 4, inplace=True)
    assert inpl.pool.blocks is owned.pool.blocks      # written in place
    assert int(fdid) == int(idid) > 0
    a, b = port_leaves(func), port_leaves(inpl)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_round_replays_bit_for_bit():
    rstate, _ = _churned()
    _, port = _with(rstate)
    a, _ = tlire.maintenance_round(clone_state(port), 4)
    b, _ = tlire.maintenance_round(clone_state(port), 4)
    pa, pb = port_leaves(a), port_leaves(b)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
    assert not np.array_equal(pa["rng"], port_leaves(port)["rng"])


# ---------------------------------------------------------------------------
# SPFreshIndex: backpressure and the maintenance entry points
# ---------------------------------------------------------------------------

def test_index_maintenance_entry_points():
    rstate, _ = _churned()
    _, port = _with(rstate)
    idx = TIndex(clone_state(port))
    assert idx.backlog() > 0
    assert idx.maintain_round() > 0
    assert idx.maintain_fused_seq(2) > 0
    assert TIndex.maintain_fused is TIndex.maintain_round
    jobs = idx.maintain(access=port.centroid_valid.numpy().astype(np.int32))
    assert jobs > 0 and idx.last_drain_rounds >= 2 and idx.backlog() == 0
    assert idx.maintain() == 0 and idx.last_drain_rounds == 1
    _check_invariants(idx.state)
    assert _live(idx.state) == _live(port)
