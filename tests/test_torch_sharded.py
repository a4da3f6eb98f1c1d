"""The port's sharded index against the reference's ``shard_map`` steps.

The reference's steps need a multi-device mesh, which JAX fixes at its
first use; the main pytest process keeps one device.  So the reference
half runs once per module in a subprocess — this file's own ``__main__``
runner, with ``XLA_FLAGS`` giving 8 fake CPU devices before ``jax`` is
imported — at the geometry of ``tests/distributed_script.py`` (dim 16, a
``(data=2, model=4)`` mesh).  It writes every input, output and stacked
state to one npz; a module-scoped fixture reads it.  Each test carries
the reference's stacked state before a step across
(``convert.sharded_state_from_numpy``), runs the port's step on the CPU
(its kernels' plain versions; the reference's Pallas scans run in
interpret mode), and holds the result against the reference's.

Tolerances: handles (search, insert) and integer leaves exact;
distances ``atol 1e-4 + rtol 1e-5``.  Float leaves are exact after
search, insert and delete except the telemetry's ``drift_vec``; after a
maintenance step or round the split's 2-means centroids, the leaves
summed from them and the quant scales are held to ``rtol = atol =
1e-5``, as in ``test_torch_maintenance.py`` (the frameworks sum in
another order).  A
split's random draw is the reference's, injected through ``draw=``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.types import LireConfig
from repro_torch.distributed import sharded_index as D

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CFG_KW = dict(
    dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=1024,
    num_postings_cap=128, num_vectors_cap=4096, split_limit=48,
    merge_limit=6, reassign_range=8, reassign_budget=128, replica_count=2,
    nprobe=8,
)
CFG = LireConfig(**CFG_KW)
SCHEDULES = ("oracle", "per_query", "batched")
GROUPS = dict(n_groups=4, capacity=32, gprobe=2)
ALIVE = np.array([True, True, False, True])
ATOL, RTOL = 1e-4, 1e-5
FLOAT_CLOSE = ("telemetry.drift_vec",)
ROUND_CLOSE = ("centroids", "centroid_sqn", "telemetry.drift_vec", "pool.post_scale",
               "pool.post_zero")


def make_clustered(rng, n, d, n_clusters=8, spread=0.05):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.normal(size=(n, d))).astype(np.float32)


def inputs():
    """Every input of the suite, from one seed (both halves call this)."""
    rng = np.random.default_rng(0)
    base = make_clustered(rng, 2000, 16, n_clusters=12)
    queries = base[rng.integers(0, len(base), 64)] + 0.01 * rng.normal(
        size=(64, 16)).astype(np.float32)
    new = make_clustered(rng, 32, 16, n_clusters=2)
    new_valid = np.ones(32, bool)
    new_valid[[3, 17, 30, 31]] = False                 # padding rows
    # hot rows onto two base points: their postings overflow, so some
    # primary appends drop (handle -1) and the rounds have splits to run
    hot = np.concatenate([base[i] + 0.02 * rng.normal(size=(96, 16)) for i in (5, 900)])
    return dict(base=base, queries=queries.astype(np.float32), new=new, new_valid=new_valid,
                hot=hot.astype(np.float32), tie_base=base[:300].copy())


# ---------------------------------------------------------------------------
# the reference half (subprocess)
# ---------------------------------------------------------------------------

def run_reference(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from repro.core.grouping import build_group_index
    from repro.core.index import build_state
    from repro.core.types import LireConfig as RConfig
    from repro.distributed import sharded_index as RD

    assert len(jax.devices()) == 8, jax.devices()
    cfg = RConfig(**CFG_KW)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    x = inputs()
    out = {}

    def leaves(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in flat:
            out[prefix + "." + ".".join(k.name for k in path)] = np.array(v)

    def copy(tree):
        return jax.tree_util.tree_map(jnp.copy, tree)

    s0, handles = RD.build_sharded_state(cfg, x["base"], 4)
    out["handles"] = handles
    leaves("s0", s0)
    q = jnp.asarray(x["queries"])
    alive = jnp.ones((4,), bool)
    gidx = RD.stack_states([
        build_group_index(RD.unstack_state(s0, s), n_groups=GROUPS["n_groups"],
                          capacity=GROUPS["capacity"])
        for s in range(4)])
    leaves("gidx", gidx)
    # a crafted tie: four identical shards, so every candidate ties
    # across all four and the merge must take the lowest shard first
    tie = RD.stack_states([build_state(cfg, x["tie_base"], seed=0)] * 4)
    leaves("tied", tie)
    with mesh:
        for sched in SCHEDULES:
            kw = {} if sched == "oracle" else dict(use_pallas_scan=True, scan_schedule=sched)
            d, v = RD.make_search_step(mesh, cfg, k=10, **kw)(s0, q, alive)
            out[f"search.{sched}.d"], out[f"search.{sched}.v"] = np.array(d), np.array(v)
        d, v = RD.make_search_step(mesh, cfg, k=10, gprobe=GROUPS["gprobe"])(s0, q, alive, gidx)
        out["search.grouped.d"], out["search.grouped.v"] = np.array(d), np.array(v)
        d, v = RD.make_search_step(mesh, cfg, k=10)(s0, q, jnp.asarray(ALIVE))
        out["search.dead.d"], out["search.dead.v"] = np.array(d), np.array(v)

        insert = RD.make_insert_step(mesh, cfg)
        s1, h = insert(copy(s0), jnp.asarray(x["new"]), jnp.asarray(x["new_valid"]))
        out["ins.h"] = np.array(h)
        leaves("s1", s1)
        s2, h = insert(copy(s1), jnp.asarray(x["hot"]), jnp.ones(len(x["hot"]), bool))
        out["hot.h"] = np.array(h)
        leaves("s2", s2)
        dead = np.concatenate([out["ins.h"][:12], handles[:20], [-1, -1]]).astype(np.int32)
        out["del.handles"] = dead
        s3 = RD.make_delete_step(mesh, cfg)(copy(s2), jnp.asarray(dead))
        leaves("s3", s3)
        s4, did = RD.make_maintenance_step(mesh, cfg)(copy(s3))
        out["step.did"] = np.array(did)
        leaves("s4", s4)
        s5, did = RD.make_maintenance_round(mesh, cfg, jobs_per_round=4)(copy(s3))
        out["round.did"] = np.array(did)
        leaves("s5", s5)
        d, v = RD.make_search_step(mesh, cfg, k=10)(tie, q, alive)
        out["tie.d"], out["tie.v"] = np.array(d), np.array(v)

    # the steps' outputs live on the mesh; the host-side helper indexes
    # shards, so it takes a single-device copy
    s3 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), s3)
    vecs, hs = RD.gather_live_vectors(s3, 4)
    out["live.vecs"], out["live.h"] = vecs, hs

    s8, h8 = RD.build_sharded_state(cfg, x["base"], 8)
    leaves("s8", s8)
    out["handles8"] = h8
    with mesh:
        insert8 = RD.make_insert_step(mesh, cfg, shard_axes=("data", "model"))
        s9, h = insert8(copy(s8), jnp.asarray(x["new"]), jnp.ones(len(x["new"]), bool))
    out["ins8.h"] = np.array(h)
    leaves("s9", s9)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port half
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def stacked(ref, prefix):
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def port_states(ref, prefix, n=4):
    return convert.sharded_state_from_numpy(CFG, stacked(ref, prefix), n, device="cpu")


def assert_states_equal(states, ref, prefix, close=FLOAT_CLOSE):
    got, want = convert.sharded_state_to_numpy(states), stacked(ref, prefix)
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        if name in close:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def assert_search_equal(d, v, want_d, want_v):
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_allclose(d.numpy(), want_d, atol=ATOL, rtol=RTOL)


def ref_draw(state, k):
    """The reference's split draw from the port state's key: its next key
    and each job's Gumbel scores (``lire._split_jobs``)."""
    import jax

    rng, sub = jax.random.split(np.asarray(state.rng.numpy(), np.uint32))
    keys = jax.random.split(sub, k)
    cap = state.cfg.posting_capacity
    g = jax.vmap(lambda key: jax.random.gumbel(key, (cap,)))(keys)
    return torch.from_numpy(np.array(rng)), torch.from_numpy(np.array(g))


def search(states, queries, alive=(True,) * 4, **kw):
    return D.sharded_search(states, torch.as_tensor(queries), torch.as_tensor(np.asarray(alive)),
                            k=10, **kw)


def test_replica_layout_rows():
    from repro_torch.distributed.sharding import replica_layout

    rows = replica_layout(2, 4, "cpu")
    assert len(rows) == 2 and all(len(r) == 4 for r in rows)
    assert {d.type for r in rows for d in r} == {"cpu"}
    with pytest.raises(ValueError):
        replica_layout(0, 4, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replica_layout(1, 2)


def test_stacked_state_carries_across_both_ways(ref):
    states = port_states(ref, "s0")
    assert len(states) == 4 and all(st.device.type == "cpu" for st in states)
    assert_states_equal(states, ref, "s0", close=())
    with pytest.raises(ValueError, match="leading axis"):
        convert.sharded_state_from_numpy(CFG, stacked(ref, "s0"), 2, device="cpu")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_search_equals_the_reference(ref, schedule):
    kw = {} if schedule == "oracle" else dict(use_pallas_scan=True, scan_schedule=schedule)
    d, v = search(port_states(ref, "s0"), inputs()["queries"], **kw)
    assert_search_equal(d, v, ref[f"search.{schedule}.d"], ref[f"search.{schedule}.v"])


def test_sharded_grouped_search_equals_the_reference(ref):
    g = stacked(ref, "gidx")
    gidx = [convert.group_index_from_numpy({k: a[s] for k, a in g.items()}, device="cpu")
            for s in range(4)]
    d, v = search(port_states(ref, "s0"), inputs()["queries"], gprobe=GROUPS["gprobe"],
                  group_indexes=gidx)
    assert_search_equal(d, v, ref["search.grouped.d"], ref["search.grouped.v"])


def test_shard_alive_masks_a_dead_shard(ref):
    states = port_states(ref, "s0")
    d, v = search(states, inputs()["queries"], alive=ALIVE)
    assert_search_equal(d, v, ref["search.dead.d"], ref["search.dead.v"])
    v = v.numpy()
    assert not ((v // CFG.num_vectors_cap == 2) & (v >= 0)).any(), "dead shard leaked"
    idx = D.ShardedIndex(CFG, states)
    idx.set_alive(ALIVE)
    _, v2 = idx.search(inputs()["queries"], 10)
    np.testing.assert_array_equal(v2, ref["search.dead.v"])


def test_tournament_merge_takes_the_lowest_shard_on_a_tie(ref):
    d, v = search(port_states(ref, "tied"), inputs()["queries"])
    assert_search_equal(d, v, ref["tie.d"], ref["tie.v"])
    shard = v.numpy() // CFG.num_vectors_cap
    # each distance appears once per shard, shards in order 0..3
    np.testing.assert_array_equal(shard[:, :8], np.tile([0, 1, 2, 3], (64, 2)))


@pytest.mark.parametrize("batch", ["new", "hot"])
def test_sharded_insert_equals_the_reference(ref, batch):
    x = inputs()
    before, after, key = ("s0", "s1", "ins.h") if batch == "new" else ("s1", "s2", "hot.h")
    valid = x["new_valid"] if batch == "new" else np.ones(len(x["hot"]), bool)
    states, h = D.sharded_insert(port_states(ref, before), torch.as_tensor(x[batch]),
                                 torch.as_tensor(valid))
    np.testing.assert_array_equal(h.numpy(), ref[key])
    assert_states_equal(states, ref, after)
    if batch == "new":
        assert (h.numpy()[~valid] == -1).all() and (h.numpy()[valid] >= 0).all()
    else:
        assert (h.numpy() == -1).any(), "the hot batch was meant to drop appends"


def test_sharded_delete_equals_the_reference(ref):
    states = D.sharded_delete(port_states(ref, "s2"), torch.as_tensor(ref["del.handles"]))
    assert_states_equal(states, ref, "s3")
    d, v = search(states, inputs()["new"][:12])
    assert not set(v.numpy().reshape(-1).tolist()) & set(ref["del.handles"][:12].tolist())


def test_sharded_maintenance_step_equals_the_reference(ref):
    states, did = D.sharded_maintenance_step(port_states(ref, "s3"), 1, draw=ref_draw)
    assert int(did) == int(ref["step.did"]) == 1
    assert_states_equal(states, ref, "s4", close=ROUND_CLOSE)


@pytest.mark.parametrize("inplace", [False, True])
def test_sharded_maintenance_round_equals_the_reference(ref, inplace):
    states, did = D.sharded_maintenance_round(port_states(ref, "s3"), 4, draw=ref_draw,
                                              inplace=inplace)
    assert int(did) == int(ref["round.did"]) > 0
    assert_states_equal(states, ref, "s5", close=ROUND_CLOSE)


def test_inplace_insert_equals_functional(ref):
    x = inputs()
    a, ha = D.sharded_insert(port_states(ref, "s1"), torch.as_tensor(x["hot"]),
                             torch.ones(len(x["hot"]), dtype=torch.bool))
    b, hb = D.sharded_insert(port_states(ref, "s1"), torch.as_tensor(x["hot"]),
                             torch.ones(len(x["hot"]), dtype=torch.bool), inplace=True)
    torch.testing.assert_close(ha, hb, rtol=0, atol=0)
    for sa, sb in zip(convert.sharded_state_to_numpy(a).items(),
                      convert.sharded_state_to_numpy(b).items()):
        np.testing.assert_array_equal(sa[1], sb[1], err_msg=sa[0])


def test_gather_live_vectors_equals_the_reference(ref):
    vecs, h = D.gather_live_vectors(port_states(ref, "s3"))
    np.testing.assert_array_equal(h, ref["live.h"])
    np.testing.assert_array_equal(vecs, ref["live.vecs"])


def test_reshard_four_to_two_keeps_the_live_set(ref):
    """The partition's draw differs by design (a ``torch.Generator``), so
    a reshard agrees with the reference's in content, not in layout: the
    reference's live rows (the rows its reshard rebuilds from), every one
    with a handle, each found at rank 1 by its own search."""
    states2, h2 = D.reshard(CFG, port_states(ref, "s3"), 2, seed=0)
    assert len(states2) == 2 and (h2 >= 0).all() and len(np.unique(h2)) == len(h2)
    vecs2, _ = D.gather_live_vectors(states2)
    def rows(a):
        return np.unique(a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))))
    np.testing.assert_array_equal(rows(vecs2), rows(ref["live.vecs"]))
    probe = ref["live.vecs"][::97]
    _, v = D.sharded_search(states2, torch.as_tensor(probe), torch.ones(2, dtype=torch.bool),
                            k=1)
    found = v.numpy()[:, 0]
    assert (found >= 0).all()
    back, hb = D.gather_live_vectors(states2)
    lookup = dict(zip(hb.tolist(), range(len(hb))))
    np.testing.assert_array_equal(back[[lookup[h] for h in found]], probe)


def test_eight_shard_insert_equals_the_reference_then_lands_through_the_retry(ref):
    """The insert that stops the reference's script (some rows get -1: their
    primary append did not land) gives the same handles here; through the
    serving engine's backpressure retry every row then lands."""
    from repro_torch.serve import EngineConfig, ServeEngine

    x = inputs()
    np.testing.assert_array_equal(
        D.build_sharded_state(CFG, x["base"], 8, device="cpu")[1] >= 0, ref["handles8"] >= 0)
    states, h = D.sharded_insert(port_states(ref, "s8", 8), torch.as_tensor(x["new"]),
                                 torch.ones(len(x["new"]), dtype=torch.bool))
    np.testing.assert_array_equal(h.numpy(), ref["ins8.h"])
    assert_states_equal(states, ref, "s9")
    assert (h.numpy() == -1).any(), "the reference's -1 rows are the point of this case"
    idx = D.ShardedIndex(CFG, port_states(ref, "s8", 8))
    eng = ServeEngine(idx, EngineConfig(search_k=10, max_batch=64, fg_bg_ratio=0,
                                        maintain_budget=4))
    got, landed = eng.submit_insert(x["new"], np.full(32, -1, np.int32)).result(timeout=120)
    assert landed.all() and (got >= 0).all() and len(np.unique(got)) == 32
    assert eng.report()["insert_retries"] >= 1
    _, v = eng.search(x["new"], k=10)
    assert sum(int(got[i]) in v[i] for i in range(32)) >= 30


def test_sharded_index_backend_matches_the_steps(ref):
    """``ShardedIndex``'s numpy entry points are the steps: the same
    handles and leaves, a delete that logs handles, ``log_update`` a
    no-op, stats summed over the shards."""
    from repro_torch.storage.durability import RecordingSink

    x = inputs()
    idx = D.ShardedIndex(CFG, port_states(ref, "s0"))
    sink = RecordingSink()
    idx.attach_replication(sink)
    h, landed = idx.insert(x["new"], np.full(32, -1, np.int32), x["new_valid"])
    np.testing.assert_array_equal(h, ref["ins.h"])
    np.testing.assert_array_equal(landed, ref["ins.h"] >= 0)
    assert_states_equal(idx.states, ref, "s1")
    idx.log_update("insert", {"vecs": x["new"]})
    idx.delete(ref["ins.h"][:4], np.array([True, True, False, True]))
    assert [r.op for r in sink.records] == ["insert", "delete"]
    assert set(sink.records[0].payload) == {"vecs", "valid"}
    np.testing.assert_array_equal(sink.records[1].payload["handles"],
                                  np.where([1, 1, 0, 1], ref["ins.h"][:4], -1))
    st = idx.stats()
    n_dead = int((ref["ins.h"][[0, 1, 3]] >= 0).sum())
    assert st["n_shards"] == 4 and st["n_inserts"] == 28 and st["n_deletes"] == n_dead
    s1 = stacked(ref, "s1")
    want = ((s1["pool.posting_len"] > CFG.split_limit) & s1["centroid_valid"]).sum()
    assert idx.backlog() == want and len(idx.state_bytes()) == 4
    # blocks in use, summed shard by shard (the reference's sharded stats
    # multiply n_shards by the stacked pool's leading axis instead)
    used = (s1["pool.blocks"].shape[1] - s1["pool.free_top"]).sum()
    assert st["used_blocks"] == used


if __name__ == "__main__":
    run_reference(sys.argv[1])
