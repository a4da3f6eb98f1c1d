"""The port's snapshot store against the reference's, and the port
index's single-log snapshot + WAL recovery.

* Leaf order: the port's ``tensor_leaves`` order is the reference's
  flatten order, name for name, for the fp32, bf16 and int8 codecs (the
  snapshot files store leaves positionally).
* A base + delta + delta chain the port wrote loads in the reference's
  ``SnapshotStore`` to the port's final state, leaf for leaf (fp32, int8);
  a chain the reference wrote loads in the port's (fp32, int8, bf16 —
  bf16 leaves travel as ``|V2`` bit patterns).
* The reference's store cases on the port's module: compaction, a crash
  at every crash point of base → delta → compaction through the port's
  ``_crash_hook``, the legacy full-snapshot layout, and the migration of
  every older leaf generation.

All comparisons are exact.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lire as rlire
from repro.core import types as rtypes
from repro.core.index import build_state as r_build_state
from repro.storage import blockpool as rbp
from repro.storage import snapshot as rsnap
from repro_torch.core import lire as tlire
from repro_torch.core import types as ttypes
from repro_torch.core.index import SPFreshIndex, build_state as t_build_state
from repro_torch.storage import blockpool as tbp
from repro_torch.storage import snapshot as tsnap
from repro_torch.storage.wal import iter_wal
from repro_torch.utils.tree import tensor_leaves
from tests.conftest import make_clustered
from tests.test_torch_storage import assert_leaves_equal, port_leaves, ref_leaves

CODECS = ["fp32", "bf16", "int8"]


def cfg_kw(codec="fp32"):
    return dict(dim=8, block_size=4, max_blocks_per_posting=4, num_blocks=128,
                num_postings_cap=32, num_vectors_cap=1024, split_limit=12,
                merge_limit=2, replica_count=2, nprobe=4, codec=codec)


def tcfg(codec="fp32"):
    return ttypes.LireConfig(**cfg_kw(codec))


def rcfg(codec="fp32"):
    return rtypes.LireConfig(**cfg_kw(codec))


def meta_template(codec="fp32"):
    return ttypes.make_empty_state(tcfg(codec), device="meta")


def assert_port_states_equal(a, b):
    pa, pb = port_leaves(a), port_leaves(b)
    assert list(pa) == list(pb)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def _batches(rng, n_steps):
    out, nid = [], 200
    for _ in range(n_steps):
        out.append((make_clustered(rng, 12, 8, n_clusters=2),
                    np.arange(nid, nid + 12, dtype=np.int32)))
        nid += 12
    return out


def port_states(rng, codec="fp32", n_steps=3):
    """A port build + a few update batches: ``[cleared base, (dirty,
    cleared), ...]`` with the dirty ledger cleared as the backends do."""
    base = make_clustered(rng, 120, 8, n_clusters=4)
    state = t_build_state(tcfg(codec), base, device="cpu")
    state = state.replace(pool=tbp.clear_dirty(state.pool))
    states = [state]
    for vecs, ids in _batches(rng, n_steps):
        state, _ = tlire.insert_batch(state, torch.as_tensor(vecs), torch.as_tensor(ids),
                                      torch.ones(12, dtype=torch.bool))
        state = tlire.delete_batch(state, torch.as_tensor(ids[:3]),
                                   torch.ones(3, dtype=torch.bool))
        cleared = state.replace(pool=tbp.clear_dirty(state.pool))
        states.append((state, cleared))
        state = cleared
    return states


def ref_states(rng, codec="fp32", n_steps=3):
    """The same with the reference's build and ops."""
    base = make_clustered(rng, 120, 8, n_clusters=4)
    state = r_build_state(rcfg(codec), base)
    state = state.replace(pool=rbp.clear_dirty(state.pool))
    states = [state]
    for vecs, ids in _batches(rng, n_steps):
        state, _ = rlire.insert_batch(state, jnp.asarray(vecs), jnp.asarray(ids),
                                      jnp.ones(12, bool))
        state = rlire.delete_batch(state, jnp.asarray(ids[:3]), jnp.ones(3, bool))
        cleared = state.replace(pool=rbp.clear_dirty(state.pool))
        states.append((state, cleared))
        state = cleared
    return states


def write_chain(snap, root, states):
    store = snap.SnapshotStore(root)
    store.save_base(states[0], extra={"wal_seqnos": [0]})
    for i, (dirty, _cleared) in enumerate(states[1:], start=1):
        store.save_delta(dirty, extra={"wal_seqnos": [i]})
    return store


@pytest.mark.parametrize("codec", CODECS)
def test_leaf_order_is_the_references_flatten_order(codec):
    port = list(tensor_leaves(ttypes.make_empty_state(tcfg(codec), device="cpu")))
    ref = list(ref_leaves(rtypes.make_empty_state(rcfg(codec))))
    assert port == ref
    assert ("pool.blocks_exact" in port) == (codec != "fp32")
    assert list(tensor_leaves(meta_template(codec))) == port


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_reference_loads_the_chain_the_port_wrote(tmp_path, rng, codec):
    states = port_states(rng, codec)
    store = write_chain(tsnap, str(tmp_path / "snap"), states)
    assert store.chain_len() == len(states) - 1
    rstore = rsnap.SnapshotStore(str(tmp_path / "snap"))
    got, manifest = rstore.load(rtypes.make_empty_state(rcfg(codec)))
    assert manifest["extra"]["wal_seqnos"] == [len(states) - 1]
    assert_leaves_equal(states[-1][1], got)
    # and the port's own load of it
    mine, _ = store.load(meta_template(codec), device="cpu")
    assert_port_states_equal(mine, states[-1][1])
    head = store.unit_bytes()
    base = store.unit_bytes(store._chain(store._head())[0])
    assert head < 0.5 * base, (head, base)


@pytest.mark.parametrize("codec", CODECS)
def test_port_loads_the_chain_the_reference_wrote(tmp_path, rng, codec):
    states = ref_states(rng, codec)
    write_chain(rsnap, str(tmp_path / "snap"), states)
    store = tsnap.SnapshotStore(str(tmp_path / "snap"))
    got, manifest = store.load(meta_template(codec), device="cpu")
    assert manifest["extra"]["wal_seqnos"] == [len(states) - 1]
    assert_leaves_equal(got, states[-1][1])
    if codec == "bf16":
        assert got.pool.blocks.dtype == torch.bfloat16
        with np.load(os.path.join(store.path, store._chain(store._head())[0],
                                  "leaves.npz")) as data:
            assert data["leaf_0"].dtype == np.dtype("V2")


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path, rng):
    states = port_states(rng, "bf16", n_steps=1)
    tsnap.SnapshotStore(str(tmp_path / "port")).save_base(states[-1][1])
    rstates = ref_states(np.random.default_rng(0), "bf16", n_steps=1)
    rsnap.SnapshotStore(str(tmp_path / "ref")).save_base(rstates[-1][1])
    with np.load(tmp_path / "port" / "base-0000000001" / "leaves.npz") as port, \
            np.load(tmp_path / "ref" / "base-0000000001" / "leaves.npz") as ref:
        assert port["leaf_0"].dtype == ref["leaf_0"].dtype == np.dtype("V2")
        assert port["leaf_0"].shape == ref["leaf_0"].shape


def test_snapshot_store_compaction_folds_and_prunes(tmp_path, rng):
    states = port_states(rng)
    store = write_chain(tsnap, str(tmp_path / "snap"), states)
    final = states[-1][1]
    store.save_base(final)
    assert store.chain_len() == 0
    units = store._units()
    assert len(units) == 1 and units[0].startswith("base-")
    got, _ = store.load(meta_template(), device="cpu")
    assert_port_states_equal(got, final)


def test_snapshot_store_crash_at_every_fold_step(tmp_path, rng):
    """Kill the port's store at EVERY crash point of base → delta → delta
    → delta → compaction; a fresh store must then resolve a complete
    recovery point: the last committed state, or the next one where the
    crash came after that unit's commit."""
    states = port_states(rng)
    final = states[-1][1]

    class Boom(Exception):
        pass

    def lifecycle(store):
        store.save_base(states[0])
        yield "base"
        for i, (dirty, _cleared) in enumerate(states[1:]):
            store.save_delta(dirty)
            yield f"delta{i}"
        store.save_base(final)
        yield "compact"

    labels = []
    tsnap._crash_hook = labels.append
    try:
        for _ in lifecycle(tsnap.SnapshotStore(str(tmp_path / "count"))):
            pass
    finally:
        tsnap._crash_hook = None
    assert len(labels) >= 8, labels
    stages = ["start", "base"] + [f"delta{i}" for i in range(len(states) - 1)] + ["compact"]
    committed = {"start": states[0], "base": states[0], "compact": final}
    for i, (_d, cleared) in enumerate(states[1:]):
        committed[f"delta{i}"] = cleared
    for k in range(1, len(labels) + 1):
        calls = {"n": 0}

        def hook(label, _k=k):
            calls["n"] += 1
            if calls["n"] == _k:
                raise Boom(label)

        root = str(tmp_path / f"crash_{k}")
        done = "start"
        tsnap._crash_hook = hook
        try:
            for stage in lifecycle(tsnap.SnapshotStore(root)):
                done = stage
        except Boom:
            pass
        finally:
            tsnap._crash_hook = None
        reopened = tsnap.SnapshotStore(root)
        if done == "start" and not reopened.exists():
            continue
        got, _ = reopened.load(meta_template(), device="cpu")
        want = [committed[done], committed[stages[stages.index(done) + 1]]]
        pg = port_leaves(got)
        assert any(all(np.array_equal(pg[n], a) for n, a in port_leaves(w).items())
                   for w in want), f"crash point {k} ({labels[k - 1]})"


def test_snapshot_store_reads_a_legacy_full_snapshot(tmp_path, rng):
    """A root in the pre-chain layout (manifest.json at the root, one leaf
    short of today's pool: no dirty ledger) loads with the ledger migrated
    in as all-clean, and the first save_base converts the layout."""
    final = port_states(rng, n_steps=1)[-1][1]
    leaves = list(tensor_leaves(final).values())
    di = tsnap._dirty_leaf_index(final)
    legacy = [tsnap.to_numpy(x) for i, x in enumerate(leaves) if i != di]
    root = tmp_path / "snap"
    root.mkdir()
    np.savez(root / "leaves.npz", **{f"leaf_{i}": a for i, a in enumerate(legacy)})
    (root / "manifest.json").write_text(json.dumps(
        {"n_leaves": len(legacy), "step": 0, "extra": {"wal_seqnos": [5]}}))
    store = tsnap.SnapshotStore(str(root))
    assert store.exists() and not store.has_base()
    got, manifest = store.load(meta_template(), device="cpu")
    assert manifest["extra"]["wal_seqnos"] == [5]
    assert_port_states_equal(got, final)
    store.save_base(got)
    assert store.has_base() and not (root / "manifest.json").exists()


def test_legacy_save_snapshot_rotation_never_leaves_no_snapshot(tmp_path, rng):
    state = port_states(rng, n_steps=1)[-1][1]
    snap = str(tmp_path / "snap")
    tsnap.save_snapshot(snap, state, extra={"gen": 1})
    tsnap.save_snapshot(snap, state, extra={"gen": 2})
    assert not os.path.exists(snap + ".old")
    os.replace(snap, snap + ".old")          # crash between the two renames
    assert tsnap.snapshot_exists(snap)
    got, manifest = tsnap.load_snapshot(snap, meta_template(), device="cpu")
    assert manifest["extra"]["gen"] == 2
    assert_port_states_equal(got, state)
    tsnap.save_snapshot(snap, state, extra={"gen": 3})
    assert tsnap.read_manifest(snap)["extra"]["gen"] == 3
    assert not os.path.exists(snap + ".old")
    # the reference reads the port's legacy snapshot too
    rgot, _ = rsnap.load_snapshot(snap, rtypes.make_empty_state(rcfg()))
    assert_leaves_equal(state, rgot)


GENERATIONS = {
    "dirty": ("pool.dirty",),
    "codec": ("pool.post_scale", "pool.post_zero"),
    "telemetry": ("telemetry.access_count", "telemetry.update_count", "telemetry.drift_vec"),
    "dirty+telemetry": ("pool.dirty", "telemetry.access_count", "telemetry.update_count",
                        "telemetry.drift_vec"),
    "telemetry+codec": ("telemetry.access_count", "telemetry.update_count",
                        "telemetry.drift_vec", "pool.post_scale", "pool.post_zero"),
    "all": ("pool.dirty", "telemetry.access_count", "telemetry.update_count",
            "telemetry.drift_vec", "pool.post_scale", "pool.post_zero"),
}


@pytest.mark.parametrize("gen", list(GENERATIONS))
def test_migration_of_every_older_leaf_generation(tmp_path, rng, gen):
    """A snapshot short of a leaf group loads with each missing leaf
    rebuilt (clean ledger, zero telemetry, identity codec), as the
    reference migrates the same file."""
    final = port_states(rng, n_steps=1)[-1][1]
    leaves = tensor_leaves(final)
    kept = [tsnap.to_numpy(x) for n, x in leaves.items() if n not in GENERATIONS[gen]]
    root = tmp_path / "snap"
    root.mkdir()
    np.savez(root / "leaves.npz", **{f"leaf_{i}": a for i, a in enumerate(kept)})
    (root / "manifest.json").write_text(json.dumps({"n_leaves": len(kept), "extra": {}}))
    got, _ = tsnap.SnapshotStore(str(root)).load(meta_template(), device="cpu")
    for name, t in tensor_leaves(got).items():
        want = leaves[name]
        if name == "pool.post_scale" and name in GENERATIONS[gen]:
            want = torch.ones_like(want)
        elif name in GENERATIONS[gen]:
            want = torch.zeros_like(want)
        assert torch.equal(t, want), name
    rgot, _ = rsnap.SnapshotStore(str(root)).load(rtypes.make_empty_state(rcfg()))
    assert_leaves_equal(got, rgot)


# ---------------------------------------------------------------------------
# SPFreshIndex: single-log snapshot + WAL
# ---------------------------------------------------------------------------

def _index_cfg():
    from tests.test_lire import small_cfg
    import dataclasses

    return ttypes.LireConfig(**dataclasses.asdict(small_cfg()))


def test_index_snapshot_then_wal_replay_recovers(tmp_path, rng):
    cfg = _index_cfg()
    base = make_clustered(rng, 500, 16, n_clusters=4)
    wal_path = str(tmp_path / "wal.log")
    snap = str(tmp_path / "snap")
    idx = SPFreshIndex.build(cfg, base, wal_path=wal_path, device="cpu")
    idx.snapshot(snap)
    assert list(iter_wal(wal_path)) == []
    extra = make_clustered(rng, 60, 16, n_clusters=2)
    idx.insert(extra, np.arange(6000, 6060, dtype=np.int32))
    idx.delete(np.asarray([3, 4], np.int32))
    assert [r.op for r in iter_wal(wal_path)] == ["insert", "delete"]
    want = idx.search(extra[:8], 5)
    rec = SPFreshIndex.restore(snap, cfg, wal_path=wal_path, device="cpu")
    assert rec._wal_applied == idx._wal_applied == 1
    assert_port_states_equal(rec.state, idx.state)
    got = rec.search(extra[:8], 5)
    np.testing.assert_array_equal(want[1], got[1])
    _, hit = rec.search(base[3:4], 5)
    assert 3 not in hit[0].tolist()
    # the restored index keeps logging where the crashed one stopped
    rec.delete(np.asarray([5], np.int32))
    assert [r.seqno for r in iter_wal(wal_path)] == [0, 1, 2]


def test_index_restore_without_snapshot_replays_the_whole_wal(tmp_path, rng):
    """No snapshot: the WAL replays over an empty state (the build is not
    in the log), where no posting exists, so nothing lands and every
    insert is retried; the port does what the reference does with the log
    the reference wrote."""
    from repro.core.index import SPFreshIndex as RIndex
    from tests.test_lire import small_cfg

    wal_path = str(tmp_path / "wal.log")
    ridx = RIndex.build(small_cfg(), make_clustered(rng, 200, 16), wal_path=wal_path)
    ridx.insert(make_clustered(rng, 20, 16), np.arange(7000, 7020, dtype=np.int32))
    nosnap = str(tmp_path / "nosnap")
    want = RIndex.restore(nosnap, small_cfg(), wal_path=str(tmp_path / "wal.log"))
    rec = SPFreshIndex.restore(nosnap, _index_cfg(), wal_path=wal_path, device="cpu")
    assert rec._wal_applied == want._wal_applied == ridx._wal_applied == 0
    assert rec.stats() == want.stats()
    assert rec.stats()["n_postings"] == 0
