"""The service API and its crash-replay gates, within the port, on the CPU.

The reference's gates (``tests/test_service_api.py``) run here on
``repro_torch.api``: build a durable service, stream inserts/deletes
through the micro-batched pipeline (maintenance slots interleave), "crash"
by abandoning the handle, reopen with ``api.open(spec)`` — and the
recovered service must hold the uncrashed one's state leaf for leaf and
answer queries with the same ids and distances.  Counted: local exact
parity, checkpoint then tail, auto checkpoint, clean close and reopen,
double crash, the fresh-open crash window, config drift rejected, the
delta crash cycle, group-commit acks, the WAL-compaction live set,
telemetry bit-exact, pending access not being state, async crash replay
bit-exact, async equal to sync.

The sharded service's gates (the reference's
``tests/service_sharded_script.py``) run on the port over 2 shards: one
spec opens both backends, each shard's WAL takes the stream, a crash
recovers every shard leaf for leaf, a checkpoint then the tail, and the
delta chain with one file per shard.

Cross-package cases: the port opens a durable root the reference's
``spfresh.open`` wrote and recovers to the reference's state (integer
leaves equal, the telemetry's ``drift_vec`` within 1e-5, as in
``test_torch_serve.py``); and a sharded root in both directions.  The
reference's sharded service needs 2 devices, fixed when JAX starts, so
its half runs once in a subprocess: this file's ``__main__`` runner, with
``XLA_FLAGS`` set before anything imports JAX.  Every join has a timeout.
"""
import os
import sys

if __name__ == "__main__":
    # the reference half of the sharded cross-package cases
    # (``run_reference``): 2 fake CPU devices before JAX starts
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                               + os.environ.get("XLA_FLAGS", ""))

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import spfresh  # noqa: E402
from repro.configs.spfresh import service_spec as r_service_spec  # noqa: E402
from repro.core.types import LireConfig as RConfig  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs.spfresh import service_spec  # noqa: E402
from repro_torch.core.types import LireConfig  # noqa: E402
from repro_torch.storage.snapshot import SnapshotStore  # noqa: E402
from repro_torch.storage.wal import iter_wal  # noqa: E402
from tests.conftest import make_clustered  # noqa: E402
from tests.test_torch_snapshot import assert_port_states_equal  # noqa: E402
from tests.test_torch_storage import assert_leaves_equal  # noqa: E402

DEV = "cpu"
TIMEOUT = 120


def tiny_kw(**kw):
    args = dict(
        dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=1024,
        num_postings_cap=128, num_vectors_cap=4096, split_limit=48,
        merge_limit=6, reassign_range=8, reassign_budget=128,
        replica_count=2, nprobe=8,
    )
    args.update(kw)
    return args


def tiny_spec(root=None, cfg=None, **dur_kw) -> api.ServiceSpec:
    spec = api.ServiceSpec(
        index=api.IndexSpec(config=cfg or LireConfig(**tiny_kw())),
        serve=api.ServeSpec(search_k=10, max_batch=64),
    )
    if root is not None:
        spec = spec.with_durability(str(root), **dur_kw)
    return spec


def open_(spec, **kw):
    return api.open(spec, device=DEV, **kw)


def _stream(svc, rng, n=90, base_id=2000):
    """Inserts in 30-row chunks (maintenance slots fire) + a delete batch;
    returns (inserted vecs, ids, deleted ids)."""
    vecs = make_clustered(rng, n, 16, n_clusters=3)
    ids = np.arange(base_id, base_id + n, dtype=np.int32)
    for s in range(0, n, 30):
        svc.insert(vecs[s:s + 30], ids[s:s + 30])
    dead = ids[:10]
    svc.delete(dead)
    return vecs, ids, dead


def assert_same_answers(want, got):
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_allclose(want[0], got[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

def test_spec_compiles_like_the_references():
    spec = dataclasses.replace(
        tiny_spec(),
        serve=api.ServeSpec(search_k=7, nprobe=4, policy="backlog",
                            backlog_threshold=3, max_batch=128),
        scan=api.ScanSpec(probe_chunk=2, use_pallas_scan=True, scan_schedule="batched",
                          scan_page_budget=64),
        maintenance=api.MaintenanceSpec(jobs_per_round=2, merge_fanout=3),
    )
    rspec = dataclasses.replace(
        spfresh.ServiceSpec(index=spfresh.IndexSpec(config=RConfig(**tiny_kw()))),
        serve=spfresh.ServeSpec(search_k=7, nprobe=4, policy="backlog",
                                backlog_threshold=3, max_batch=128),
        scan=spfresh.ScanSpec(probe_chunk=2, use_pallas_scan=True, scan_schedule="batched",
                              scan_page_budget=64),
        maintenance=spfresh.MaintenanceSpec(jobs_per_round=2, merge_fanout=3),
    )
    assert dataclasses.asdict(spec.lire_config()) == dataclasses.asdict(rspec.lire_config())
    ecfg, recfg = dataclasses.asdict(spec.engine_config()), dataclasses.asdict(rspec.engine_config())
    assert ecfg == {k: recfg[k] for k in ecfg}
    assert ecfg["maintain_budget"] == 2 and ecfg["ack_batch"] == recfg["ack_batch"]
    assert tiny_spec().lire_config() == LireConfig(**tiny_kw())
    durable = tiny_spec().with_durability("/data/svc", checkpoint_every=100)
    assert durable.durability.resolved_wal_dir() == "/data/svc/wal"
    assert not tiny_spec().durability.enabled
    port = dataclasses.asdict(service_spec(smoke=True).lire_config())
    assert port == dataclasses.asdict(r_service_spec(smoke=True).lire_config())


def test_spec_validate_rejects_bad_values_and_the_distributed_deployment(rng):
    """Bad values are refused; the distributed deployment validates and
    opens on the CPU: sharded, replicated, and both."""
    for bad in (dict(serve=api.ServeSpec(policy="nope")),
                dict(serve=api.ServeSpec(replica_inflight=0)),
                dict(scan=api.ScanSpec(scan_schedule="zigzag")),
                dict(durability=api.DurabilitySpec(wal_dir="/data/wal"))):
        with pytest.raises(ValueError):
            dataclasses.replace(tiny_spec(), **bad).validate()
    with pytest.raises(ValueError, match="counts"):
        dataclasses.replace(tiny_spec(), shards=api.ShardSpec(n_shards=0)).validate()
    api.ServiceSpec(shards=api.ShardSpec(n_shards=4, n_replicas=2)).validate()
    service_spec(smoke=True, n_shards=4, n_replicas=2).validate()
    base = make_clustered(rng, 600, 16)
    for shards in (api.ShardSpec(n_shards=2), api.ShardSpec(n_replicas=2),
                   api.ShardSpec(n_shards=4, n_replicas=2)):
        spec = dataclasses.replace(tiny_spec(), shards=shards)
        assert (spec.sharded, spec.replicated) == (shards.n_shards > 1, shards.n_replicas > 1)
        svc = open_(spec, vectors=base)
        try:
            assert (svc.index is None) == spec.sharded
            assert (svc.replicas is None) == (not spec.replicated)
            _, v = svc.search(base[:4], k=5)
            want = svc.initial_handles[:4]
            assert (v[:, 0] == want).all()
            ids = None if spec.sharded else np.arange(2000, 2004, dtype=np.int32)
            got, landed = svc.insert(make_clustered(rng, 4, 16), ids)
            assert landed.all() and (got >= 0).all()
        finally:
            svc.close()


def test_open_without_a_snapshot_or_vectors_and_the_ephemeral_service(tmp_path, rng):
    with pytest.raises(FileNotFoundError):
        open_(tiny_spec())
    with pytest.raises(FileNotFoundError):
        open_(tiny_spec(tmp_path / "svc"))
    base = make_clustered(rng, 600, 16)
    svc = open_(tiny_spec(), vectors=base)
    assert not svc.durable and svc.initial_handles is not None
    _, v = svc.search(base[:4], k=5)
    assert (v[:, 0] == np.arange(4)).all()
    with pytest.raises(RuntimeError):
        svc.checkpoint()
    with pytest.raises(ValueError):
        svc.insert(make_clustered(rng, 4, 16))      # the local backend needs vids
    svc.close()


# ---------------------------------------------------------------------------
# crash-replay gates
# ---------------------------------------------------------------------------

def test_local_crash_recovery_exact_parity(tmp_path, rng):
    base = make_clustered(rng, 800, 16, n_clusters=6)
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=base)
    vecs, ids, dead = _stream(svc, rng)
    queries = np.concatenate([vecs[:12], base[:12]])
    want = svc.search(queries, k=10)

    twin = open_(spec)                 # crash: no checkpoint, no close
    assert twin.recovered and twin.recovery["replayed_records"] > 0
    assert_port_states_equal(twin.index.state, svc.index.state)
    got = twin.search(queries, k=10)
    assert_same_answers(want, got)
    leaked = set(got[1].reshape(-1).tolist()) & set(dead.tolist())
    assert not leaked, f"recovery resurrected {leaked}"
    _, hit = twin.search(vecs[20:30], k=3)
    assert (hit[:, 0] == ids[20:30]).all()


def test_local_checkpoint_then_tail_replay(tmp_path, rng):
    base = make_clustered(rng, 700, 16)
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=base)
    _stream(svc, rng, n=60)
    svc.checkpoint()
    wal0 = spec.durability.resolved_wal_dir() + "/shard_000.wal"
    assert list(iter_wal(wal0)) == []
    vecs2, _, _ = _stream(svc, rng, n=30, base_id=3000)
    assert len(list(iter_wal(wal0))) > 0
    want = svc.search(vecs2[:8], k=5)

    twin = open_(spec)
    assert_port_states_equal(twin.index.state, svc.index.state)
    assert_same_answers(want, twin.search(vecs2[:8], k=5))


def test_auto_checkpoint_every_n_update_rows(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc", checkpoint_every=50)
    svc = open_(spec, vectors=make_clustered(rng, 500, 16))
    vecs = make_clustered(rng, 60, 16)
    svc.insert(vecs, np.arange(2000, 2060, dtype=np.int32))
    assert svc.report()["durability"]["updates_since_checkpoint"] == 0
    assert list(iter_wal(spec.durability.resolved_wal_dir() + "/shard_000.wal")) == []
    twin = open_(spec)
    assert twin.recovery["replayed_records"] == 0
    _, got = twin.search(vecs[:6], k=3)
    assert (got[:, 0] == np.arange(2000, 2006)).all()


def test_clean_close_then_reopen_and_continue(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=make_clustered(rng, 600, 16))
    vecs, _, _ = _stream(svc, rng, n=30)
    want = svc.search(vecs[:8], k=5)
    svc.close()
    svc.close()                                  # idempotent
    svc2 = open_(spec)
    np.testing.assert_array_equal(want[1], svc2.search(vecs[:8], k=5)[1])
    more = make_clustered(rng, 20, 16)
    svc2.insert(more, np.arange(3000, 3020, dtype=np.int32))
    svc2.close()
    _, got3 = open_(spec).search(more[:5], k=3)
    assert (got3[:, 0] == np.arange(3000, 3005)).all()


def test_double_crash_cycle_keeps_post_recovery_updates(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=make_clustered(rng, 500, 16))
    svc.insert(make_clustered(rng, 20, 16), np.arange(2000, 2020, dtype=np.int32))
    svc.checkpoint()
    svc2 = open_(spec)                           # crash #1
    vecs = make_clustered(rng, 20, 16)
    svc2.insert(vecs, np.arange(3000, 3020, dtype=np.int32))
    want = svc2.search(vecs[:6], k=3)
    svc3 = open_(spec)                           # crash #2
    assert_port_states_equal(svc3.index.state, svc2.index.state)
    got = svc3.search(vecs[:6], k=3)
    np.testing.assert_array_equal(want[1], got[1])
    assert (got[1][:, 0] == np.arange(3000, 3006)).all()


def test_fresh_open_and_its_crash_window(tmp_path, rng):
    """``fresh=True`` supersedes a root only at its open-time checkpoint:
    before it, the root still recovers the previous incarnation; and a
    rebuild with ``snapshot_on_open=False`` over a non-empty root is
    refused."""
    base = make_clustered(rng, 400, 16)
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=base)
    vecs = make_clustered(rng, 20, 16)
    svc.insert(vecs, np.arange(2000, 2020, dtype=np.int32))   # WAL only
    want = svc.search(vecs[:6], k=3)
    assert len(list(iter_wal(spec.durability.resolved_wal_dir() + "/shard_000.wal"))) > 0
    np.testing.assert_array_equal(want[1], open_(spec).search(vecs[:6], k=3)[1])
    dirty = dataclasses.replace(spec, durability=dataclasses.replace(
        spec.durability, snapshot_on_open=False))
    with pytest.raises(ValueError, match="non-empty durable root"):
        open_(dirty, vectors=base, fresh=True)
    with pytest.raises(ValueError):
        open_(spec, fresh=True)                  # fresh needs vectors
    base2 = make_clustered(rng, 500, 16)
    svc2 = open_(spec, vectors=base2, fresh=True)
    assert not svc2.recovered
    _, got = svc2.search(base2[:4], k=3)
    assert (got[:, 0] == np.arange(4)).all()
    svc3 = open_(spec)
    assert svc3.recovered
    np.testing.assert_array_equal(got, svc3.search(base2[:4], k=3)[1])


def test_recovery_rejects_replay_critical_config_drift(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc")
    open_(spec, vectors=make_clustered(rng, 400, 16)).close()
    for field, value in (("split_limit", 32), ("num_blocks", 2048),
                         ("maintain_policy", "drift"), ("use_pallas_nav", True)):
        drifted = dataclasses.replace(
            spec, index=api.IndexSpec(config=LireConfig(**tiny_kw(**{field: value}))))
        with pytest.raises(ValueError, match=field):
            open_(drifted)
    serving = dataclasses.replace(
        spec, index=api.IndexSpec(config=LireConfig(**tiny_kw(nprobe=4))))
    assert open_(serving).recovered                # nprobe is not critical


def test_recovery_preserves_maintenance_invariants(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc")
    svc = open_(spec, vectors=make_clustered(rng, 800, 16, n_clusters=2))
    _stream(svc, rng, n=120)
    assert svc.stats()["n_splits"] > 0
    twin = open_(spec)
    assert twin.stats() == svc.stats()
    twin.drain()
    assert twin.backlog() == 0
    lens = twin.index.state.pool.posting_len[twin.index.state.centroid_valid]
    assert int(lens.max()) <= twin.index.state.cfg.split_limit


def test_delta_checkpoint_crash_cycle_exact_parity(tmp_path, rng):
    base = make_clustered(rng, 800, 16, n_clusters=6)
    spec = tiny_spec(tmp_path / "svc", delta_every=30, compact_every=2)
    svc = open_(spec, vectors=base)
    store = SnapshotStore(spec.durability.resolved_snapshot_dir())
    assert store.has_base() and store.chain_len() == 0
    vecs, _, dead = _stream(svc, rng, n=90)
    assert store.chain_len() <= 2
    assert svc.report()["durability"]["snapshot_chain_len"] == store.chain_len()
    queries = np.concatenate([vecs[:12], base[:12]])
    want = svc.search(queries, k=10)
    twin = open_(spec)
    assert twin.recovered
    assert_port_states_equal(twin.index.state, svc.index.state)
    got = twin.search(queries, k=10)
    assert_same_answers(want, got)
    assert twin.stats() == svc.stats()
    assert not set(got[1].reshape(-1).tolist()) & set(dead.tolist())
    more = make_clustered(rng, 30, 16)
    with pytest.raises(ValueError, match="num_vectors_cap"):
        twin.insert(more, np.arange(5000, 5030, dtype=np.int32))   # cap 4096
    twin.insert(more, np.arange(4000, 4030, dtype=np.int32))
    want2 = twin.search(more[:8], k=5)
    assert_same_answers(want2, open_(spec).search(more[:8], k=5))


def test_explicit_delta_and_compaction_checkpoints(tmp_path, rng):
    base = make_clustered(rng, 500, 16)
    spec = tiny_spec(tmp_path / "svc", snapshot_on_open=False)
    store = SnapshotStore(spec.durability.resolved_snapshot_dir())
    svc = open_(spec, vectors=base)
    assert not store.exists()
    svc.checkpoint(delta=True)                   # promotes: nothing to chain to
    assert store.has_base() and store.chain_len() == 0
    svc.insert(make_clustered(rng, 20, 16), np.arange(2000, 2020, dtype=np.int32))
    svc.checkpoint(delta=True)
    assert store.chain_len() == 1
    assert svc.last_checkpoint["unit"].startswith("delta-")
    full = store.unit_bytes(store._chain(store._head())[0])
    assert svc.last_checkpoint["bytes"] == store.unit_bytes() < 0.5 * full
    svc.checkpoint(delta=False)
    assert store.chain_len() == 0 and len(store._units()) == 1
    want = svc.search(base[:6], k=5)
    np.testing.assert_array_equal(want[1], open_(spec).search(base[:6], k=5)[1])


def test_group_commit_acks_then_recovers_exactly(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc", group_commit=16)
    svc = open_(spec, vectors=make_clustered(rng, 600, 16))
    stream = make_clustered(rng, 96, 16, n_clusters=3)
    ids = np.arange(3000, 3096, dtype=np.int32)
    got_ids, landed = svc.insert_bulk(stream, ids, chunk=32)
    assert landed.all() and (got_ids == ids).all()
    st = svc.report()["durability"]["wal"]
    assert st["pending"] == 0
    assert st["fsyncs_per_append"] < 0.5, st
    svc.delete(ids[:5])
    want = svc.search(stream[:10], k=5)
    twin = open_(spec)
    assert_port_states_equal(twin.index.state, svc.index.state)
    assert_same_answers(want, twin.search(stream[:10], k=5))
    _, hit = twin.search(stream[10:20], k=1)
    assert (hit[:, 0] == ids[10:20]).all(), "acked insert lost post-crash"


def test_wal_compaction_recovery_preserves_live_set(tmp_path, rng):
    spec = tiny_spec(tmp_path / "svc", compact_wal=True)
    svc = open_(spec, vectors=make_clustered(rng, 600, 16))
    wave1 = make_clustered(rng, 30, 16)
    ids1 = np.arange(2000, 2030, dtype=np.int32)
    svc.insert(wave1, ids1)
    svc.delete(ids1)
    wave2 = make_clustered(rng, 30, 16)
    ids2 = np.arange(4000, 4030, dtype=np.int32)
    svc.insert(wave2, ids2)
    twin = open_(spec)
    _, hit = twin.search(wave2[:10], k=1)
    assert (hit[:, 0] == ids2[:10]).all(), "live insert lost by compaction"
    _, got = twin.search(wave1[:10], k=10)
    assert not set(got.reshape(-1).tolist()) & set(ids1.tolist())
    assert twin.stats()["n_appends"] < svc.stats()["n_appends"]


def _drift_spec(root) -> api.ServiceSpec:
    return dataclasses.replace(
        tiny_spec(root),
        maintenance=api.MaintenanceSpec(policy="drift", alpha=4.0, beta=1.0),
    )


def test_crash_recovery_replays_telemetry_bit_exactly(tmp_path, rng):
    base = make_clustered(rng, 800, 16, n_clusters=2)
    spec = _drift_spec(tmp_path / "svc")
    svc = open_(spec, vectors=base)
    vecs, _, _ = _stream(svc, rng, n=90)
    for qs in (base[:32], vecs[:32], base[100:132]):
        svc.search(qs, k=10)
        svc.maintain(2)
    st = svc.stats()
    assert st["access_total"] > 0 and st["update_total"] > 0
    twin = open_(spec)
    assert twin.stats() == st
    assert_port_states_equal(twin.index.state, svc.index.state)
    q = np.concatenate([vecs[:10], base[:10]])
    np.testing.assert_array_equal(svc.search(q, k=10)[1], twin.search(q, k=10)[1])


def test_pending_access_is_not_state_until_logged(tmp_path, rng):
    base = make_clustered(rng, 500, 16)
    spec = _drift_spec(tmp_path / "svc")
    svc = open_(spec, vectors=base)
    svc.search(base[:64], k=10)
    assert svc.backend._pending_access.sum() > 0
    assert svc.stats()["access_total"] == 0
    twin = open_(spec)
    assert twin.stats()["access_total"] == 0
    assert twin.stats() == svc.stats()
    with pytest.raises(ValueError, match="maintain_alpha"):
        open_(dataclasses.replace(spec, maintenance=api.MaintenanceSpec(
            policy="drift", alpha=8.0, beta=1.0)))


def _async_spec(root=None, max_wait_ms=2.0, **dur_kw) -> api.ServiceSpec:
    spec = tiny_spec(root, **dur_kw)
    return dataclasses.replace(spec, serve=dataclasses.replace(
        spec.serve, async_serve=True, max_wait_ms=max_wait_ms))


def test_async_service_crash_replay_bit_exact(tmp_path, rng):
    """The pump thread owns every WAL append + dispatch in one serialized
    order: a threaded async run's WAL replays to a bit-identical index,
    and no update ticket resolves before the fsync that covers it."""
    base = make_clustered(rng, 800, 16, n_clusters=6)
    spec = _async_spec(tmp_path / "svc", group_commit=8)
    svc = open_(spec, vectors=base)
    assert svc.engine.is_async
    ws = svc.backend.wal_set
    durable = [-1]
    sync = ws.sync

    def counted_sync():
        sync()
        durable[0] = ws.next_seqno - 1

    ws.sync = counted_sync
    errors, early = [], []

    def worker(tid):
        trng = np.random.default_rng(50 + tid)
        vecs = make_clustered(trng, 24, 16, n_clusters=2)
        ids = np.arange(3000 + 100 * tid, 3024 + 100 * tid, dtype=np.int32)
        try:
            for s in range(0, 24, 8):
                tk = svc.engine.submit_insert(vecs[s:s + 8], ids[s:s + 8])
                tk.result(timeout=TIMEOUT)
                if tk.seqno > durable[0]:
                    early.append(tk.seqno)
                svc.search(vecs[s:s + 4], k=5)
            svc.delete(ids[:4])
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "async submitter hung"
    assert not errors, errors
    assert not early, f"update tickets resolved before their fsync: {early}"
    svc.flush()
    want = svc.search(base[:16], k=10)
    state = svc.index.state
    svc.engine.shutdown(timeout=TIMEOUT)         # no checkpoint, no close

    twin = open_(spec)
    assert twin.recovered
    assert_port_states_equal(twin.index.state, state)
    assert_same_answers(want, twin.search(base[:16], k=10))
    twin.engine.shutdown(timeout=TIMEOUT)


def test_async_matches_sync_state_bit_exactly(rng):
    base = make_clustered(rng, 600, 16, n_clusters=4)
    states = {}
    for mode in ("sync", "async"):
        spec = tiny_spec() if mode == "sync" else _async_spec(max_wait_ms=0.0)
        svc = open_(spec, vectors=base)
        srng = np.random.default_rng(7)
        vecs = make_clustered(srng, 48, 16, n_clusters=3)
        ids = np.arange(2000, 2048, dtype=np.int32)
        for s in range(0, 48, 8):
            svc.insert(vecs[s:s + 8], ids[s:s + 8])
            svc.flush()
            svc.search(vecs[s:s + 4], k=5)
            svc.flush()
        svc.delete(ids[:6])
        svc.flush()
        states[mode] = svc.index.state
        svc.engine.shutdown(timeout=TIMEOUT)
    assert_port_states_equal(states["sync"], states["async"])


def test_port_recovers_a_root_the_reference_wrote(tmp_path, rng):
    """The reference's ``spfresh.open`` builds a durable root and streams
    updates into it (no maintenance: the two packages draw their split
    randomness differently); the port opens the root, loads the
    reference's base snapshot and replays the reference's WAL through its
    own dispatches, landing on the reference's state."""
    base = make_clustered(rng, 700, 16, n_clusters=5)
    knobs = dict(search_k=10, max_batch=64, fg_bg_ratio=0, max_insert_retries=0)
    rspec = spfresh.ServiceSpec(
        index=spfresh.IndexSpec(config=RConfig(**tiny_kw())),
        serve=spfresh.ServeSpec(**knobs),
    ).with_durability(str(tmp_path / "svc"))
    rsvc = spfresh.open(rspec, vectors=base)
    vecs = make_clustered(rng, 60, 16, n_clusters=3)
    ids = np.arange(2000, 2060, dtype=np.int32)
    for s in range(0, 60, 20):
        rsvc.insert(vecs[s:s + 20], ids[s:s + 20])
    rsvc.delete(ids[:7])
    want = rsvc.search(vecs[:12], k=10)

    tspec = dataclasses.replace(tiny_spec(tmp_path / "svc"), serve=api.ServeSpec(**knobs))
    twin = open_(tspec)
    assert twin.recovered and twin.recovery["replayed_records"] == 4
    assert twin.stats()["n_inserts"] == 60 and twin.stats()["n_deletes"] == 7
    assert_leaves_equal(twin.index.state, rsvc.index.state, close=("telemetry.drift_vec",))
    got = twin.search(vecs[:12], k=10)
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_allclose(want[0], got[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded service (the reference's service_sharded_script.py)
# ---------------------------------------------------------------------------

def sharded_spec(root=None, **dur_kw) -> api.ServiceSpec:
    spec = dataclasses.replace(tiny_spec(), serve=api.ServeSpec(search_k=10, max_batch=64,
                                                                min_bucket=16))
    if root is not None:
        spec = spec.with_durability(str(root), **dur_kw)
    return spec.with_shards(2)


def assert_shards_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_port_states_equal(x, y)


def test_sharded_service_crash_recovery_exact_parity(tmp_path):
    rng = np.random.default_rng(0)
    base = make_clustered(rng, 1000, 16, n_clusters=10)
    spec = sharded_spec(tmp_path / "svc")
    local = open_(dataclasses.replace(spec, shards=api.ShardSpec(),
                                      durability=api.DurabilitySpec()), vectors=base)
    svc = open_(spec, vectors=base)
    assert svc.index is None and svc.initial_handles is not None and local.index is not None
    d_l, _ = local.search(base[:8], k=5)
    d_s, _ = svc.search(base[:8], k=5)
    np.testing.assert_allclose(d_l[:, 0], d_s[:, 0], rtol=1e-4)    # one corpus
    local.close()

    new = make_clustered(rng, 90, 16, n_clusters=3)
    handles = []
    for s in range(0, 90, 30):
        h, landed = svc.insert(new[s:s + 30])
        assert landed.all()
        handles.extend(h.tolist())
    handles = np.asarray(handles, np.int64)
    svc.delete(handles[:10].astype(np.int32))
    queries = np.concatenate([new[:12], base[:12]])
    want = svc.search(queries, k=10)
    for shard in range(2):
        assert len(list(iter_wal(svc.backend.wal_set.shard_path(shard)))) > 0

    twin = open_(spec)                          # crash: per-shard WAL replay
    assert twin.recovered and twin.recovery["replayed_records"] > 0
    assert_shards_equal(twin.backend.states, svc.backend.states)
    got = twin.search(queries, k=10)
    assert_same_answers(want, got)
    assert not set(got[1].reshape(-1).tolist()) & set(handles[:10].tolist())
    _, hit = twin.search(new[20:30], k=3)
    assert (hit[:, 0] == handles[20:30]).all(), "replayed handles diverged"
    assert twin.stats() == svc.stats()
    live_vecs = np.concatenate([base, new[10:]])
    live_h = np.concatenate([svc.initial_handles, handles[10:]])
    bf = ((queries[:, None, :] - live_vecs[None]) ** 2).sum(-1)
    gt = live_h[np.argsort(bf, axis=1)[:, :10]]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), got[1].tolist())])
    assert recall > 0.85, recall


def test_sharded_checkpoint_tail_replay_and_delta_chain(tmp_path):
    rng = np.random.default_rng(1)
    spec = sharded_spec(tmp_path / "svc")
    svc = open_(spec, vectors=make_clustered(rng, 1000, 16, n_clusters=10))
    svc.insert(make_clustered(rng, 60, 16, n_clusters=3))
    svc.checkpoint()
    more = make_clustered(rng, 30, 16, n_clusters=2)
    svc.insert(more)
    want = svc.search(more[:8], k=5)
    svc3 = open_(spec)                          # the snapshot + the tail only
    assert_same_answers(want, svc3.search(more[:8], k=5))
    svc3.drain()
    assert svc3.backlog() == 0
    svc3.close()

    store = SnapshotStore(spec.durability.resolved_snapshot_dir())
    svc4 = open_(spec)                          # the clean close: a base
    assert store.has_base() and store.chain_len() == 0
    more2 = make_clustered(rng, 24, 16, n_clusters=2)
    h3, landed3 = svc4.insert(more2)
    assert landed3.all()
    svc4.checkpoint(delta=True)
    assert store.chain_len() == 1
    unit_dir = os.path.join(spec.durability.resolved_snapshot_dir(), store._head())
    assert sorted(f for f in os.listdir(unit_dir) if f.endswith(".npz")) == [
        "shard_000.npz", "shard_001.npz"]
    svc4.insert(make_clustered(rng, 12, 16, n_clusters=2))     # a tail on the delta
    want = svc4.search(more2[:8], k=5)
    svc5 = open_(spec)                          # base + delta + tail
    assert_shards_equal(svc5.backend.states, svc4.backend.states)
    assert_same_answers(want, svc5.search(more2[:8], k=5))
    assert svc5.stats() == svc4.stats()
    _, hit = svc5.search(more2[:8], k=1)
    assert (hit[:, 0] == h3[:8]).all()
    svc5.checkpoint(delta=False)                # compaction folds the chain
    assert store.chain_len() == 0
    svc5.close()


# ---------------------------------------------------------------------------
# sharded roots across the packages
# ---------------------------------------------------------------------------

CROSS_KNOBS = dict(search_k=10, max_batch=64, fg_bg_ratio=0, max_insert_retries=0)


def cross_inputs():
    """The sharded cross-package stream (both halves call this): a build,
    three insert batches, a delete, queries; no maintenance, since the two
    packages draw their split randomness differently."""
    rng = np.random.default_rng(5)
    base = make_clustered(rng, 800, 16, n_clusters=6)
    vecs = make_clustered(rng, 60, 16, n_clusters=3)
    return dict(base=base, vecs=vecs, queries=np.concatenate([vecs[:12], base[:12]]))


def cross_stream(svc, x):
    """Two insert batches, a delta checkpoint (one file per shard), then
    the WAL tail: an insert batch and a delete.  Returns the insert handles
    (the sharded backend's own)."""
    hs = [svc.insert(x["vecs"][s:s + 20])[0] for s in range(0, 40, 20)]
    svc.checkpoint(delta=True)
    hs.append(svc.insert(x["vecs"][40:60])[0])
    h = np.concatenate(hs)
    svc.delete(h[:7][h[:7] >= 0].astype(np.int32))
    return h


def run_reference(root_a: str, root_b: str, out_path: str) -> None:
    """The reference's half: write sharded root A (crash: no close), and
    recover sharded root B, which the port wrote."""
    import jax

    assert len(jax.devices()) == 2, jax.devices()
    x = cross_inputs()
    out = {}

    def leaves(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in flat:
            out[prefix + "." + ".".join(k.name for k in path)] = np.array(v)

    def rspec(root):
        return spfresh.ServiceSpec(
            index=spfresh.IndexSpec(config=RConfig(**tiny_kw())),
            serve=spfresh.ServeSpec(**CROSS_KNOBS),
        ).with_durability(root).with_shards(2)

    svc = spfresh.open(rspec(root_a), vectors=x["base"])
    out["a.handles"] = cross_stream(svc, x)
    out["a.d"], out["a.v"] = svc.search(x["queries"], k=10)
    leaves("astate", svc.backend.stacked)
    twin = spfresh.open(rspec(root_b))
    out["b.recovered"] = np.asarray(twin.recovered)
    out["b.d"], out["b.v"] = twin.search(x["queries"], k=10)
    leaves("bstate", twin.backend.stacked)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def sharded_roots(tmp_path_factory):
    """Root B written by the port (a crash: no close), then the reference's
    half in a subprocess: it writes root A and recovers root B."""
    d = tmp_path_factory.mktemp("roots")
    root_a, root_b, out = str(d / "a"), str(d / "b"), str(d / "ref.npz")
    x = cross_inputs()
    spec = dataclasses.replace(sharded_spec(root_b), serve=api.ServeSpec(**CROSS_KNOBS))
    svc = open_(spec, vectors=x["base"])
    cross_stream(svc, x)
    want = svc.search(x["queries"], k=10)
    kept = convert.sharded_state_to_numpy(svc.backend.states)
    svc.engine.shutdown(timeout=TIMEOUT)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(os.path.dirname(here), "src"),
                                         os.path.dirname(here), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root_a, root_b, out],
                          capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        ref = {k: data[k] for k in data.files}
    return dict(ref=ref, root_a=root_a, port_want=want, port_kept=kept, spec=spec)


def _stacked(ref, prefix):
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _assert_stacked_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        if name == "telemetry.drift_vec":
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_port_recovers_a_sharded_root_the_reference_wrote(sharded_roots):
    ref = sharded_roots["ref"]
    spec = dataclasses.replace(sharded_roots["spec"], durability=api.DurabilitySpec(
        root=sharded_roots["root_a"]))
    assert SnapshotStore(spec.durability.resolved_snapshot_dir()).chain_len() == 1
    twin = open_(spec)
    assert twin.recovered and twin.recovery["replayed_records"] == 2
    _assert_stacked_equal(convert.sharded_state_to_numpy(twin.backend.states),
                          _stacked(ref, "astate"))
    d, v = twin.search(cross_inputs()["queries"], k=10)
    np.testing.assert_array_equal(v, ref["a.v"])
    np.testing.assert_allclose(d, ref["a.d"], rtol=1e-5, atol=1e-5)
    twin.engine.shutdown(timeout=TIMEOUT)


def test_reference_recovers_a_sharded_root_the_port_wrote(sharded_roots):
    ref = sharded_roots["ref"]
    assert bool(ref["b.recovered"])
    _assert_stacked_equal(sharded_roots["port_kept"], _stacked(ref, "bstate"))
    want = sharded_roots["port_want"]
    np.testing.assert_array_equal(ref["b.v"], want[1])
    np.testing.assert_allclose(ref["b.d"], want[0], rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    run_reference(*sys.argv[1:4])
