"""The sharded SPFresh index: postings partitioned over shards in
centroid space, every shard a LIRE index of its own.

The JAX package's design, carried over:

* postings are partitioned in *centroid space* (balanced k-means over the
  shards), so LIRE's reassignment stays shard-local;
* search runs the per-shard local top-k, then ONE tournament merge of the
  ``M·k`` candidates per query;
* vector handles are ``(shard, slot)``: ``handle = shard * num_vectors_cap
  + slot``, and each vector's version state is owned by exactly one shard;
* a ``shard_alive`` mask degrades dead shards gracefully.

The JAX package stacks the shards into one state (a leading ``(n_shards,)``
axis on every leaf) and ``shard_map``s its steps.  Here the shards are a
**list of per-shard states**, each writing its own block pool in place,
and every step is a plain function over that list: it dispatches each
shard's work in shard order on the current stream, with no host sync
between shards.  ``convert.sharded_state_from_numpy`` /
``sharded_state_to_numpy`` carry the reference's stacked state across.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.convert import sharded_state_from_numpy
from repro_torch.core import lire
from repro_torch.core.clustering import balanced_kmeans
from repro_torch.core.distance import MASK_DISTANCE, stable_topk
from repro_torch.core.index import build_state, upload
from repro_torch.core.types import IndexState, LireConfig, make_empty_state, resolve_device
from repro_torch.serve.engine import _read_back_later
from repro_torch.storage import versionmap as vm
from repro_torch.storage.durability import DurableBackend
from repro_torch.storage.snapshot import SnapshotStore, stacked_template
from repro_torch.utils.tree import clone_state, map_tensors, tensor_leaves

# the counters ``stats()`` sums over the shards (the reference's list)
_STAT_KEYS = (
    "n_inserts", "n_deletes", "n_appends", "n_append_drops", "n_splits",
    "n_gc_writebacks", "n_merges", "n_reassign_checked",
    "n_reassign_candidates", "n_reassigned", "n_reassign_overflow",
)


# ---------------------------------------------------------------------------
# The steps: plain functions over the list of per-shard states
# ---------------------------------------------------------------------------

def sharded_search(states: list[IndexState], queries, shard_alive, *, k: int,
                   nprobe: int | None = None, probe_chunk: int = 0,
                   use_pallas_scan: bool | None = None, scan_schedule: str | None = None,
                   gprobe: int = 0, group_indexes=None):
    """``(dists (Q, k), handles (Q, k))`` over every shard.

    Each shard runs ``lire.search`` (``search_grouped`` over its own
    ``group_indexes[s]`` when ``gprobe > 0``); its vids become handles
    ``s * num_vectors_cap + vid``; a shard dead in ``shard_alive`` gives
    MASK_DISTANCE and -1.  The tournament merge lays each query's ``M·k``
    candidates out shard-major and keeps the ``k`` smallest, the lowest
    position first among ties; a merged slot at MASK_DISTANCE is -1."""
    cfg = states[0].cfg
    nprobe_ = nprobe or cfg.nprobe
    n_cap = cfg.num_vectors_cap
    all_d, all_v = [], []
    for s, st in enumerate(states):
        if gprobe > 0:
            from repro_torch.core.grouping import search_grouped

            d, v = search_grouped(
                st, group_indexes[s], queries, k=k, nprobe=nprobe_, gprobe=gprobe,
                probe_chunk=probe_chunk, use_pallas_scan=use_pallas_scan,
                scan_schedule=scan_schedule,
            )
        else:
            d, v = lire.search(
                st, queries, k=k, nprobe=nprobe_, probe_chunk=probe_chunk,
                use_pallas_scan=use_pallas_scan, scan_schedule=scan_schedule,
            )
        gv = torch.where(v >= 0, s * n_cap + v, -1)
        alive = shard_alive[s]
        all_d.append(torch.where(alive, d, MASK_DISTANCE))
        all_v.append(torch.where(alive, gv, -1))
    q = all_d[0].shape[0]
    cat_d = torch.stack(all_d, dim=1).reshape(q, -1)        # (Q, M·k), shard-major
    cat_v = torch.stack(all_v, dim=1).reshape(q, -1)
    out_d, sel = stable_topk(cat_d, k)
    out_v = torch.gather(cat_v, 1, sel)
    return out_d, torch.where(out_d < MASK_DISTANCE / 2, out_v, -1).to(torch.int32)


def sharded_insert(states: list[IndexState], vecs, valid, *, inplace: bool = False):
    """Insert each row into the shard that owns it; returns ``(states,
    handles (B,))``.

    The owner is the shard with the globally nearest centroid (the first
    such shard on a tie).  Each shard allocates local slots ``next_vid +
    rank`` for its rows, masked by ``slot < num_vectors_cap``, and appends
    them with ``lire.insert_batch``.  A row whose primary append did not
    land (or that found no slot, or is padding) gets handle -1: the
    engine's backpressure retry keys off it.  ``next_vid`` advances by the
    slots handed out, landed or not, as the reference's step does."""
    cfg = states[0].cfg
    n_cap = cfg.num_vectors_cap
    best = torch.stack([lire.navigate(st, vecs, 1)[0][:, 0] for st in states])   # (M, B)
    owner = torch.argmin(best, dim=0)               # the first shard at the minimum
    out, handles, n_ok = [], None, None
    for s, st in enumerate(states):
        mine = (owner == s) & valid
        order = torch.cumsum(mine.to(torch.int32), 0) - 1
        slots = torch.where(mine, st.next_vid + order, -1).to(torch.int32)
        mine = mine & (slots < n_cap)
        st = st.replace(next_vid=st.next_vid + mine.sum().to(torch.int32))
        st, landed = lire.insert_batch(st, vecs, torch.clamp(slots, min=0), mine,
                                       inplace=inplace)
        ok = mine & landed
        part = torch.where(ok, s * n_cap + slots, 0)
        handles = part if handles is None else handles + part
        n_ok = ok.to(torch.int32) if n_ok is None else n_ok + ok.to(torch.int32)
        out.append(st)
    return out, torch.where(n_ok > 0, handles, -1).to(torch.int32)


def sharded_delete(states: list[IndexState], handles) -> list[IndexState]:
    """Tombstone each handle ``h >= 0`` in shard ``h // num_vectors_cap``,
    slot ``h % num_vectors_cap``."""
    n_cap = states[0].cfg.num_vectors_cap
    owner = torch.div(handles, n_cap, rounding_mode="floor")
    slot = torch.remainder(handles, n_cap)
    return [lire.delete_batch(st, slot, (owner == s) & (handles >= 0))
            for s, st in enumerate(states)]


def sharded_maintenance_step(states: list[IndexState], budget: int = 1, *, draw=None,
                             inplace: bool = False):
    """``budget`` sequential one-job ``lire.maintenance_step``s on every
    shard; returns ``(states, did)``, ``did`` the largest count of steps
    that acted on any shard.  The baseline the round is measured against.
    ``draw(state, k)``, when given, supplies each split's random draw
    ``(next key, scores)`` from the shard's state (a test injecting the
    reference's)."""
    out, dids = [], []
    for st in states:
        total = torch.zeros((), dtype=torch.int32, device=st.device)
        for _ in range(budget):
            st, did = lire.maintenance_step(
                st, draw=None if draw is None else draw(st, 1), inplace=inplace)
            total = total + did.to(torch.int32)
        out.append(st)
        dids.append(total)
    return out, torch.stack(dids).amax()


def sharded_maintenance_round(states: list[IndexState], jobs_per_round: int, *, draw=None,
                              inplace: bool = False):
    """One batched ``lire.maintenance_round`` (``jobs_per_round`` splits
    and merges, one fused reassign pass) on every shard: rebalancing is
    shard-local by the centroid-space partition.  Returns ``(states,
    did)``, ``did`` the largest job count over the shards — the one
    scalar a drain reads back.  ``draw`` as in
    :func:`sharded_maintenance_step`."""
    cfg = states[0].cfg
    k = max(1, min(int(jobs_per_round), cfg.num_postings_cap // 2))
    out, dids = [], []
    for st in states:
        st, did = lire.maintenance_round(
            st, jobs_per_round, draw=None if draw is None else draw(st, k), inplace=inplace)
        out.append(st)
        dids.append(did.to(torch.int32))
    return out, torch.stack(dids).amax()


# ---------------------------------------------------------------------------
# Sharded build (offline) and elastic re-sharding
# ---------------------------------------------------------------------------

def partition_vectors(vectors: np.ndarray, n_shards: int, seed: int = 0, *,
                      device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Centroid-space partition: balanced k-means into ``n_shards`` groups
    (12 iterations, balance weight 2.0), its draw from a
    ``torch.Generator`` seeded with ``seed``.  Returns ``(assignment (n,),
    shard_centroids (n_shards, d))`` as numpy arrays."""
    if n_shards == 1:
        return (np.zeros(len(vectors), np.int32),
                vectors.mean(axis=0, keepdims=True).astype(np.float32))
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(vectors, np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cen, assign = balanced_kmeans(
        x, torch.ones(len(vectors), dtype=torch.bool, device=dev), k=n_shards,
        generator=gen, iters=12, balance_weight=2.0,
    )
    return assign.cpu().numpy().astype(np.int32), cen.cpu().numpy()


def build_sharded_state(cfg: LireConfig, vectors: np.ndarray, n_shards: int, *,
                        seed: int = 0, device="cuda") -> tuple[list[IndexState], np.ndarray]:
    """Offline build: partition in centroid space, SPANN-build each shard.
    Returns ``(states, handle of each input (n,))``, handles in the
    ``(shard, slot)`` scheme."""
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    assign, _ = partition_vectors(vectors, n_shards, seed, device=dev)
    states, handles = [], np.full(len(vectors), -1, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(assign == s)
        if len(idx) == 0:
            st = make_empty_state(cfg, seed=seed + s, device=dev)
        else:
            st = build_state(cfg, vectors[idx], seed=seed + s, device=dev)
            st = st.replace(next_vid=torch.tensor(len(idx), dtype=torch.int32, device=dev))
            handles[idx] = s * cfg.num_vectors_cap + np.arange(len(idx))
        states.append(st)
    return states, handles


def gather_live_vectors(states: list[IndexState]) -> tuple[np.ndarray, np.ndarray]:
    """Every live vector and its handle, read on the host: the exact fp32
    tier when the codec keeps one (no requantization error), one row per
    vid (the first replica in pool order)."""
    out_v, out_h = [], []
    for s, st in enumerate(states):
        pool = st.pool
        vids = pool.block_vid.reshape(-1)
        stale = vm.is_stale(st.versions, vids, pool.block_ver.reshape(-1))
        live = ((vids >= 0) & ~stale).cpu().numpy()
        tier = pool.blocks_exact if pool.blocks_exact is not None else pool.blocks
        vecs = tier.float().reshape(-1, pool.dim).cpu().numpy()[live]
        vids_live = vids.cpu().numpy()[live]
        _, first = np.unique(vids_live, return_index=True)
        out_v.append(vecs[first])
        out_h.append(s * st.cfg.num_vectors_cap + vids_live[first].astype(np.int64))
    return np.concatenate(out_v), np.concatenate(out_h)


def reshard(cfg: LireConfig, states: list[IndexState], new_shards: int, *, seed: int = 0,
            device=None) -> tuple[list[IndexState], np.ndarray]:
    """Elastic scaling: rebuild the partition over ``new_shards`` shards
    from the live contents of ``states``."""
    vecs, _ = gather_live_vectors(states)
    return build_sharded_state(cfg, vecs, new_shards, seed=seed,
                               device=device or states[0].device)


# ---------------------------------------------------------------------------
# ShardedIndex — the stateful backend the serving engine drives
# ---------------------------------------------------------------------------

class ShardedIndex(DurableBackend):
    """The per-shard states and the sharded steps behind the serving
    engine's backend protocol (``serve.engine.IndexBackend``).

    The engine feeds it the padded micro-batches it feeds a single-device
    index; every update writes the shards' pools in place.  Search,
    insert and delete use global ``(shard, slot)`` handles (the caller's
    insert vids are ignored); ``shard_alive`` degrades dead shards.  It
    keeps no access telemetry (the reference's sharded search ignores
    ``valid``), so its ``maintain`` record is ``{"jobs"}`` alone and either
    package replays the other's sharded WAL.  ``repro_torch.api.open``
    builds or restores it and attaches the per-shard WAL.
    """

    def __init__(self, cfg: LireConfig, states: list[IndexState], *, probe_chunk: int = 0,
                 use_pallas_scan: bool | None = None, scan_schedule: str | None = None,
                 jobs_per_round: int | None = None):
        self.cfg = cfg
        self.states = list(states)
        self.n_shards = len(self.states)
        self.device = self.states[0].device
        self.probe_chunk = probe_chunk
        self.use_pallas_scan = use_pallas_scan
        self.scan_schedule = scan_schedule
        self.jobs_per_round = jobs_per_round or cfg.jobs_per_round
        self.shard_alive = torch.ones((self.n_shards,), dtype=torch.bool, device=self.device)
        self.restore_seconds: dict | None = None

    @classmethod
    def build(cls, cfg: LireConfig, vectors: np.ndarray, n_shards: int, *, seed: int = 0,
              device="cuda", **kwargs) -> tuple["ShardedIndex", np.ndarray]:
        """Offline sharded build on ``device``; returns ``(index, handles
        of the inputs)``."""
        states, handles = build_sharded_state(cfg, vectors, n_shards, seed=seed, device=device)
        return cls(cfg, states, **kwargs), handles

    def set_alive(self, alive) -> None:
        self.shard_alive = torch.as_tensor(np.asarray(alive, bool)).to(self.device)

    # ---------------- replication hooks (replica cloning) ---------------
    def fork_state(self) -> list[IndexState]:
        """A deep copy of every shard: the updates write the pools in
        place, so a replica sharing tensors would see the primary's next
        update."""
        return [clone_state(st) for st in self.states]

    def adopt_state(self, states: list[IndexState]) -> None:
        """Install (forked) per-shard states on this index's device."""
        self.states = [map_tensors(lambda t: t.to(self.device), st) for st in states]

    def clone(self, device=None) -> "ShardedIndex":
        """A read replica on ``device`` (default: this index's): the same
        config and scan flags, its own deep-copied shards."""
        twin = ShardedIndex(self.cfg, self.fork_state(), probe_chunk=self.probe_chunk,
                            use_pallas_scan=self.use_pallas_scan,
                            scan_schedule=self.scan_schedule, jobs_per_round=self.jobs_per_round)
        if device is not None:
            twin.device = resolve_device(device)
            twin.adopt_state(twin.states)
            twin.shard_alive = twin.shard_alive.to(twin.device)
        twin._wal_applied = self._wal_applied
        return twin

    # --------------------------- backend ops ---------------------------
    def search(self, queries, k: int, nprobe: int | None = None, valid=None):
        return self.search_begin(queries, k, nprobe, valid)()

    def search_begin(self, queries, k: int, nprobe: int | None = None, valid=None):
        """Queue every shard's search and the merge, and the copy of the
        merged results to pinned memory behind an event; return a zero-arg
        ``finalize`` that waits on the event.  Nothing between the shards
        waits on the card.  ``valid`` is unused (no access telemetry)."""
        q = upload(np.asarray(queries, np.float32), self.device, torch.float32)
        out = sharded_search(
            self.states, q, self.shard_alive, k=k, nprobe=nprobe,
            probe_chunk=self.probe_chunk, use_pallas_scan=self.use_pallas_scan,
            scan_schedule=self.scan_schedule,
        )
        host, done = _read_back_later(out)

        def finalize():
            if done is not None:
                done.synchronize()
            return host[0].numpy(), host[1].numpy()
        return finalize

    def insert(self, vecs, vids, valid):
        """Caller vids are ignored: the index assigns ``(shard, slot)``
        handles.  Returns ``(handles, landed)``."""
        vecs = np.asarray(vecs, np.float32)
        valid = np.asarray(valid, bool)
        self._log("insert", {"vecs": vecs, "valid": valid})
        self.states, handles = sharded_insert(
            self.states, upload(vecs, self.device, torch.float32),
            upload(valid, self.device, torch.bool), inplace=True,
        )
        handles = handles.cpu().numpy()
        return handles, handles >= 0

    def delete(self, vids, valid) -> None:
        handles = np.where(np.asarray(valid), np.asarray(vids), -1).astype(np.int32)
        self._log("delete", {"handles": handles})
        self.states = sharded_delete(self.states, upload(handles, self.device, torch.int32))

    def log_update(self, op: str, payload: dict) -> None:
        """No request-level log: every update DISPATCH is logged by the
        backend itself (``_log``), and replaying that stream reproduces
        the handles, which the steps assign."""

    def maintain(self, jobs: int) -> int:
        """One round of ``jobs`` split and merge jobs on every shard; one
        scalar read back.  Returns the largest job count over the shards."""
        self._log("maintain", {"jobs": np.asarray(jobs, np.int32)})
        self.states, did = sharded_maintenance_round(self.states, jobs, inplace=True)
        return int(did)

    def drain(self) -> tuple[int, int]:
        """Rounds until one does nothing; returns ``(jobs_done, rounds)``."""
        total = rounds = 0
        jobs = self.jobs_per_round
        for _ in range(2 * self.cfg.num_postings_cap // jobs + 1):
            did = self.maintain(jobs)
            rounds += 1
            total += did
            if did == 0:
                break
        return total, rounds

    def backlog(self) -> int:
        over = [((st.pool.posting_len > self.cfg.split_limit) & st.centroid_valid).sum()
                for st in self.states]
        return int(torch.stack(over).sum())

    def stats(self) -> dict:
        out = {k: int(sum(int(getattr(st.stats, k)) for st in self.states)) for k in _STAT_KEYS}
        out["n_postings"] = int(sum(int(st.centroid_valid.sum()) for st in self.states))
        out["n_shards"] = self.n_shards
        out["used_blocks"] = int(sum(st.pool.num_blocks_cap - int(st.pool.free_top)
                                     for st in self.states))
        acc = upd = 0
        drift = 0.0
        for st in self.states:
            tel, valid = st.telemetry, st.centroid_valid
            acc += int(tel.access_count[valid].sum())
            upd += int(tel.update_count[valid].sum())
            drift += float(np.linalg.norm(tel.drift_vec[valid].cpu().numpy(), axis=-1).sum())
        out.update(access_total=acc, update_total=upd, drift_norm_total=drift)
        return out

    def state_bytes(self) -> list[int]:
        """Bytes of every shard's state on the device."""
        return [sum(t.numel() * t.element_size() for t in tensor_leaves(st).values())
                for st in self.states]

    # ---------------------- durability lifecycle -----------------------
    # One WAL per shard (every record in each), one atomic snapshot unit
    # of all shards in the reference's stacked layout, replay through the
    # same steps: handles land exactly as before the crash.

    @property
    def _wal_shards(self) -> int:
        return self.n_shards

    def _snapshot_state(self):
        return self.states

    def _set_snapshot_state(self, states) -> None:
        self.states = list(states)

    def _snapshot_extra(self) -> dict:
        return {"backend": "sharded", "n_shards": self.n_shards}

    def _lire_config(self):
        return self.cfg

    def _apply_record(self, rec) -> None:
        p = rec.payload
        if rec.op == "insert":
            self.insert(p["vecs"], np.full(len(p["vecs"]), -1, np.int32), p["valid"])
        elif rec.op == "delete":
            handles = np.asarray(p["handles"])
            self.delete(handles, handles >= 0)
        elif rec.op == "maintain":
            self.maintain(int(p["jobs"]))
        else:
            raise ValueError(f"unknown WAL op {rec.op!r}")

    @classmethod
    def restore(cls, cfg: LireConfig, snapshot_dir: str, n_shards: int, *, device="cuda",
                **kwargs) -> tuple["ShardedIndex", dict]:
        """Load a sharded snapshot chain (stacked base + per-shard deltas)
        on ``device``; returns ``(index, manifest)``.  Replaying the WAL
        tail on top is the caller's move (``repro_torch.api.open``).
        ``index.restore_seconds`` splits the load (host read of the chain)
        from the upload."""
        dev = resolve_device(device)
        store = SnapshotStore(snapshot_dir)
        stamped = store.read_manifest().get("extra", {}).get("n_shards", n_shards)
        if stamped != n_shards:
            raise ValueError(f"snapshot has {stamped} shards, want {n_shards}")
        template = make_empty_state(cfg, device="meta")
        t0 = time.perf_counter()
        leaves, manifest = store.load_arrays(stacked_template(template, n_shards))
        t1 = time.perf_counter()
        states = sharded_state_from_numpy(
            cfg, dict(zip(tensor_leaves(template), leaves)), n_shards, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        idx = cls(cfg, states, **kwargs)
        seqnos = manifest.get("extra", {}).get("wal_seqnos", [-1])
        idx._wal_applied = min(seqnos) if seqnos else -1
        idx.restore_seconds = {"load_s": t1 - t0, "upload_s": time.perf_counter() - t1,
                               "snapshot_bytes": sum(a.nbytes for a in leaves)}
        return idx, manifest
