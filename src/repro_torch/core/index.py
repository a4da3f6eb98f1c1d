"""SPFreshIndex — the user-facing index object.

Composition (paper Fig. 5):
  * offline build      — SPANN hierarchical balanced clustering + closure
                         replication (§3.1), vectorised on the device;
  * foreground Updater — ``insert`` / ``delete`` (``lire.insert_batch`` /
                         ``lire.delete_batch``), with backpressure: rows
                         whose primary append fails are retried after the
                         Local Rebuilder has drained;
  * background Local Rebuilder — ``maintain()`` drains split / merge /
                         reassign jobs in batched rounds
                         (``lire.maintenance_round``);
  * Searcher           — ``search`` (``lire.search``).

``SPFreshIndex`` owns its state: its updates write the block pool in
place (the reference donates the state to its jitted steps).  Crash
recovery (paper §4.4) in its single-log form: with a ``wal_path`` every
``insert`` / ``delete`` request is appended to a write-ahead log before it
runs, ``snapshot`` commits a full snapshot and truncates the log, and
``restore`` replays the log's tail on the snapshot.  The serving layer's
dispatch-level log (``storage.durability``) supersedes it under
``repro_torch.api.open``.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from repro_torch.core import lire
from repro_torch.core.clustering import hierarchical_balanced_kmeans
from repro_torch.core.distance import pairwise_sql2, stable_topk
from repro_torch.core.types import (
    IndexState,
    LireConfig,
    make_empty_state,
    resolve_device,
)
from repro_torch.storage import codec as pcodec
from repro_torch.storage.snapshot import load_snapshot, save_snapshot, snapshot_exists
from repro_torch.storage.wal import WriteAheadLog, iter_wal
from repro_torch.utils import trace

_INSERT_CHUNK = 256
_QUERY_CHUNK = 64


def _group_rank_np(keys: np.ndarray) -> np.ndarray:
    """Rank of each entry among equal keys, in input order."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.arange(keys.size)
    first = np.ones(keys.size, bool)
    first[1:] = sk[1:] != sk[:-1]
    start = np.maximum.accumulate(np.where(first, pos, 0))
    rank = np.empty(keys.size, np.int64)
    rank[order] = pos - start
    return rank


def _build_routing(vectors, centroids, assign, cfg: LireConfig, *, device,
                   chunk: int = 8192) -> tuple[np.ndarray, np.ndarray]:
    """Vector → posting membership: the primary (from the clustering) plus
    SPANN closure replicas (top-R centroids within the replica_rng ratio).

    Returns ``(pid, vid)`` membership pairs sorted in fill order: per
    posting, primaries in vid order, then replicas in (vid, j) order.  A
    replica candidate (vid, j) lands in posting p iff p is not the vid's
    primary, ``d_j <= replica_rng² · d_min``, and its rank among p's
    qualifying candidates in (vid, j) order is below ``cap − primaries(p)``
    — the outcome of the reference's sequential loop."""
    n = vectors.shape[0]
    p = centroids.shape[0]
    assign = np.asarray(assign, np.int64)
    pid_parts = [assign]
    vid_parts = [np.arange(n, dtype=np.int64)]
    grp_parts = [np.zeros(n, np.int64)]
    if cfg.replica_count > 1 and p > 1:
        r = min(cfg.replica_count, p)
        cen = torch.as_tensor(np.asarray(centroids, np.float32)).to(device)
        cen_sqn = torch.sum(cen * cen, dim=-1)
        factor = float(cfg.replica_rng) ** 2
        idx_parts, ok_parts = [], []
        for start in range(0, n, chunk):
            xs = torch.as_tensor(np.asarray(vectors[start:start + chunk], np.float32)).to(device)
            d, idx = stable_topk(pairwise_sql2(xs, cen, cen_sqn), r)
            prim = torch.as_tensor(assign[start:start + chunk]).to(device)
            ok = (idx != prim[:, None]) & (d <= factor * d[:, :1])
            idx_parts.append(idx.cpu().numpy())
            ok_parts.append(ok.cpu().numpy())
        idx = np.concatenate(idx_parts).reshape(-1)
        ok = np.concatenate(ok_parts).reshape(-1)
        cand_pid = idx[ok]
        cand_vid = np.repeat(np.arange(n, dtype=np.int64), r)[ok]
        n_prim = np.bincount(assign, minlength=p)
        room = np.maximum(cfg.posting_capacity - n_prim, 0)
        lands = _group_rank_np(cand_pid) < room[cand_pid]
        pid_parts.append(cand_pid[lands])
        vid_parts.append(cand_vid[lands])
        grp_parts.append(np.ones(int(lands.sum()), np.int64))
    pid = np.concatenate(pid_parts)
    vid = np.concatenate(vid_parts)
    grp = np.concatenate(grp_parts)
    order = np.lexsort((grp, pid))        # stable: in-group order kept
    return pid[order], vid[order]


def _state_from_clustering(cfg: LireConfig, vectors, centroids, assign, *,
                           seed: int = 0, device="cuda") -> IndexState:
    """Routing + fill: the deterministic part of the build, given a
    clustering ``(centroids (P, d), assign (n,))``.

    Each posting keeps its first ``cap`` members; blocks are handed out
    in pid order, ``ceil(len/BS)`` per posting.  Every posting's
    ``(scale, zero)`` is trained from its members (all codecs, as the
    reference does)."""
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    centroids = np.asarray(centroids, np.float32)
    d = vectors.shape[1]
    p = centroids.shape[0]
    if p > cfg.num_postings_cap:
        raise ValueError(
            f"build produced {p} postings > cap {cfg.num_postings_cap}; "
            "raise num_postings_cap or split_limit"
        )
    bs, mb = cfg.block_size, cfg.max_blocks_per_posting
    cap = cfg.posting_capacity
    mem_pid, mem_vid = _build_routing(vectors, centroids, assign, cfg, device=dev)
    rank = _group_rank_np(mem_pid)
    keep = rank < cap
    mem_pid, mem_vid, rank = mem_pid[keep], mem_vid[keep], rank[keep]

    lens = np.bincount(mem_pid, minlength=p)[:p]
    nb = (lens + bs - 1) // bs
    blk_start = np.cumsum(nb) - nb
    n_used = int(nb.sum())
    if n_used > cfg.num_blocks:
        raise ValueError("num_blocks too small for the build")
    bid = blk_start[mem_pid] + rank // bs
    slot = rank % bs

    # per-posting (scale, zero) from the members' value range, in float64
    # then f32: the arithmetic of codec.np_train_scale_zero, vectorised
    post_scale = np.ones((cfg.num_postings_cap,), np.float32)
    post_zero = np.zeros((cfg.num_postings_cap,), np.float32)
    nz = lens > 0
    if nz.any():
        rows = vectors[mem_vid]
        seg = np.cumsum(lens) - lens
        hi = np.maximum.reduceat(rows.max(axis=1), seg[nz]).astype(np.float64)
        lo = np.minimum.reduceat(rows.min(axis=1), seg[nz]).astype(np.float64)
        zero = (hi + lo) * 0.5
        rng = hi - lo
        scale = np.where(rng > 0, rng / 254.0, 1.0)
        post_scale[np.flatnonzero(nz)] = scale.astype(np.float32)
        post_zero[np.flatnonzero(nz)] = zero.astype(np.float32)

    state = make_empty_state(cfg, seed=seed, device=dev)
    pool = state.pool
    t_bid = torch.as_tensor(bid).to(dev)
    t_slot = torch.as_tensor(slot).to(dev)
    raw = torch.as_tensor(vectors).to(dev)[torch.as_tensor(mem_vid).to(dev)]
    if cfg.codec == "int8":
        ps = torch.as_tensor(post_scale).to(dev)[torch.as_tensor(mem_pid).to(dev)][:, None]
        pz = torch.as_tensor(post_zero).to(dev)[torch.as_tensor(mem_pid).to(dev)][:, None]
        payload = pcodec.encode(raw, ps, pz)
    else:
        payload = raw.to(pool.blocks.dtype)
    blocks = pool.blocks.clone()
    blocks[t_bid, t_slot] = payload
    blocks_exact = pool.blocks_exact
    if blocks_exact is not None:
        blocks_exact = blocks_exact.clone()
        blocks_exact[t_bid, t_slot] = raw
    block_vid = pool.block_vid.clone()
    block_vid[t_bid, t_slot] = torch.as_tensor(mem_vid).to(dev).to(torch.int32)

    posting_blocks = np.full((cfg.num_postings_cap, mb), -1, np.int32)
    b_idx = np.arange(mb)[None, :]
    posting_blocks[:p] = np.where(b_idx < nb[:, None], blk_start[:, None] + b_idx, -1)
    posting_len = np.zeros((cfg.num_postings_cap,), np.int32)
    posting_len[:p] = lens
    free_stack = np.zeros((cfg.num_blocks,), np.int32)
    free_stack[: cfg.num_blocks - n_used] = np.arange(n_used, cfg.num_blocks)
    pid_stack = np.zeros((cfg.num_postings_cap,), np.int32)
    pid_stack[: cfg.num_postings_cap - p] = np.arange(p, cfg.num_postings_cap)
    cen = np.zeros((cfg.num_postings_cap, d), np.float32)
    cen[:p] = centroids
    cvalid = np.zeros((cfg.num_postings_cap,), bool)
    cvalid[:p] = True

    def t(a):
        return torch.as_tensor(a).to(dev)

    pool = pool.replace(
        blocks=blocks,
        blocks_exact=blocks_exact,
        block_vid=block_vid,
        posting_blocks=t(posting_blocks),
        posting_len=t(posting_len),
        free_stack=t(free_stack),
        free_top=torch.tensor(cfg.num_blocks - n_used, dtype=torch.int32, device=dev),
        post_scale=t(post_scale),
        post_zero=t(post_zero),
    )
    return state.replace(
        pool=pool,
        centroids=t(cen),
        centroid_sqn=t(np.sum(cen * cen, axis=-1)),
        centroid_valid=t(cvalid),
        pid_free_stack=t(pid_stack),
        pid_free_top=torch.tensor(cfg.num_postings_cap - p, dtype=torch.int32, device=dev),
    )


def build_state(cfg: LireConfig, vectors, *, seed: int = 0,
                build_posting_size: int | None = None, device="cuda") -> IndexState:
    """Offline SPANN-style build → a ready IndexState on ``device``."""
    cfg.validate()
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    n, d = vectors.shape
    if d != cfg.dim:
        raise ValueError(f"vectors have d={d}, config dim={cfg.dim}")
    if n > cfg.num_vectors_cap:
        raise ValueError(f"{n} vectors > num_vectors_cap {cfg.num_vectors_cap}")
    target = build_posting_size or max(cfg.merge_limit + 1, int(cfg.split_limit * 0.6))
    centroids, assign = hierarchical_balanced_kmeans(
        vectors, max_posting_size=target, seed=seed, device=dev
    )
    return _state_from_clustering(cfg, vectors, centroids, assign, seed=seed, device=dev)


# ---------------------------------------------------------------------------
# Step functions (the serving pipeline's fixed-shape entry points)
# ---------------------------------------------------------------------------

def search_step(k: int, nprobe: int | None, probe_chunk: int = 0,
                use_pallas_scan: bool | None = None,
                scan_schedule: str | None = None, with_access: bool = False):
    """``(state, queries (B, d)) -> (dists (B, k), vids (B, k)[, hist])``."""
    return functools.partial(
        lire.search, k=k, nprobe=nprobe, probe_chunk=probe_chunk,
        use_pallas_scan=use_pallas_scan, scan_schedule=scan_schedule,
        with_access=with_access,
    )


def insert_step():
    """``(state, vecs, vids, valid) -> (state, landed)``."""
    return lire.insert_batch


def delete_step():
    """``(state, vids, valid) -> state``."""
    return lire.delete_batch


def fused_maintenance_step(budget: int):
    """``(state, *, inplace=False) -> (state, n_did_work)``: ``budget``
    sequential one-job ``maintenance_step``s, the baseline the batched
    round is measured against."""

    def step(state, *, inplace: bool = False):
        total = torch.zeros((), dtype=torch.int32, device=state.device)
        for _ in range(budget):
            state, did = lire.maintenance_step(state, inplace=inplace)
            total = total + did.to(torch.int32)
        return state, total

    return step


def fused_maintenance_round(jobs: int):
    """``(state, access, *, inplace=False) -> (state, n_jobs_done)``: one
    batched round of ``jobs`` split and ``jobs`` merge jobs with one fused
    reassignment pass; ``access`` is the ``(P_cap,)`` probe histogram
    folded into the telemetry before selection (zeros: a no-op)."""

    def step(state, access, *, inplace: bool = False):
        return lire.maintenance_round(state, jobs, access, inplace=inplace)

    return step


def check_vids(vids: np.ndarray, cfg: LireConfig) -> None:
    """Refuse caller vids outside ``[0, num_vectors_cap)`` before they are
    logged or dispatched.  (The reference's version-map reads clamp such a
    vid onto the scratch slot and its writes drop it; here the gather
    would raise inside a dispatch, after the WAL append.)"""
    bad = (vids < 0) | (vids >= cfg.num_vectors_cap)
    if bad.any():
        raise ValueError(f"vids outside [0, num_vectors_cap={cfg.num_vectors_cap}): "
                         f"{np.unique(vids[bad])[:8].tolist()}")


def upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array ``x`` on ``device``.  It goes to the card through pinned
    memory without blocking the host, ordered on the current stream (a
    pageable copy would wait for the stream)."""
    t = torch.as_tensor(np.asarray(x)).to(dtype=dtype)
    if device.type != "cuda":
        return t
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def _pad_to(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    pad = size - x.shape[0]
    if pad <= 0:
        return x
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width, constant_values=fill)


class SPFreshIndex:
    """Stateful host wrapper over the LIRE ops.  It owns ``state``: the
    updates and the rebuilder write its block pool in place, so a caller
    keeps no other reference to the state it hands in."""

    def __init__(self, state: IndexState, wal_path: str | None = None):
        self.state = state
        self.wal = WriteAheadLog(wal_path) if wal_path else None
        self._wal_applied = self.wal.next_seqno - 1 if self.wal else -1
        self.last_drain_rounds = 0
        # rows re-sent after a backpressure drain (``n_inserts`` counts
        # each send, as the reference's does)
        self.retried_rows = 0

    @classmethod
    def build(cls, cfg: LireConfig, vectors, *, seed: int = 0,
              wal_path: str | None = None, device="cuda") -> "SPFreshIndex":
        return cls(build_state(cfg, vectors, seed=seed, device=device), wal_path=wal_path)

    def _t(self, x, dtype=None) -> torch.Tensor:
        return upload(x, self.state.device, dtype)

    # ---------------------------- Updater -----------------------------
    def insert(self, vecs, vids, *, log: bool = True, max_retries: int = 4) -> None:
        """Insert in ``_INSERT_CHUNK``-row batches, with backpressure: when
        a primary append hits a full posting, drain the Local Rebuilder
        (which splits it) and retry the rows that did not land, up to
        ``max_retries`` times.  With a WAL (and ``log``) the request is
        appended first."""
        vecs = np.asarray(vecs, np.float32)
        vids = np.asarray(vids, np.int32)
        check_vids(vids, self.state.cfg)
        if log and self.wal is not None:
            self._wal_applied = self.wal.append("insert", {"vecs": vecs, "vids": vids})
        for s in range(0, len(vids), _INSERT_CHUNK):
            v = vecs[s:s + _INSERT_CHUNK]
            i = vids[s:s + _INSERT_CHUNK]
            for attempt in range(max_retries + 1):
                nvalid = len(i)
                if nvalid == 0:
                    break
                valid = np.arange(_INSERT_CHUNK) < nvalid
                landed = self.insert_padded(
                    _pad_to(v, _INSERT_CHUNK), _pad_to(i, _INSERT_CHUNK, fill=-1), valid
                )[:nvalid]
                if landed.all() or attempt == max_retries:
                    break
                self.maintain()
                v, i = v[~landed], i[~landed]
                self.retried_rows += len(i)

    def delete(self, vids, *, log: bool = True) -> None:
        vids = np.asarray(vids, np.int32)
        check_vids(vids, self.state.cfg)
        if log and self.wal is not None:
            self._wal_applied = self.wal.append("delete", {"vids": vids})
        for s in range(0, len(vids), _INSERT_CHUNK):
            i = vids[s:s + _INSERT_CHUNK]
            valid = np.arange(_INSERT_CHUNK) < len(i)
            self.delete_padded(_pad_to(i, _INSERT_CHUNK, fill=-1), valid)

    # ------------------------- Local Rebuilder -------------------------
    def maintain(self, max_steps: int | None = None, jobs_per_round: int | None = None,
                 access=None) -> int:
        """Drain split / merge / reassign jobs in batched rounds (one
        did-work readback per round); returns the jobs run.  The round
        count is kept in ``last_drain_rounds``; ``access`` (a probe
        histogram) folds into the first round's selection."""
        acc = None if access is None else self._t(access, torch.int32)
        self.state, jobs, rounds = lire.rebuild_drain(
            self.state, max_steps, jobs_per_round, donate=True, access=acc
        )
        self.last_drain_rounds = rounds
        return jobs

    def maintain_round(self, jobs: int | None = None, access=None) -> int:
        """One batched rebuilder round; returns how many jobs acted."""
        jobs = jobs or self.state.cfg.jobs_per_round
        if access is None:
            access = np.zeros((self.state.cfg.num_postings_cap,), np.int32)
        with trace.span("round"):
            self.state, did = fused_maintenance_round(jobs)(
                self.state, self._t(access, torch.int32), inplace=True
            )
            with trace.span("round.readback"):
                return int(did)

    # the reference's earlier name for the one-dispatch maintenance slot
    maintain_fused = maintain_round

    def maintain_fused_seq(self, budget: int) -> int:
        """``budget`` sequential one-job steps (the round's baseline)."""
        self.state, did = fused_maintenance_step(budget)(self.state, inplace=True)
        return int(did)

    # ---------------------------- Searcher -----------------------------
    def search(self, queries, k: int, *, nprobe=None, probe_chunk: int = 0,
               use_pallas_scan=None, scan_schedule=None):
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        out_d, out_v = [], []
        for s in range(0, nq, _QUERY_CHUNK):
            q = _pad_to(queries[s:s + _QUERY_CHUNK], _QUERY_CHUNK)
            d, v = self.search_padded(
                q, k, nprobe=nprobe or self.state.cfg.nprobe,
                probe_chunk=probe_chunk, use_pallas_scan=use_pallas_scan,
                scan_schedule=scan_schedule,
            )
            out_d.append(d)
            out_v.append(v)
        return np.concatenate(out_d)[:nq], np.concatenate(out_v)[:nq]

    def search_padded(self, queries, k: int, *, nprobe=None, probe_chunk: int = 0,
                      use_pallas_scan=None, scan_schedule=None,
                      with_access: bool = False, qvalid=None, as_tensor: bool = False):
        """One fixed-shape search dispatch; numpy results.  ``as_tensor=True``
        returns the device tensors without a readback: on the card the
        dispatch is then queued on the current stream and nothing has
        waited for it, so the caller overlaps it with other host work and
        reads it back later (the serving engine's deferred readback)."""
        step = search_step(k, nprobe, probe_chunk, use_pallas_scan,
                           scan_schedule, with_access)
        with trace.span("search.upload"):
            q = self._t(queries, torch.float32)
            kw = {} if qvalid is None else {"qvalid": self._t(qvalid, torch.bool)}
        out = step(self.state, q, **kw)
        if as_tensor:
            return tuple(out)
        return tuple(x.cpu().numpy() for x in out)

    def insert_padded(self, vecs, vids, valid) -> np.ndarray:
        """One insert dispatch (the pool written in place); returns the
        landed mask."""
        with trace.span("insert"):
            self.state, landed = insert_step()(
                self.state, self._t(vecs, torch.float32), self._t(vids, torch.int32),
                self._t(valid, torch.bool), inplace=True,
            )
            with trace.span("insert.readback"):
                return landed.cpu().numpy()

    def delete_padded(self, vids, valid) -> None:
        with trace.span("delete"):
            self.state = delete_step()(
                self.state, self._t(vids, torch.int32), self._t(valid, torch.bool)
            )

    # ------------------------- Crash recovery --------------------------
    def snapshot(self, path: str) -> None:
        """A full snapshot stamped with the applied WAL seqno; the WAL
        restarts empty after it commits."""
        save_snapshot(path, self.state, extra={"wal_seqno": self._wal_applied})
        if self.wal is not None:
            self.wal.truncate()

    @classmethod
    def restore(cls, path: str, cfg: LireConfig, *, wal_path: str | None = None,
                device="cuda") -> "SPFreshIndex":
        """Latest snapshot + WAL replay (paper §4.4).  The state is filled
        on ``device`` straight from the snapshot's arrays; with no snapshot
        the WAL replays over an empty state."""
        dev = resolve_device(device)
        if snapshot_exists(path):
            state, manifest = load_snapshot(path, make_empty_state(cfg, device="meta"),
                                            device=dev)
            after = manifest["extra"].get("wal_seqno", -1)
        else:
            state, after = make_empty_state(cfg, device=dev), -1
        idx = cls(state)
        idx._wal_applied = after
        if wal_path and os.path.exists(wal_path):
            for rec in iter_wal(wal_path, after_seqno=after):
                if rec.op == "insert":
                    idx.insert(rec.payload["vecs"], rec.payload["vids"], log=False)
                elif rec.op == "delete":
                    idx.delete(rec.payload["vids"], log=False)
                idx._wal_applied = rec.seqno
        if wal_path:
            idx.wal = WriteAheadLog(wal_path)
        return idx

    # ---------------------------- Accounting ---------------------------
    def backlog(self) -> int:
        """Rebuild backlog: postings currently over the split limit."""
        lens = self.state.pool.posting_len
        return int(((lens > self.state.cfg.split_limit) & self.state.centroid_valid).sum())

    def stats(self) -> dict:
        s = self.state.stats
        out = {f.name: int(getattr(s, f.name)) for f in s.__dataclass_fields__.values()}
        out["n_postings"] = int(self.state.n_postings)
        out["used_blocks"] = int(self.state.pool.num_blocks_cap - self.state.pool.free_top)
        tel = self.state.telemetry
        valid = self.state.centroid_valid
        out["access_total"] = int(tel.access_count[valid].sum())
        out["update_total"] = int(tel.update_count[valid].sum())
        out["drift_norm_total"] = float(
            np.linalg.norm(tel.drift_vec[valid].cpu().numpy(), axis=-1).sum()
        )
        return out

    def memory_bytes(self) -> dict:
        """Resource accounting analogous to paper Fig. 7(d)."""
        st = self.state

        def nbytes(t):
            return t.numel() * t.element_size() if t is not None else 0

        in_mem = sum(nbytes(t) for t in (
            st.centroids, st.centroid_sqn, st.centroid_valid, st.versions,
            st.pool.posting_blocks, st.pool.posting_len, st.pool.free_stack,
            st.pid_free_stack,
        ))
        hot = nbytes(st.pool.blocks) + nbytes(st.pool.post_scale) + nbytes(st.pool.post_zero)
        cold = nbytes(st.pool.blocks_exact)
        on_disk = hot + cold + nbytes(st.pool.block_vid) + nbytes(st.pool.block_ver)
        return {"memory": in_mem, "disk": on_disk, "hot": hot, "cold": cold}
