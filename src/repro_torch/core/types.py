"""Index state and protocol configuration for SPFresh/LIRE.

``IndexState`` is a frozen dataclass of tensors whose static geometry
(capacities, protocol thresholds) lives in a hashable ``LireConfig``.  A
LIRE operation is ``state' = op(state, ...)``; the input state's tensors
are never written, so an old state stays valid (replay, comparisons).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.storage.blockpool import BlockPool, make_block_pool
from repro_torch.utils.scatter import masked_set_
from repro_torch.utils.tree import state_dataclass


@dataclasses.dataclass(frozen=True)
class LireConfig:
    """Static protocol + geometry parameters (hashable).  Same fields and
    defaults as the reference's ``LireConfig``, so configs carry across."""

    dim: int = 128
    # --- storage geometry ---
    block_size: int = 16            # vectors per block ("SSD block")
    max_blocks_per_posting: int = 8  # MB; posting capacity = BS*MB
    num_blocks: int = 4096           # B_cap
    num_postings_cap: int = 512      # P_cap
    num_vectors_cap: int = 65536     # N_cap (version map size)
    vector_dtype: str = "float32"    # storage dtype for posting payloads
    scan_dtype: str = "float32"      # oracle-scan compute dtype (f32 accum)
    # --- tiered posting codec (storage/codec.py) ---
    codec: str = "fp32"
    # Quantized scans over-fetch rerank_factor×k candidates, then rerank
    # against the exact tier (1 = no rerank).
    rerank_factor: int = 1
    # --- LIRE protocol ---
    split_limit: int = 96            # split when live length exceeds this
    merge_limit: int = 12            # merge when 0 < live length below this
    merge_fanout: int = 4            # nearest postings tried as merge absorbers
    reassign_range: int = 8          # nearby postings scanned after a split
    reassign_budget: int = 256       # max vectors actually reassigned per pass
    replica_count: int = 4           # max closure replicas per vector
    replica_rng: float = 1.15        # replicate while d <= rng^2 * d_min
    # --- maintenance batching (the Local Rebuilder round) ---
    jobs_per_round: int = 4
    # --- maintenance job selection ("size" | "drift") ---
    maintain_policy: str = "size"
    maintain_alpha: float = 1.0
    maintain_beta: float = 1.0
    # --- search ---
    nprobe: int = 8                  # postings probed per query
    # --- split clustering ---
    kmeans_iters: int = 8
    # --- protocol ablations ---
    enable_split: bool = True
    enable_merge: bool = True
    enable_reassign: bool = True
    # --- kernel data paths ---
    # True: centroid navigation through the hand-written l2_topk kernel
    # instead of the matmul + stable top-k oracle.
    use_pallas_nav: bool = False
    # True: the paged posting scan through the hand-written posting_scan
    # kernels (per-page k-min candidates) instead of the gather oracle.
    use_pallas_scan: bool = False
    # "per_query" (paper ParallelGET) | "batched" (batch page dedup).
    scan_schedule: str = "per_query"
    # Static page budget of the batched schedule (0 = lossless auto).
    scan_page_budget: int = 0
    # Kept for config compatibility with the reference; no effect here
    # (the port's kernels have no interpret mode).
    pallas_interpret: bool = True

    @property
    def posting_capacity(self) -> int:
        return self.block_size * self.max_blocks_per_posting

    def validate(self) -> None:
        checks = [
            (self.split_limit <= self.posting_capacity,
             "split_limit must fit in a posting"),
            (self.merge_limit < self.split_limit, "merge_limit < split_limit"),
            (self.merge_fanout >= 1, "merge_fanout >= 1"),
            (self.jobs_per_round >= 1, "jobs_per_round >= 1"),
            (2 * self.jobs_per_round <= self.num_postings_cap,
             "a round allocates up to 2 pids per split job"),
            (self.replica_count >= 1, "replica_count >= 1"),
            (self.nprobe >= 1, "nprobe >= 1"),
            (self.maintain_policy in ("size", "drift"), self.maintain_policy),
            (self.maintain_alpha >= 0.0, "maintain_alpha >= 0"),
            (self.maintain_beta >= 0.0, "maintain_beta >= 0"),
            (self.scan_schedule in ("per_query", "batched"), self.scan_schedule),
            (self.scan_page_budget >= 0, "scan_page_budget >= 0"),
            (self.codec in ("fp32", "bf16", "int8"), self.codec),
            (self.rerank_factor >= 1, "rerank_factor >= 1"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid LireConfig: {what}")


_STAT_NAMES = (
    "n_inserts", "n_deletes", "n_appends", "n_append_drops", "n_splits",
    "n_gc_writebacks", "n_merges", "n_reassign_checked",
    "n_reassign_candidates", "n_reassigned", "n_reassign_overflow",
)


@state_dataclass
class LireStats:
    """Cumulative protocol counters (paper §5.2), () i32 each."""

    n_inserts: torch.Tensor
    n_deletes: torch.Tensor
    n_appends: torch.Tensor
    n_append_drops: torch.Tensor
    n_splits: torch.Tensor
    n_gc_writebacks: torch.Tensor
    n_merges: torch.Tensor
    n_reassign_checked: torch.Tensor
    n_reassign_candidates: torch.Tensor
    n_reassigned: torch.Tensor
    n_reassign_overflow: torch.Tensor

    @staticmethod
    def zeros(device) -> "LireStats":
        return LireStats(*(
            torch.zeros((), dtype=torch.int32, device=device) for _ in _STAT_NAMES
        ))


@state_dataclass
class LireTelemetry:
    """Per-posting maintenance telemetry (Ada-IVF cost-model inputs)."""

    access_count: torch.Tensor  # (P_cap,) i32
    update_count: torch.Tensor  # (P_cap,) i32
    drift_vec: torch.Tensor     # (P_cap, d) f32

    @staticmethod
    def zeros(cfg: LireConfig, device) -> "LireTelemetry":
        p = cfg.num_postings_cap
        return LireTelemetry(
            access_count=torch.zeros((p,), dtype=torch.int32, device=device),
            update_count=torch.zeros((p,), dtype=torch.int32, device=device),
            drift_vec=torch.zeros((p, cfg.dim), dtype=torch.float32, device=device),
        )


@state_dataclass
class IndexState:
    cfg: LireConfig
    pool: BlockPool
    centroids: torch.Tensor       # (P_cap, d) f32
    centroid_sqn: torch.Tensor    # (P_cap,) f32 cached ||c||^2
    centroid_valid: torch.Tensor  # (P_cap,) bool
    versions: torch.Tensor        # (N_cap + 1,) u8 — last slot is scratch
    pid_free_stack: torch.Tensor  # (P_cap,) i32
    pid_free_top: torch.Tensor    # () i32
    rng: torch.Tensor             # (2,) u32 — the reference's raw PRNG key
    step: torch.Tensor            # () i32 op counter
    next_vid: torch.Tensor        # () i32 local slot allocator
    stats: LireStats
    telemetry: LireTelemetry

    @property
    def n_postings(self) -> torch.Tensor:
        return self.centroid_valid.sum().to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.centroids.device


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; a missing card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def prng_key(seed: int) -> torch.Tensor:
    """The reference's ``PRNGKey(seed)`` bits: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    s = int(seed)
    return torch.from_numpy(
        np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)
    )


def make_empty_state(cfg: LireConfig, seed: int = 0, *, device="cuda") -> IndexState:
    cfg.validate()
    dev = resolve_device(device)
    pool = make_block_pool(
        num_blocks=cfg.num_blocks,
        block_size=cfg.block_size,
        dim=cfg.dim,
        num_postings_cap=cfg.num_postings_cap,
        max_blocks_per_posting=cfg.max_blocks_per_posting,
        dtype=cfg.vector_dtype,
        codec=cfg.codec,
        device=dev,
    )
    p = cfg.num_postings_cap
    i32 = dict(dtype=torch.int32, device=dev)
    return IndexState(
        cfg=cfg,
        pool=pool,
        centroids=torch.zeros((p, cfg.dim), dtype=torch.float32, device=dev),
        centroid_sqn=torch.zeros((p,), dtype=torch.float32, device=dev),
        centroid_valid=torch.zeros((p,), dtype=torch.bool, device=dev),
        versions=torch.zeros((cfg.num_vectors_cap + 1,), dtype=torch.uint8, device=dev),
        pid_free_stack=torch.arange(p, **i32),
        pid_free_top=torch.tensor(p, **i32),
        rng=prng_key(seed).to(dev),
        step=torch.tensor(0, **i32),
        next_vid=torch.tensor(0, **i32),
        stats=LireStats.zeros(dev),
        telemetry=LireTelemetry.zeros(cfg, dev),
    )


def alloc_pids(state: IndexState, enable: torch.Tensor):
    """Batched pid alloc: the row with the i-th True pops ``stack[top-i]``
    (LIFO order); rows past exhaustion get ``-1``.  Returns ``(state, pids)``."""
    cnt = torch.cumsum(enable.long(), 0)
    pos = state.pid_free_top.long() - cnt
    ok = enable & (pos >= 0)
    p_cap = state.pid_free_stack.shape[0]
    # rows before the first enabled one read pos = top, which is P_cap
    # when every pid is free: clamp (their result is masked out)
    pids = torch.where(ok, state.pid_free_stack[torch.clamp(pos, 0, p_cap - 1)], -1)
    return (
        state.replace(pid_free_top=state.pid_free_top - ok.sum().to(torch.int32)),
        pids.to(torch.int32),
    )


def free_pids(state: IndexState, pids: torch.Tensor, enable: torch.Tensor) -> IndexState:
    """Batched free: push ``k`` distinct ids back and invalidate their
    centroids; freed pids come back with zero telemetry."""
    do = enable & (pids >= 0)
    p_cap = state.pid_free_stack.shape[0]
    pos = state.pid_free_top.long() + torch.cumsum(do.long(), 0) - 1
    tgt = torch.clamp(pids.long(), min=0)
    tel = state.telemetry
    return state.replace(
        pid_free_stack=masked_set_(state.pid_free_stack.clone(),
                                   torch.clamp(pos, 0, p_cap - 1), pids, do),
        pid_free_top=state.pid_free_top + do.sum().to(torch.int32),
        centroid_valid=masked_set_(state.centroid_valid.clone(), tgt, False, do),
        telemetry=tel.replace(
            access_count=masked_set_(tel.access_count.clone(), tgt, 0, do),
            update_count=masked_set_(tel.update_count.clone(), tgt, 0, do),
            drift_vec=masked_set_(tel.drift_vec.clone(), tgt, 0.0, do),
        ),
    )


def set_centroids(state: IndexState, pids, centroids, enable) -> IndexState:
    """Batched centroid writes for ``k`` distinct pids; disabled rows drop."""
    do = enable & (pids >= 0)
    tgt = torch.clamp(pids.long(), min=0)
    c = centroids.float()
    return state.replace(
        centroids=masked_set_(state.centroids.clone(), tgt, c, do),
        centroid_sqn=masked_set_(state.centroid_sqn.clone(), tgt,
                                 torch.sum(c * c, dim=-1), do),
        centroid_valid=masked_set_(state.centroid_valid.clone(), tgt, True, do),
    )


def _one(x, state: IndexState) -> torch.Tensor:
    return torch.as_tensor(x, device=state.device).reshape(1)


def alloc_pid(state: IndexState, enable):
    """Pop one posting id (``-1`` on exhaustion or when not enabled)."""
    state, pids = alloc_pids(state, _one(enable, state))
    return state, pids[0]


def free_pid(state: IndexState, pid, enable) -> IndexState:
    """Push one posting id back (see :func:`free_pids`)."""
    return free_pids(state, _one(pid, state), _one(enable, state))


def set_centroid(state: IndexState, pid, centroid, enable) -> IndexState:
    """Write one centroid (see :func:`set_centroids`)."""
    return set_centroids(state, _one(pid, state), centroid.reshape(1, -1),
                         _one(enable, state))


def bump_stat(stats: LireStats, name: str, amount) -> LireStats:
    cur = getattr(stats, name)
    return stats.replace(**{name: cur + torch.as_tensor(amount, device=cur.device).to(torch.int32)})
