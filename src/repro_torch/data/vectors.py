"""Synthetic vector datasets + the paper's update workloads (§5.1).

* :func:`make_sift_like`   — near-uniform clustered byte-ish vectors (the
  SIFT regime where the paper found SPANN+ ≈ SPFresh).
* :func:`make_spacev_like` — skewed cluster masses + a drifting component
  (the SPACEV regime where distribution shift breaks append-only updates).
* :class:`UpdateWorkload`  — workload A/B/C generator: a base set, an
  update-candidate pool, and per-epoch 1% delete + 1% insert batches
  ("1% daily update rate over N days").
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _clustered(
    rng: np.random.Generator,
    n: int,
    dim: int,
    n_clusters: int,
    *,
    weights: np.ndarray | None = None,
    spread: float = 0.08,
    drift: float = 0.0,
) -> np.ndarray:
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    p = weights / weights.sum() if weights is not None else None
    assign = rng.choice(n_clusters, size=n, p=p)
    x = centers[assign] + spread * rng.normal(size=(n, dim)).astype(np.float32)
    if drift > 0:
        # a time-ordered drift: later vectors migrate toward a new region
        t = np.linspace(0, 1, n)[:, None].astype(np.float32)
        direction = rng.normal(size=(1, dim)).astype(np.float32)
        x = x + drift * t * direction
    return x.astype(np.float32)


def make_sift_like(n: int, dim: int = 16, seed: int = 0) -> np.ndarray:
    """Near-uniform cluster masses (the 'uniform' dataset of Fig. 9)."""
    rng = np.random.default_rng(seed)
    return _clustered(rng, n, dim, n_clusters=max(8, n // 500))


def make_spacev_like(n: int, dim: int = 16, seed: int = 0) -> np.ndarray:
    """Skewed cluster masses (Zipf) — 'data distribution shifts over time'."""
    rng = np.random.default_rng(seed)
    k = max(8, n // 500)
    w = 1.0 / np.arange(1, k + 1) ** 1.2
    return _clustered(rng, n, dim, n_clusters=k, weights=w, drift=0.5)


def make_shifting_stream(
    n: int, dim: int = 16, seed: int = 0, hot_fraction: float = 0.7
) -> np.ndarray:
    """Insert stream concentrated in a few hot regions (the shift
    micro-benchmark of paper Fig. 2/10)."""
    rng = np.random.default_rng(seed)
    k = 16
    w = np.full(k, (1 - hot_fraction) / (k - 2))
    w[:2] = hot_fraction / 2
    return _clustered(rng, n, dim, n_clusters=k, weights=w, spread=0.05)


@dataclasses.dataclass
class UpdateWorkload:
    """Paper §5.1: base set + disjoint update pool; each epoch deletes
    ``rate`` of the index and inserts ``rate`` fresh vectors."""

    base: np.ndarray          # (n_base, d) initial index contents
    pool: np.ndarray          # (n_pool, d) update candidates (disjoint)
    rate: float = 0.01
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._live = dict(enumerate(range(len(self.base))))  # vid -> row
        self._next_vid = len(self.base)
        self._pool_pos = 0

    @classmethod
    def spacev(cls, n: int = 20000, dim: int = 16, rate: float = 0.01,
               seed: int = 0) -> "UpdateWorkload":
        data = make_spacev_like(2 * n, dim, seed)
        return cls(base=data[:n], pool=data[n:], rate=rate, seed=seed)

    @classmethod
    def sift(cls, n: int = 20000, dim: int = 16, rate: float = 0.01,
             seed: int = 0) -> "UpdateWorkload":
        data = make_sift_like(2 * n, dim, seed)
        return cls(base=data[:n], pool=data[n:], rate=rate, seed=seed)

    @property
    def dim(self) -> int:
        return self.base.shape[1]

    def live_ids(self) -> np.ndarray:
        return np.fromiter(self._live.keys(), dtype=np.int64)

    def live_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        ids = self.live_ids()
        all_data = np.concatenate([self.base, self.pool])
        rows = np.asarray([self._live[i] for i in ids])
        return all_data[rows], ids

    def epoch(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One update epoch → (delete_vids, insert_vecs, insert_vids)."""
        n_upd = max(1, int(self.rate * len(self._live)))
        live = self.live_ids()
        del_vids = self._rng.choice(live, size=min(n_upd, len(live)),
                                    replace=False)
        for v in del_vids:
            del self._live[int(v)]
        take = min(n_upd, len(self.pool) - self._pool_pos)
        rows = np.arange(self._pool_pos, self._pool_pos + take)
        self._pool_pos += take
        ins_vecs = self.pool[rows]
        ins_vids = np.arange(self._next_vid, self._next_vid + take)
        self._next_vid += take
        for v, r in zip(ins_vids, rows):
            self._live[int(v)] = len(self.base) + int(r)
        return del_vids.astype(np.int64), ins_vecs, ins_vids.astype(np.int64)

    def queries(self, n_queries: int, noise: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
        """Queries near live vectors + brute-force ground truth (k=10)."""
        vecs, ids = self.live_vectors()
        sel = self._rng.integers(0, len(vecs), size=n_queries)
        q = vecs[sel] + noise * self._rng.normal(size=(n_queries, self.dim)).astype(np.float32)
        d = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)
        gt = ids[np.argsort(d, axis=1)[:, :10]]
        return q.astype(np.float32), gt


# make_spacev_int8's shape.  Neighbourhoods of one build posting's size
# (the build splits to at most 57 vectors at spfresh-1b) in a low intrinsic
# dimension keep the closure replicas near one per vector, so postings keep
# headroom for inserts: an index without the maintenance round cannot
# split a full posting.
NEIGHBOURHOOD = 55        # vectors per neighbourhood
INTRINSIC = 8             # dimension of each neighbourhood's subspace
SPREAD = 0.2              # per-dim std of a neighbourhood, at unit scale
SCALE = 32.0              # unit scale -> byte values
QUERY_NOISE = 0.5         # per-dim Gaussian noise of make_queries, in bytes


def make_spacev_int8(n: int, dim: int = 100, seed: int = 0) -> np.ndarray:
    """SPACEV-like byte vectors: ``ceil(n / NEIGHBOURHOOD)`` neighbourhoods
    of ``NEIGHBOURHOOD`` vectors each (the rows shuffled), centred on
    random unit-scale points and spread over an ``INTRINSIC``-dimensional
    random subspace (total variance ``dim * SPREAD**2``), scaled by
    ``SCALE``, rounded and clipped to [-127, 127], returned as f32.

    The neighbourhoods lie far apart (centres ~450 byte units apart, each
    ~64 wide), so a query's true top-10 nearly always sits in one posting.
    Integer values in range make the float → int8 payload cast of a
    ``vector_dtype="int8"`` config exact in every framework."""
    rng = np.random.default_rng(seed)
    k = max(1, -(-n // NEIGHBOURHOOD))
    centers = rng.normal(size=(k, dim)).astype(np.float32)
    basis = (rng.normal(size=(k, INTRINSIC, dim)) / np.sqrt(dim)).astype(np.float32)
    assign = rng.permutation(np.repeat(np.arange(k), NEIGHBOURHOOD))[:n]
    z = rng.normal(size=(n, INTRINSIC)).astype(np.float32)
    z *= np.float32(SPREAD * np.sqrt(dim / INTRINSIC))
    x = centers[assign] + np.einsum("ni,nid->nd", z, basis[assign])
    return to_bytes(x)


def to_bytes(x: np.ndarray) -> np.ndarray:
    """Unit-scale vectors as integer byte values: scaled by ``SCALE``,
    rounded and clipped to [-127, 127], returned as f32 (the float → int8
    payload cast of a ``vector_dtype="int8"`` config is then exact)."""
    return np.clip(np.round(x * SCALE), -127, 127).astype(np.float32)


def make_spacev_like_bytes(n: int, dim: int = 100, seed: int = 0) -> np.ndarray:
    """:func:`make_spacev_like` (Zipf cluster masses, drift along the row
    order) in byte values (:func:`to_bytes`)."""
    return to_bytes(make_spacev_like(n, dim, seed))


def make_queries(base: np.ndarray, n_queries: int, seed: int = 0) -> np.ndarray:
    """Queries near random base rows (f32, Gaussian ``QUERY_NOISE`` per dim)."""
    rng = np.random.default_rng(seed + 1)
    sel = rng.integers(0, len(base), size=n_queries)
    q = base[sel] + QUERY_NOISE * rng.normal(size=(n_queries, base.shape[1]))
    return q.astype(np.float32)
