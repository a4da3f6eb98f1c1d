"""The benchmark's data, made from ``--seed``: a frozen copy of the port's
``make_spacev_like_bytes``, ``to_bytes`` and ``make_queries``
(``repro_torch/data/vectors.py``), so that a change to the program's
generators cannot change what the benchmark measures.

``spacev_like_bytes(n, dim, seed)`` draws Zipf cluster masses with a drift
along the row order, scaled to integer byte values: the rows after the
base carry the drift, so inserting them forces LIRE to split.
"""
from __future__ import annotations

import numpy as np

SCALE = 32.0              # unit scale -> byte values
QUERY_NOISE = 0.5         # per-dim Gaussian noise of a query, in bytes


def _clustered(rng, n, dim, n_clusters, *, weights=None, spread=0.08, drift=0.0):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    p = weights / weights.sum() if weights is not None else None
    assign = rng.choice(n_clusters, size=n, p=p)
    x = centers[assign] + spread * rng.normal(size=(n, dim)).astype(np.float32)
    if drift > 0:
        t = np.linspace(0, 1, n)[:, None].astype(np.float32)
        direction = rng.normal(size=(1, dim)).astype(np.float32)
        x = x + drift * t * direction
    return x.astype(np.float32)


def to_bytes(x: np.ndarray) -> np.ndarray:
    """Unit-scale vectors as integer byte values in [-127, 127], as f32."""
    return np.clip(np.round(x * SCALE), -127, 127).astype(np.float32)


def spacev_like_bytes(n: int, dim: int, seed: int) -> np.ndarray:
    """``n`` rows of Zipf-massed clusters (``n // 500`` of them, at least 8)
    drifting along the row order, in byte values."""
    rng = np.random.default_rng(seed)
    k = max(8, n // 500)
    w = 1.0 / np.arange(1, k + 1) ** 1.2
    return to_bytes(_clustered(rng, n, dim, n_clusters=k, weights=w, drift=0.5))


def queries_near(base: np.ndarray, n_queries: int, seed: int) -> np.ndarray:
    """Queries near random base rows (f32, Gaussian ``QUERY_NOISE`` a dim)."""
    rng = np.random.default_rng(seed + 1)
    sel = rng.integers(0, len(base), size=n_queries)
    q = base[sel] + QUERY_NOISE * rng.normal(size=(n_queries, base.shape[1]))
    return q.astype(np.float32)


def make(cfg: dict, seed: int) -> dict:
    """The cell's data from its configuration's ``data`` entry: ``base``
    (vids ``0..n_base-1``), ``pool`` (the next rows in row order, inserted
    under vids ``n_base..``) and the ``queries`` the traffic draws from."""
    d = cfg["data"]
    rows = spacev_like_bytes(d["n_base"] + d["pool_rows"], cfg["lire"]["dim"], seed)
    base, pool = rows[:d["n_base"]], rows[d["n_base"]:]
    return {"base": base, "pool": pool, "queries": queries_near(base, d["query_pool"], seed)}
