"""Recall@10 of the JAX reference index on the chip smoke's data generators.

Builds the reference (``src/repro``) at the spfresh-1b per-shard geometry
(capacities cut to fit the CPU; widths, posting geometry and protocol
unchanged), once per cell of the smoke:

* ``fp32`` and ``int8`` (``rerank_factor=4``, the reference's int8 cell,
  ``benchmarks/bench_search_path.py`` ``CODEC_CELLS``) on N=20,000 from
  ``repro_torch.data.make_spacev_int8``: build, then search;
* ``update`` on N=250,000 from the reference's own generator
  ``make_spacev_like`` in byte values
  (``repro_torch.data.make_spacev_like_bytes``), the smoke's own size:
  build, insert the last 4,096 rows of the generated array past posting
  capacity (the insert drains the Local Rebuilder and retries), delete
  4,096 base rows, ``maintain()``, then search; ground truth over the
  live rows.  Recall on this generator falls as N grows, so its floor is
  taken at the smoke's N (about 15 minutes on 8 CPU cores).

Each searches 1,024 queries from ``make_queries`` with k=10 through the
gather oracle at nprobe=1 and at the config's nprobe=64 and prints
recall@10 against brute force for each.  ``chip_smoke.py`` holds the
port's recall to these numbers minus 0.05.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_recall.py
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import jax
import numpy as np

from repro.configs.spfresh import CONFIG
from repro.core import clustering
from repro.core.index import SPFreshIndex
from repro_torch.data.vectors import make_queries, make_spacev_int8, make_spacev_like_bytes

N = 20_000
UPDATE_N = 250_000
UPDATE_INSERT = 4096
QUERIES = 1024
NPROBES = (1, CONFIG.nprobe)
CELLS = {"fp32": {}, "int8": {"codec": "int8", "rerank_factor": 4}, "update": {}}


def recall_at_10(idx, queries, rows, ids, nprobe):
    """Recall@10 of ``idx`` against brute force over ``rows`` (vids ``ids``)."""
    q64, b64 = queries.astype(np.float64), rows.astype(np.float64)
    d = (q64 * q64).sum(1)[:, None] - 2 * q64 @ b64.T + (b64 * b64).sum(1)[None]
    gt = ids[np.argsort(d, axis=1)[:, :10]]
    _, got = idx.search(queries, 10, nprobe=nprobe)
    return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), got.tolist())]))


def update_sequence(cfg, n: int, n_insert: int, seed: int, queries_n: int = QUERIES):
    """The chip smoke's update path on the reference: returns ``(index,
    queries, live rows, their vids)`` after build, insert, delete and
    maintain."""
    data = make_spacev_like_bytes(n + n_insert, cfg.dim, seed=seed)
    base = data[:n]
    queries = make_queries(base, queries_n, seed=seed)
    idx = SPFreshIndex.build(cfg, base, seed=seed)
    idx.insert(data[n:], np.arange(n, n + n_insert, dtype=np.int32))
    victims = np.random.default_rng(seed + 7).choice(n, size=n_insert, replace=False)
    idx.delete(victims.astype(np.int32))
    idx.maintain()
    keep = np.ones(n + n_insert, bool)
    keep[victims] = False
    ids = np.flatnonzero(keep)
    return idx, queries, data[ids], ids


def _bounded_compiles(kmeans, every: int = 50):
    """``kmeans`` dropping JAX's compiled executables every ``every``
    calls.  The build compiles ``balanced_kmeans`` once per distinct node
    size; at N=250,000 the thousands of executables exhaust the process's
    memory maps.  Clearing them changes no result."""
    calls = [0]

    def wrapped(*args, **kwargs):
        calls[0] += 1
        if calls[0] % every == 0:
            jax.clear_caches()
            gc.collect()
        return kmeans(*args, **kwargs)

    return wrapped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    clustering.balanced_kmeans = _bounded_compiles(clustering.balanced_kmeans)
    for cell in args.cells.split(","):
        n = UPDATE_N if cell == "update" else N
        cfg = dataclasses.replace(
            CONFIG, num_blocks=max(8192, n // 4),
            num_postings_cap=max(2048, n // 16), num_vectors_cap=2 * n, **CELLS[cell],
        )
        if cell == "update":
            idx, queries, rows, ids = update_sequence(cfg, n, UPDATE_INSERT, args.seed)
        else:
            rows = make_spacev_int8(N, CONFIG.dim, seed=args.seed)
            queries = make_queries(rows, QUERIES, seed=args.seed)
            ids = np.arange(N)
            idx = SPFreshIndex.build(cfg, rows, seed=args.seed)
        recall = {nprobe: recall_at_10(idx, queries, rows, ids, nprobe) for nprobe in NPROBES}
        print(json.dumps({"cell": cell, "n": n, "queries": QUERIES, "seed": args.seed,
                          "recall_at_10_by_nprobe": recall, "stats": idx.stats()}))


if __name__ == "__main__":
    main()
