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
  taken at the smoke's N (about 15 minutes on 8 CPU cores);
* ``serve`` continues ``update`` with the chip smoke's cooperative serve
  phase (``chip_smoke.serve_requests``: 64 steps of a 128-query search, a
  64-row insert and every 4th step a 64-vid delete) through the
  reference's ``ServeEngine`` under the smoke's ``EngineConfig``, then
  ``engine.drain()``; ground truth over the live rows.  It also builds
  the two-level group index (512 groups of 256) and measures
  ``search_grouped`` at gprobe 32;
* ``sharded`` on the ``update`` cell's N and data: the reference's
  ``ShardedIndex`` over 4 shards on 4 fake CPU devices (this script sets
  ``XLA_FLAGS`` for them before JAX starts), built and searched, handles
  against brute force over the base (about 30 minutes on 8 CPU cores);
* ``retrieval``: the reference's two-tower ``IndexedRetriever`` on the
  chip smoke's retrieval params (the port's ``twotower_init_counter`` at
  ``SERVE_CONFIG``, made here on the CPU for the item rows the corpus
  uses: every value is a function of its seed and position, so these are
  the card's bits), corpus ids ``0..chip_smoke.RETRIEVAL_FLOOR_N - 1``
  in ``ann_index_cfg`` with its capacities times
  ``chip_smoke.RETRIEVAL_FLOOR_SCALE`` (gather oracle), and the smoke's
  1,024 users: recall@10 of ``retrieve`` against ``retrieve_bruteforce``
  at nprobe 16.

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
import os
import sys
from pathlib import Path

# the sharded cell's mesh: fake CPU devices exist only if asked for before
# JAX starts (the other cells run on the first device)
SHARDS = 4
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={SHARDS} "
                           + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.spfresh import CONFIG  # noqa: E402
from repro.core import clustering  # noqa: E402
from repro.core.grouping import build_group_index, search_grouped  # noqa: E402
from repro.core.index import SPFreshIndex  # noqa: E402
from repro.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.data.vectors import (  # noqa: E402
    make_queries, make_spacev_int8, make_spacev_like_bytes,
)

N = 20_000
UPDATE_N = 250_000
UPDATE_INSERT = 4096
QUERIES = 1024
NPROBES = (1, CONFIG.nprobe)
CELLS = {"fp32": {}, "int8": {"codec": "int8", "rerank_factor": 4}, "update": {},
         "serve": {}, "sharded": {}, "retrieval": {}}
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the serve phase's requests)


def ground_truth(queries, rows, ids):
    """Exact top-10 vids of each query over ``rows`` (vids ``ids``)."""
    q64, b64 = queries.astype(np.float64), rows.astype(np.float64)
    d = (q64 * q64).sum(1)[:, None] - 2 * q64 @ b64.T + (b64 * b64).sum(1)[None]
    return ids[np.argsort(d, axis=1)[:, :10]]


def recall_of(gt, got):
    return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), got.tolist())]))


def recall_at_10(idx, queries, rows, ids, nprobe):
    """Recall@10 of ``idx`` against brute force over ``rows`` (vids ``ids``)."""
    _, got = idx.search(queries, 10, nprobe=nprobe)
    return recall_of(ground_truth(queries, rows, ids), got)


def _update_run(cfg, n, n_insert, seed, queries_n):
    data = make_spacev_like_bytes(n + n_insert, cfg.dim, seed=seed)
    base = data[:n]
    queries = make_queries(base, queries_n, seed=seed)
    idx = SPFreshIndex.build(cfg, base, seed=seed)
    idx.insert(data[n:], np.arange(n, n + n_insert, dtype=np.int32))
    victims = np.random.default_rng(seed + 7).choice(n, size=n_insert, replace=False)
    idx.delete(victims.astype(np.int32))
    idx.maintain()
    return idx, queries, data, victims


def update_sequence(cfg, n: int, n_insert: int, seed: int, queries_n: int = QUERIES):
    """The chip smoke's update path on the reference: returns ``(index,
    queries, live rows, their vids)`` after build, insert, delete and
    maintain."""
    idx, queries, data, victims = _update_run(cfg, n, n_insert, seed, queries_n)
    keep = np.ones(n + n_insert, bool)
    keep[victims] = False
    ids = np.flatnonzero(keep)
    return idx, queries, data[ids], ids


def serve_sequence(cfg, n: int, n_insert: int, seed: int, queries_n: int = QUERIES,
                   steps: int = chip_smoke.SERVE_STEPS):
    """``update_sequence``, then the chip smoke's cooperative serve phase
    through the reference's ``ServeEngine`` and ``engine.drain()``:
    returns ``(index, queries, live rows, their vids, engine report)``."""
    idx, queries, data, victims = _update_run(cfg, n, n_insert, seed, queries_n)
    engine = ServeEngine(idx, EngineConfig(nprobe=cfg.nprobe, **chip_smoke.SERVE_ENGINE))
    reqs = chip_smoke.serve_requests(np, seed, n, victims, queries, data, steps=steps)
    for step in reqs["steps"]:
        chip_smoke.submit_step(engine, step)
    engine.drain()
    return idx, queries, reqs["rows"], reqs["ids"], engine.report()


def grouped_recall(idx, queries, rows, ids, *, n_groups, capacity, gprobe, chunk=128):
    """Recall@10 of ``search_grouped`` at ``gprobe`` over a fresh group
    index (queries in chunks: level 2 gathers ``(Q, gprobe*capacity, d)``)."""
    gidx = build_group_index(idx.state, n_groups=n_groups, capacity=capacity)
    got = []
    for s in range(0, len(queries), chunk):
        _, v = search_grouped(idx.state, gidx, jnp.asarray(queries[s:s + chunk]), k=10,
                              gprobe=gprobe)
        got.append(np.asarray(v))
    return recall_of(ground_truth(queries, rows, ids), np.concatenate(got))


def sharded_recall(cfg, n: int, seed: int, queries_n: int = QUERIES, chunk: int = 64):
    """The reference's ``ShardedIndex`` over ``SHARDS`` shards on ``n`` rows
    of the update cell's data: recall@10 by nprobe (queries in chunks: the
    gather oracle holds ``(Q, nprobe·cap, d)`` a shard) and the stats."""
    from repro.distributed.sharded_index import ShardedIndex

    base = make_spacev_like_bytes(n + UPDATE_INSERT, cfg.dim, seed=seed)[:n]
    queries = make_queries(base, queries_n, seed=seed)
    mesh = jax.make_mesh((SHARDS,), ("model",))
    idx, handles = ShardedIndex.build(mesh, cfg, base, SHARDS, seed=seed)
    gt = ground_truth(queries, base, handles)
    recall = {}
    for nprobe in NPROBES:
        got = [idx.search(queries[s:s + chunk], 10, nprobe)[1]
               for s in range(0, len(queries), chunk)]
        recall[nprobe] = recall_of(gt, np.concatenate(got))
    return recall, idx.stats()


def retrieval_recall(seed: int, n: int, scale: int, users_n: int = QUERIES):
    """The reference's ``IndexedRetriever`` on the chip smoke's retrieval
    params, corpus and users (see the module docstring): recall@10 of
    ``retrieve`` against ``retrieve_bruteforce`` and the index's stats."""
    from repro.core.types import LireConfig
    from repro.models import recsys as R
    from repro.serve.retrieval import IndexedRetriever
    from repro_torch import convert
    from repro_torch.configs.two_tower_retrieval import SERVE_CONFIG
    from repro_torch.models.recsys import twotower_init_counter

    cfg = dataclasses.replace(SERVE_CONFIG, n_items=n)     # the table's first n rows
    tree = convert.twotower_params_to_numpy(twotower_init_counter(seed, cfg, device="cpu"))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.view(jnp.bfloat16)), tree)
    port_icfg = chip_smoke.retrieval_index_cfg(scale)
    icfg = LireConfig(**dict(dataclasses.asdict(port_icfg), use_pallas_nav=False,
                             use_pallas_scan=False))
    retr = IndexedRetriever(params, R.TwoTowerConfig(**dataclasses.asdict(cfg)), icfg)
    retr.build_corpus(np.arange(n))
    users = chip_smoke.retrieval_users(np, seed, users_n, cfg)
    _, ann = retr.retrieve(users, k=10)
    _, bf = retr.retrieve_bruteforce(users, k=10)
    return recall_of(bf, ann), retr.index.stats()


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
        n = UPDATE_N if cell in ("update", "serve", "sharded") else N
        cfg = dataclasses.replace(
            CONFIG, num_blocks=max(8192, n // 4),
            num_postings_cap=max(2048, n // 16), num_vectors_cap=2 * n, **CELLS[cell],
        )
        extra = {}
        if cell == "retrieval":
            n, scale = chip_smoke.RETRIEVAL_FLOOR_N, chip_smoke.RETRIEVAL_FLOOR_SCALE
            recall, stats = retrieval_recall(args.seed, n, scale)
            print(json.dumps({"cell": cell, "n": n, "capacity_scale": scale, "users": QUERIES,
                              "seed": args.seed, "nprobe": 16, "recall_at_10": recall,
                              "stats": stats}, default=str))
            continue
        if cell == "sharded":
            recall, stats = sharded_recall(cfg, n, args.seed)
            print(json.dumps({"cell": cell, "n": n, "shards": SHARDS, "queries": QUERIES,
                              "seed": args.seed, "recall_at_10_by_nprobe": recall,
                              "stats": stats}, default=str))
            continue
        if cell == "update":
            idx, queries, rows, ids = update_sequence(cfg, n, UPDATE_INSERT, args.seed)
        elif cell == "serve":
            idx, queries, rows, ids, rep = serve_sequence(cfg, n, UPDATE_INSERT, args.seed)
            g = dict(chip_smoke.GROUPED)
            extra = {"grouped_recall_at_10": grouped_recall(idx, queries, rows, ids, **g),
                     "grouped": g, "engine_report": rep}
        else:
            rows = make_spacev_int8(N, CONFIG.dim, seed=args.seed)
            queries = make_queries(rows, QUERIES, seed=args.seed)
            ids = np.arange(N)
            idx = SPFreshIndex.build(cfg, rows, seed=args.seed)
        recall = {nprobe: recall_at_10(idx, queries, rows, ids, nprobe) for nprobe in NPROBES}
        print(json.dumps({"cell": cell, "n": n, "queries": QUERIES, "seed": args.seed,
                          "recall_at_10_by_nprobe": recall, **extra, "stats": idx.stats()},
                         default=str))


if __name__ == "__main__":
    main()
