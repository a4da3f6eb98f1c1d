"""Recall@10 of the JAX reference index on the chip smoke's data generator.

Builds the reference (``src/repro``) at the spfresh-1b per-shard geometry
on N=20,000 vectors from ``repro_torch.data.make_spacev_int8`` (capacities
cut to fit the CPU; widths, posting geometry and protocol unchanged),
once per codec cell of the smoke: ``fp32`` (the payload stored as raw
bytes) and ``int8`` with ``rerank_factor=4`` (the reference's int8 cell,
``benchmarks/bench_search_path.py`` ``CODEC_CELLS``).  Each searches 1,024
queries from ``make_queries`` with k=10 through the gather oracle at
nprobe=1 and at the config's nprobe=64, and prints recall@10 against
brute force for each.  ``chip_smoke.py`` asserts the port's recall at
N=1,000,000 against these numbers minus 0.05.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_recall.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro.configs.spfresh import CONFIG
from repro.core.index import SPFreshIndex
from repro_torch.data.vectors import make_queries, make_spacev_int8

N = 20_000
QUERIES = 1024
NPROBES = (1, CONFIG.nprobe)
CELLS = {"fp32": {}, "int8": {"codec": "int8", "rerank_factor": 4}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    base = make_spacev_int8(N, CONFIG.dim, seed=args.seed)
    queries = make_queries(base, QUERIES, seed=args.seed)
    q64, b64 = queries.astype(np.float64), base.astype(np.float64)
    d = (q64 * q64).sum(1)[:, None] - 2 * q64 @ b64.T + (b64 * b64).sum(1)[None]
    gt = np.argsort(d, axis=1)[:, :10]
    for cell, codec in CELLS.items():
        cfg = dataclasses.replace(
            CONFIG, num_blocks=max(8192, N // 4),
            num_postings_cap=max(2048, N // 16), num_vectors_cap=2 * N, **codec,
        )
        idx = SPFreshIndex.build(cfg, base, seed=args.seed)
        recall = {}
        for nprobe in NPROBES:
            _, got = idx.search(queries, 10, nprobe=nprobe)
            recall[nprobe] = float(np.mean([len(set(a) & set(b)) / 10
                                            for a, b in zip(gt.tolist(), got.tolist())]))
        print(json.dumps({"cell": cell, "n": N, "queries": QUERIES, "seed": args.seed,
                          "recall_at_10_by_nprobe": recall, "stats": idx.stats()}))


if __name__ == "__main__":
    main()
