"""Two-tower retrieval served by the SPFresh index on the PyTorch/CUDA
port (the `retrieval_cand` cell) with streaming catalog churn — against
the brute-force GEMM baseline.  The second half attaches the batched
ServeEngine in front of the corpus: lookups and churn flow through the
micro-batched queue, background maintenance is policy-scheduled, and the
engine's report shows latency percentiles, padding waste and maintenance
throughput.  The reference example's flow and sizes
(``examples/retrieval_serving.py``); runs on the card unless asked for
the CPU:

    PYTHONPATH=src python examples/torch_retrieval_serving.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.types import LireConfig, resolve_device
from repro_torch.models import recsys as R
from repro_torch.serve.policy import BacklogPolicy
from repro_torch.serve.retrieval import IndexedRetriever


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    model_cfg = R.TwoTowerConfig(
        n_items=20000, n_user_fields=4, user_vocab_per_field=1000,
        embed_dim=32, tower_dims=(64, 16),
    )
    params = R.twotower_init(torch.Generator(device=dev).manual_seed(0), model_cfg, device=dev)
    index_cfg = LireConfig(
        dim=16, block_size=16, max_blocks_per_posting=8, num_blocks=16384,
        num_postings_cap=2048, num_vectors_cap=262144,
        split_limit=96, merge_limit=12, reassign_range=8, replica_count=2,
        nprobe=16,
    )

    retriever = IndexedRetriever(params, model_cfg, index_cfg, device=dev)
    catalog = np.arange(15000)
    t0 = time.perf_counter()
    retriever.build_corpus(catalog)
    print(f"corpus of {len(catalog)} items indexed on {dev} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({retriever.index.stats()['n_postings']} postings)")

    rng = np.random.default_rng(1)
    users = rng.integers(0, 1000, size=(16, 4)).astype(np.int32)

    t0 = time.perf_counter()
    s_ann, ids_ann = retriever.retrieve(users, k=10)
    t_ann = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_bf, ids_bf = retriever.retrieve_bruteforce(users, k=10)
    t_bf = time.perf_counter() - t0

    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids_ann, ids_bf))
    print(f"ANN recall vs brute force: {hits / 160:.3f} "
          f"(ann {t_ann * 1e3:.0f}ms vs gemm {t_bf * 1e3:.0f}ms for 16 queries, first calls)")

    # --- streaming catalog churn: no index rebuild ---
    new_items = np.arange(15000, 16000)
    t0 = time.perf_counter()
    retriever.add_items(new_items)
    st = retriever.index.stats()
    print(f"+1000 items in-place in {time.perf_counter() - t0:.1f}s; "
          f"stats: splits={st['n_splits']}, reassigned={st['n_reassigned']}")
    s2, ids2 = retriever.retrieve(users, k=10)
    print(f"fresh items now appearing in top-10s: {(ids2 >= 15000).sum()}")

    # --- the serving pipeline in front of the corpus ---
    # attach_engine accepts a ServiceSpec: its serve/scan/maintenance parts
    # compile to the pipeline config.
    engine = retriever.attach_engine(
        api.ServiceSpec(
            index=api.IndexSpec(config=index_cfg),
            serve=api.ServeSpec(search_k=10, max_batch=128, policy="backlog"),
            maintenance=api.MaintenanceSpec(maintain_budget=16),
        ),
        policy=BacklogPolicy(threshold=1, budget=16),
    )
    t0 = time.perf_counter()
    for _ in range(8):                       # a burst of lookup traffic
        users = rng.integers(0, 1000, size=(16, 4)).astype(np.int32)
        retriever.retrieve(users, k=10)
    retriever.add_items(np.arange(16000, 16500))   # churn mid-traffic
    retriever.remove_items(np.arange(100))
    retriever.retrieve(users, k=10)
    engine.drain()
    rep = engine.report()
    print(f"pipeline: {8 + 1} retrievals + churn in "
          f"{time.perf_counter() - t0:.1f}s — "
          f"search p50={rep['search']['p50_ms']:.1f}ms "
          f"p99={rep['search']['p99_ms']:.1f}ms, "
          f"pad_waste={rep['queue']['padding_waste_frac']:.3f}, "
          f"maint {rep['maintenance']['steps']} steps "
          f"@{rep['maintenance']['steps_per_s']:.1f}/s "
          f"({rep['maintenance']['policy']})")


if __name__ == "__main__":
    main()
