"""Shared pieces of the harness's CPU tests: a cell shrunk to a size the
CPU runs in seconds, run through the same ``bench.run`` as on the card.

    PYTHONPATH=src python -m pytest -q cardbench/tests
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 17          # past 32 signed bits, as a benchmark check's seeds may be


def small_config(cfg: dict) -> dict:
    cfg["data"].update(n_base=2000, pool_rows=2000, query_pool=1024)
    cfg["lire"].update(num_blocks=4096, num_postings_cap=512, num_vectors_cap=8192,
                       scan_page_budget=1024)
    cfg["serve"].update(max_batch=128)
    return cfg


def small_mix(mix: dict) -> dict:
    mix["warmup_s"] = 0.5
    if mix["search"]["loop"] == "closed":
        mix["search"]["clients"] = 3
    else:
        mix["search"]["rate_per_s"] = 15.0
        mix["ingest"]["rate_per_s"] = 3.0
    mix["search"]["rows"].update(min=8, max=24)
    return mix


def run_small(workload: str, *, traced: bool = False, fault=None, controls=None,
              seconds: float = 1.5, root=ROOT):
    from cardbench import bench

    return bench.run(root, workload, SEED, seconds, traced, t_start=time.perf_counter(),
                     device="cpu", edit_config=small_config, edit_mix=small_mix, fault=fault,
                     controls=controls)


@pytest.fixture(scope="session")
def mix_run():
    """One small ``spacev.update_mix`` run with the TF32 control judged on
    its sample."""
    from cardbench import reference

    def tf32(live, queries, seqnos):
        return reference.exact_topk(live, queries, seqnos, 10, device="cpu", tf32=True)
    return run_small("spacev.update_mix", traced=True, controls={"tf32": tf32})
