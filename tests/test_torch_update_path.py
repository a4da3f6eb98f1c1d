"""CPU rehearsal of ``chip_smoke.py``'s ``update`` main path.

The path runs through the port's ``SPFreshIndex`` on the CPU at a small
size (d=16, the ``SMOKE`` geometry with room for the splits), with the
recall floors taken, as on the card, from the JAX reference after the
same sequence on the same data (``scripts/reference_recall.py``) minus
``chip_smoke.RECALL_MARGIN``.  Every check of the path must pass.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from repro.core.types import LireConfig as RConfig
from repro_torch.configs.spfresh import SEARCH_Q, SMOKE

REPO = Path(__file__).resolve().parents[1]


def _reference_recall_script():
    spec = importlib.util.spec_from_file_location(
        "reference_recall", REPO / "scripts" / "reference_recall.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_update_path_rehearses_on_the_cpu():
    n, n_ins = 1500, 256
    cfg = dataclasses.replace(SMOKE, num_blocks=2048, num_postings_cap=512,
                              use_pallas_nav=True, use_pallas_scan=True,
                              scan_schedule="batched")
    ref = _reference_recall_script()
    ridx, queries, rows, ids = ref.update_sequence(
        RConfig(**dataclasses.asdict(cfg)), n, n_ins, seed=0, queries_n=min(SEARCH_Q, n))
    floors = {p: ref.recall_at_10(ridx, queries, rows, ids, p) - chip_smoke.RECALL_MARGIN
              for p in (1, cfg.nprobe)}
    report = {}
    drains, ms_round = chip_smoke.update_path(torch, np, 0, report, cfg=cfg, device="cpu",
                                              n=n, n_insert=n_ins, floors=floors)
    assert drains["rounds"] > 0 and drains["jobs"] > 0 and ms_round > 0
    assert report["backlog_after_build"] > 0 and report["first_round_jobs"] > 0
    assert report["insert_self_top10"] >= 0.95
    assert report["round_aten_ops"] > 0 and report["round_cuda_kernels"] is None
    assert report["drain_idle_share"] is None
    assert report["stats"]["n_splits"] > 0
    assert set(report["recall_at_10"]) == {"batched@8", "batched@1", "per_query@8",
                                           "per_query@1"}


def test_serve_and_grouped_paths_rehearse_on_the_cpu():
    """The smoke's ``serve`` and ``grouped`` paths after the ``update``
    path, cut to 4 cooperative steps, 2 async threads of 20 operations and
    16 groups of 64; the recall floors come from the reference after the
    same requests through its ServeEngine (``serve_sequence``, and its
    ``search_grouped`` there), minus the margin."""
    n, n_ins, steps = 1500, 256, 4
    cfg = dataclasses.replace(SMOKE, num_blocks=2048, num_postings_cap=512,
                              use_pallas_nav=True, use_pallas_scan=True,
                              scan_schedule="batched")
    ref = _reference_recall_script()
    ridx, queries, rows, ids, rrep = ref.serve_sequence(
        RConfig(**dataclasses.asdict(cfg)), n, n_ins, seed=0,
        queries_n=min(SEARCH_Q, n), steps=steps)
    floors = {p: ref.recall_at_10(ridx, queries, rows, ids, p) - chip_smoke.RECALL_MARGIN
              for p in (1, cfg.nprobe)}
    geometry = dict(n_groups=16, capacity=64, gprobe=4)
    grouped_floor = ref.grouped_recall(ridx, queries, rows, ids, **geometry) \
        - chip_smoke.RECALL_MARGIN
    carry = {}
    chip_smoke.update_path(torch, np, 0, {}, cfg=cfg, device="cpu", n=n, n_insert=n_ins,
                           floors={1: 0.0, cfg.nprobe: 0.0}, carry=carry)
    report = {}
    live_ids, live_rows = chip_smoke.serve_path(
        torch, np, 0, report, carry, device="cpu", steps=steps, threads=2, ops_each=20,
        async_rows=8, floors=floors)
    coop = report["cooperative"]
    assert coop["dispatches"]["drain"] == 1 and coop["dispatches"]["insert"] >= steps
    # the port's engine formed the reference engine's micro-batches
    assert coop["report"]["queue"] == rrep["queue"]
    assert report["async_phase"]["tally"]["violations"] == 0
    assert report["async_phase"]["device_busy_share"] is None
    grouped = {}
    recall = chip_smoke.grouped_path(
        torch, np, 0, grouped, carry, live_ids, live_rows, device="cpu", grouped=geometry,
        floor=grouped_floor)
    assert grouped["full_gprobe_overlap"] > 0.9 and recall == grouped["recall_at_10"]


def test_durable_path_rehearses_on_the_cpu(tmp_path):
    """The smoke's ``durable`` path on the CPU, cut to 4 cooperative steps
    (the delta after 2) and 2 async threads of 20 operations: both crashes
    recover every leaf bit for bit, no update ticket resolves before its
    fsync, and the report carries the numbers the card run prints."""
    cfg = dataclasses.replace(SMOKE, num_blocks=2048, num_postings_cap=512,
                              use_pallas_nav=True, use_pallas_scan=True,
                              scan_schedule="batched")
    report = {}
    chip_smoke.durable_path(torch, np, 0, report, cfg=cfg, device="cpu", n=1500, steps=4,
                            delta_at=2, threads=2, ops_each=20, async_rows=8,
                            root_dir=tmp_path)
    coop, asy = report["cooperative"], report["async_phase"]
    assert 0 < coop["delta_bytes"] < 0.5 * coop["base_bytes"]
    assert coop["recovery"]["replayed_records"] == coop["wal_tail_records"] > 0
    assert coop["wal_fsyncs_per_dispatch"] < 1.0
    assert asy["early_acks"] == 0 and asy["tally"]["violations"] == 0
    assert asy["recovery"]["replayed_records"] == asy["dispatches"] > 0
    assert list(tmp_path.iterdir()) == []          # the durable root was removed
