#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port of SPFresh (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a (one nvcc per source, in parallel) and prints the card.
   ``phase_resources`` then runs spflint for the port over ``src`` (0
   findings), holds each launch entry's ``<entry>_smem_bytes`` query (its
   launcher's shared memory and shape) equal to the passes' stdlib mirror
   for every payload at every geometry of ``SMEM_BINDINGS`` and at the
   entry's largest d, launches each where the mirror says it fits
   (against its plain version) and expects cudaErrorInvalidValue, with
   no fallback, where it says it refuses; the card's opt-in shared memory
   a block must be the 232,448 bytes the launchers hard-code.  It prints
   the table on a ``resources:`` line.
2. Holds each of the seven kernels against its plain PyTorch version on
   the card, at the spfresh-1b shapes and at ragged small shapes, and times
   both and the shortest composition of library calls for the same
   function.  #1 is also held on a tie-heavy and a negative-distance
   input; #4 and #5 are also held and timed on the main path's page mix
   (two real and two absent pages a probe, 10,393 distinct pages; every
   dead pair exactly (BIG, slots 0..k-1)); #1, #4, #6 and #3 are held
   and timed again at the retrieval path's d=256 geometry (bf16 pages),
   and #6, #7 and #3 held at d=256 for every payload; #6 and #7 are also timed on
   the main path's page mix (10,393 live rows of the 32,768-row budget,
   the rest padding), and #7 is held on a tie-heavy input at k = BS
   (exact slot order).  The search's pairs form of #6 and #7 is held bit
   for bit against the full form gathered through ``member_pos`` and timed
   beside it, on the main path's mix and at the search cells' 27,700 live
   pages, with its selected share and ``page_positions``' time.  #3 takes -1 padding ids and is held with them at
   the ragged shapes (every padding row exactly BIG); its wrapper
   ``ops.scan_unique_blocks`` is held and timed on the batched mix, with
   the masking pass it no longer takes timed beside it.  The per-query
   scans' rows give two byte bounds: each distinct page read once, and
   each probe's page read once.  Each line of ``-Xptxas -v`` (registers,
   spills) is printed, and summed per library.
3. Drives two main paths through ``SPFreshIndex`` at the full spfresh-1b
   per-shard geometry (``CONFIG_PAGED`` with kernel navigation), each from
   N=500,000 int8-valued vectors of one seed, the first path's state
   freed before the second is built:
   * ``fp32``: the bytes stored as they are; build, search under both
     scan schedules, insert four batches, delete, search again;
   * ``int8``: the int8 codec with the exact fp32 rerank
     (``rerank_factor=4``, the reference's int8 cell,
     ``benchmarks/bench_search_path.py:43`` ``CODEC_CELLS``); build,
     search under both schedules, insert one batch, delete, search again.
   Each asserts navigation against its plain version, recall at nprobe 1
   and 64, agreement with the gather oracle and between the schedules,
   delete and insert visibility and insert determinism, and (``int8``)
   that every returned distance is the exact one.  The kernels are timed
   inside one search per schedule.
   A third, ``update``, drives the maintenance round on the reference's
   generator (``make_spacev_like`` in bytes, ``UPDATE_N`` vectors, fp32
   codec): build (most postings over ``split_limit``), one round replayed
   bit for bit on a clone, both under ``torch.use_deterministic_algorithms``
   (PyTorch raises on an op it does not promise to be deterministic: the
   runtime half of spflint's SPF107), an insert batch whose rows land on full
   postings and wait for backpressure drains (every row must land, #1
   must launch in the drains), delete, ``maintain()`` (no backlog, no
   posting over ``split_limit``), and searches under both schedules with
   recall floors from the reference at the same N.
   A fourth, ``serve``, takes over the update path's index and drives the
   serving engine (``repro_torch.serve``): a cooperative phase of 64 steps
   (a 128-query search, a 64-row insert, every 4th step a 64-vid delete;
   the paper's 2:1 maintenance pipeline; the ``batched`` scan), whose
   recorded dispatch stream must replay bit for bit on a clone, whose
   ``engine.search`` must equal ``search_padded`` bit for bit, and whose
   recall must reach the reference's after the same requests; one
   ``search_begin`` per schedule under ``set_sync_debug_mode("error")``
   that must return while the card still works; then an async phase (a
   pump thread with deferred readback, the ``per_query`` scan) fed by 4
   submitter threads of 100 operations: no ordering violation, no
   resurrected delete, ANN misses at most 5%, a bit-identical replay, the
   card's busy share from the profiler's trace.  A fifth, ``grouped``,
   builds the two-level group index (512 groups of 256) on the final
   state, holds full-gprobe navigation against #1's flat one, and
   measures ``search_grouped``'s recall at gprobe 32.  A sixth,
   ``durable``, frees the earlier paths' state and opens a durable service
   (``repro_torch.api.open(service_spec(durable_root=...))``, the update
   cell's geometry and generator at ``DURABLE_N``) under a temporary root
   in ``build/``: the open-time base unit, ``drain()`` and a re-base; 16
   of the serve path's request steps with group commit, a delta
   checkpoint, 16 more (the WAL tail); a crash and ``api.open(spec)``,
   which must recover every leaf bit for bit with the same search ids;
   then an async phase (pump thread, ``per_query`` scan, 4 submitter
   threads) in which no update ticket may resolve before its fsync, a
   crash, and a bit-identical recovery again.  It prints the units' bytes
   and write seconds, the WAL's records, bytes and fsyncs a dispatch, and
   recovery split into load, upload and replay.
   A seventh, ``sharded``, frees the earlier state and opens a sharded,
   replicated, durable service (``api.open(service_spec(n_shards=4,
   n_replicas=2, durable_root=...))``, each shard at the update cell's
   geometry, ``UPDATE_N`` rows of its generator): one sharded search per
   schedule and nprobe must equal the host merge of the four shards' own
   searches and reach the reference's sharded recall minus 0.05, a dead
   shard must leak no handle, and one ``search_begin`` over the four
   shards must issue no host sync; 4 of the serve path's request steps
   (deletes by handle; the engine's slots work the build's backlog down)
   must land every insert, replay on a clone bit for bit on every shard
   and leave the synced replica bit-identical; a crash recovers every
   shard from the per-shard WALs; an async phase routes searches to the
   replica (no ticket acked before its fsync), forces a catch-up past the
   replica's window, and crashes and recovers again.  It prints state
   bytes, the build, search p50 against the shards' own searches, ms a
   sharded round, and recovery split into load, upload and replay.
   An eighth, ``retrieval``, frees the earlier state and serves two-tower
   retrieval (``repro_torch.serve.retrieval.IndexedRetriever``) at the
   reference's serving config (``SERVE_CONFIG``: bf16, 10M items, 8 user
   fields of 100,000 ids, embed dim 256, towers 1024-512-256), its params
   made on the card from the seed.  It first builds the recall floor's
   corpus (``RETRIEVAL_FLOOR_N`` items, the size of the reference's recall
   run): recall of ``retrieve`` against ``retrieve_bruteforce`` under both
   schedules, at least the reference's at that size minus 0.05, and the
   kernel path's ids against the gather oracle's on the same state.  Then
   on the same corpus (``RETRIEVAL_N`` items; a larger one would be built
   anew): ANN and brute-force p50 at Q=1 and Q=1,024, where a lookup's
   time goes, recall and the oracle check again, ``RETRIEVAL_ADD`` items
   added (every one must find itself) and ``RETRIEVAL_REMOVE`` removed
   (none may come back), then the engine through a
   ``ServiceSpec``: 8 bursts of 1,024 users with churn, ``drain()``,
   ``report()``.
   A ninth, ``train``, frees the earlier state and trains each recsys
   family's ``train_batch`` cell at its published width through
   ``repro_torch.train.Trainer`` (AdamW ``OPT``, no checkpoint): two-tower
   (``CONFIG``, f32, params made on the card by ``twotower_init_counter``)
   and MIND at 32,768 rows a batch, DeepFM at 65,536, BERT4Rec at 512 (the
   cuts ``TRAIN_BATCH`` names: what one card's 80 GB holds), 2 warm-up and
   4 timed steps each.  Every step must be finite with ``grad_norm > 0``
   and ``lr == schedule(OPT, count)``, every parameter leaf must move in
   step 1, and step 1's loss and ``grad_norm`` must equal the CPU path's
   on a host copy of the same parameters and batch (two-tower: only the
   rows the batch touches, remapped) within 1e-5 and 1e-4 relative.  It
   prints each family's step p50, peak memory and one step split into
   forward, backward and AdamW (CUDA events).  The trained towers, cast to
   bf16, then serve 65,536 items through ``IndexedRetriever`` (#1, #4):
   ids held against the gather oracle (``ORACLE_OVERLAP``), recall against
   brute force with no floor.  Last, MIND restarts under
   ``torch.use_deterministic_algorithms(True)``: 6 steps in one run
   against 3, a checkpoint under a temporary root in ``build/``, a fresh
   ``Trainer`` restoring it and 3 more; every leaf of the parameters and
   the optimiser state must be equal.
   A tenth, ``lm``, frees the earlier state and serves the LM family at
   published widths and depths in bf16, params made on the card from the
   seed (``repro_torch.models.transformer`` through the cells' steps):
   granite-moe-1b-a400m (GQA, 32 experts top-8, a padded vocab) prefills
   ``LM_PREFILL`` (two prefills bit-identical; layer 0 split by CUDA events
   into attention, MoE and the rest; the attention timed against
   ``scaled_dot_product_attention`` at the same shapes, timed only) and
   decodes ``LM_DECODE_STEPS`` steps on the ``decode_32k`` cell's zero
   cache at ``pos = seq // 2`` (one step under
   ``set_sync_debug_mode("error")``; only the decoded positions written);
   deepseek-7b decodes token 1,024 on its prefill's cache, held against a
   prefill over 1,025 tokens within ``LM_CONSIST_REL`` of max |logits|
   (bf16); then both cut to 2 layers in f32, on the card against the CPU
   on the same params and prompt (``LM_CPU_REL``; the MoE's gate_idx equal
   but at near-ties).  It prints prefill tokens/s, decode ms a step and
   tokens/s, peak memory, and reaches no kernel of the table.
   An eleventh, ``gnn``, trains gat-cora's four cells at their published
   shapes through the cell's step (AdamW ``OPT``; GNN_WARM + GNN_TIMED
   steps each, f32): ``full_graph_sm`` (Cora: 2,708 nodes, 10,556 edges,
   1,433 features), ``molecule`` (128 graphs of 30 nodes, the mean
   readout), ``minibatch_lg`` (1,024 targets sampled 15-10 by
   ``minibatch_stream`` over ``CSRGraph.random`` of its 169,984 node
   slots) and ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, 100
   features, drawn from the seed as the reference's smoke inputs draw a
   full graph).  Every step must be finite and every leaf move in step 1;
   step 1's loss and ``grad_norm`` must equal the CPU path's (but
   ogb_products') within 1e-5 and 1e-4 relative; two forwards must give
   the same bits (the sorted edges and ``segment_reduce``'s order); the
   minibatch_lg stream restarts bit for bit under deterministic
   algorithms.  It prints each cell's step p50, the forward / backward /
   AdamW split, the peak and the seconds to make its graph and batch.
   A twelfth, ``lm_train``, trains granite-moe-1b-a400m's ``train_4k``
   cell at its full ``CONFIG`` (24 layers, bf16 params, f32 AdamW state,
   the nested remat: each layer and each KV chunk checkpointed) on
   ``LM_TRAIN_BATCH`` sequences of 4,096 tokens (what 80 GB holds), 1
   warm-up and 3 timed steps: step p50, tokens/s, the split, the peak.
   Then at 2 layers and full width: the first step in f32 on the card
   against the CPU (1e-5 / 1e-4), remat on against off (the loss equal,
   the remat's peak lower) and a restart bit-identical under
   deterministic algorithms.  Neither part reaches a kernel of the table.
   The launch counts are reset before each path and read after it, and
   every kernel of the path must have launched (the ``lm``, ``gnn`` and
   ``lm_train`` paths none).
   The index cells: each of the six index cells' ``step_fn`` (spfresh-1b's
   five and two-tower's ``retrieval_cand_ann``, taken through
   ``configs.get_cell``) runs once on one shard, on a state a path already
   holds: ``serve_search``, ``serve_search_paged`` and ``serve_update`` on
   the ``fp32`` path's final state, ``maintain`` on the ``update`` path's
   (under deterministic algorithms), ``serve_search_grouped`` on the
   ``grouped`` path's 512 × 256 group index, ``retrieval_cand_ann`` on one
   user in the ``retrieval`` path.  Each output tensor must equal the call
   the step wraps bit for bit (``lire.search``, ``lire.insert_batch``,
   ``lire.maintenance_round``, ``search_grouped``, the retriever's tower
   and ``IndexedRetriever.retrieve``; a one-shard handle is the vid), and
   each cell's launches are counted (``serve_search_paged`` must launch
   #6).  After the last part an empty ``CONFIG`` state is allocated on the
   card: its ``memory_allocated`` delta must equal the dry run's ``meta``
   count of one shard's state (each leaf in 512-byte allocator blocks), and
   the dry run's ``card`` records of the six cells are printed on one
   ``dryrun:`` line.
4. Prints the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside this file.  The full report is printed as
one ``report:`` JSON line before the kernels line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
# and dense TF32 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# Vectors the main path builds from: a quarter of the ~2M live vectors the
# spfresh-1b shard is sized for (at 2M the build's posting count nears
# num_postings_cap and the host-driven build would dominate the run).  Cut
# from 1,000,000 with the gnn and lm_train paths, for the smoke's time
# budget: fp32's build took 70-112 s there.  A search is no slower at
# 500,000 (scripts/search_p50_on_card.py; PERF.md section 5).
N_BASE = 500_000
# searches timed for each schedule's p50: the first searches after a build
# that follows a large free can take 2-3x as long on the host
SEARCH_P50_REPS = 21

# Recall@10 of the JAX reference on the same generator at N=20,000 on the
# CPU, by codec cell and nprobe (scripts/reference_recall.py); the port
# must reach each minus 0.05.  The generator's neighbourhoods are far
# apart, so recall is near 1 from nprobe 1 on: nprobe=1 holds the first
# probe of every query, and check_navigation holds all 64.
REFERENCE_RECALL_20K = {
    "fp32": {1: 0.98994140625, 64: 0.9981445312499999},
    "int8": {1: 0.99169921875, 64: 1.0},
}
RECALL_MARGIN = 0.05

# The kernel table's numbering (PERF.md): #1 .. #7.
KERNEL_ORDER = ("l2_topk_tiles", "scan_per_query", "scan_batched", "scan_per_query_topk",
                "scan_per_query_topk_q8", "scan_batched_topk", "scan_batched_topk_q8")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(text):
    """``[(function, registers, spill bytes)]`` of an ``nvcc -Xptxas -v``
    log, one per entry function, names demangled where ``c++filt`` is
    installed and cut to the function and its template arguments."""
    found, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            found.append([name, int(m.group(1)), spill])
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(e[0] for e in found),
                             capture_output=True, text=True, timeout=60, check=True)
        names = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(found):
        for e, n in zip(found, names):
            e[0] = n.split(">(")[0].replace("void (anonymous namespace)::", "") + (
                ">" if ">(" in n else "")
    return [tuple(e) for e in found]


class Fail(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Fail(what)


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean time of ``reps`` back-to-back launches between two CUDA events,
    after ``warm`` launches.  The host enqueues ahead of the card, so a
    wrapper's host work is not counted while one call keeps the card busy
    longer than the host takes to issue the next."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# Kernel vs plain tolerance on a live distance d: ATOL + RTOL * |d|.  The
# two sum the same f32 products in another order; at byte-scale distances
# (|d| ~ 1e5-1e6, one ulp 0.0078-0.0625) the relative term dominates.
RTOL = 1e-5
TOL_TEXT = f"tol=atol+{RTOL:g}*|d|"


def compare_kmin(kd, ki, pd, pi, *, rtol=RTOL, atol=1e-3, big=3.0e38):
    """Kernel ``(kd, ki)`` vs plain ``(pd, pi)``: live distances within
    ``atol + rtol*|d|``, dead in both, index mismatches only at distance
    ties.  Returns the max abs error over live candidates and the count
    of tie swaps."""
    import torch

    live = pd < big / 2
    check(bool(torch.equal(live, kd < big / 2)), "live/dead candidates differ")
    err = (kd - pd).abs()
    tol = atol + rtol * pd.abs()
    max_err = float(err[live].max()) if bool(live.any()) else 0.0
    check(bool((err[live] <= tol[live]).all()),
          f"distance mismatch beyond tolerance (max abs err {max_err})")
    swap = (ki != pi) & live
    check(bool((err[swap] <= tol[swap]).all()), "index mismatch that is not a tie")
    return max_err, int(swap.sum())


def bound(bytes_moved: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def tf32_passes(payload_dtype) -> int:
    """Split-TF32 products the tensor-core kernels take: q_hi.b + q_lo.b
    where TF32 holds the payload exactly (int8, bf16), three with b split
    too (f32)."""
    import torch

    return 3 if payload_dtype == torch.float32 else 2


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def phase_l2_topk(torch, gen, results):
    from repro_torch.kernels.l2_topk import kernel as K

    dev = "cuda"
    # spfresh-1b search navigation: Q=1024, P=65,536, d=100, k=nprobe=64
    q_n, p_n, d, k, block_p = 1024, 65_536, 100, 64, 512
    q = torch.randn(q_n, d, device=dev, generator=gen) * 32
    c = torch.round(torch.randn(p_n, d, device=dev, generator=gen) * 32)
    csq = torch.sum(c * c, dim=1)
    csq[torch.rand(p_n, device=dev, generator=gen) < 0.2] = 3.0e38
    csq = csq[None].contiguous()
    kd, ki = K.l2_topk_tiles(q, c, csq, k=k, block_p=block_p)
    torch.cuda.synchronize()
    pd, pi = K.l2_topk_tiles_plain(q, c, csq, k=k, block_p=block_p)
    err, swaps = compare_kmin(kd, ki, pd, pi)
    ms = cuda_ms(lambda: K.l2_topk_tiles(q, c, csq, k=k, block_p=block_p))
    plain_ms = cuda_ms(lambda: K.l2_topk_tiles_plain(q, c, csq, k=k, block_p=block_p), reps=3)
    lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, c), k, largest=False), reps=3)
    t = p_n // block_p
    by = 4 * (q_n * d + p_n * d + p_n) + 8 * q_n * t * k
    b_ms, b_by = bound(by, 2.0 * q_n * p_n * d)
    # the kernel's three split-TF32 passes on the tensor cores
    tc_ms, tc_by = bound(by, 3 * 2.0 * q_n * p_n * d, TF32_FLOP_PER_S)
    # tie-heavy at the full shape: 20 distinct centroids repeated, so every
    # 512-column tile holds each distance 25 or 26 times and the k-th value
    # is shared by more columns than are kept.  The distinct ones lie 1000
    # apart on axis 0, so their distances differ by ~1e6 and duplicates are
    # bit-equal: a correct kernel keeps the plain version's columns (the
    # lowest of each tie) index for index
    g = torch.arange(p_n, device=dev) % 20
    c_tie = c[g].contiguous()
    c_tie[:, 0] += 1000.0 * g
    s_tie = torch.sum(c_tie * c_tie, dim=1)[None].contiguous()
    a = K.l2_topk_tiles(q, c_tie, s_tie, k=k, block_p=block_p)
    torch.cuda.synchronize()
    e2, tie_swaps = compare_kmin(*a, *K.l2_topk_tiles_plain(q, c_tie, s_tie, k=k, block_p=block_p))
    check(tie_swaps == 0, f"{tie_swaps} candidates of the tie-heavy input are not the "
          "lowest columns of their tie")
    err = max(err, e2)
    del g, c_tie, s_tie, a
    # ragged small shapes: Q not a multiple of the 32-row tile, invalid
    # centroids, a 128-wide tile; then distances below zero (unit scale,
    # c_sqn lowered by 0.5, each query next to one centroid)
    for (qs, ps, bp, kk, neg) in ((37, 1024, 512, 64, False), (5, 384, 128, 5, False),
                                  (64, 2048, 256, 16, True)):
        q2 = torch.randn(qs, 16, device=dev, generator=gen)
        c2 = torch.randn(ps, 16, device=dev, generator=gen)
        s2 = torch.sum(c2 * c2, dim=1)
        if neg:
            q2 = c2[torch.randint(0, ps, (qs,), device=dev, generator=gen)] + 0.01 * q2
            s2 = s2 - 0.5
        else:
            s2[::3] = 3.0e38
        s2 = s2[None].contiguous()
        a = K.l2_topk_tiles(q2, c2, s2, k=kk, block_p=bp)
        torch.cuda.synchronize()
        e2, _ = compare_kmin(*a, *K.l2_topk_tiles_plain(q2, c2, s2, k=kk, block_p=bp), atol=1e-4)
        check(not neg or bool((a[0].min(dim=1).values < 0).all()), "no negative distance kept")
        err = max(err, e2)
    log(f"l2_topk_tiles: max_abs_err={err:.3g} ({TOL_TEXT}, atol 1e-3 / 1e-4 ragged) "
        f"tie_swaps={swaps} (tie-heavy input: {tie_swaps}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (topk(cdist), two calls) "
        f"bound_ms={b_ms:.4f} ({b_by}) tensor_core_bound_ms={tc_ms:.4f} "
        f"({tc_by}, 3 TF32 passes)")
    results["l2_topk_tiles"] = dict(
        name="l2_topk_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/l2_topk.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:60",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, tensor_core_bound_ms=tc_ms,
    )


def _pool(torch, gen, n_blocks, bs, d, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n_blocks, bs, d), device="cuda",
                             generator=gen, dtype=torch.int8)
    return (torch.randn(n_blocks, bs, d, device="cuda", generator=gen) * 4).to(dtype)


def _page_sz(torch, gen, lead):
    """Per-page (scale, zero) of byte-valued postings: ranges of ~64-128
    byte units over 254 levels, centres within a few dozen units."""
    scale = 0.25 + 0.25 * torch.rand(*lead, device="cuda", generator=gen)
    zero = 20.0 * torch.randn(*lead, device="cuda", generator=gen)
    return torch.stack([scale, zero], dim=-1).contiguous()


def compare_dense(kd, pd, *, rtol=RTOL, atol=1e-2):
    """Kernel vs plain full distances within ``atol + rtol*|d|``; returns
    the max abs error."""
    err = (kd - pd).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(bool((err <= atol + rtol * pd.abs()).all()),
          f"distance mismatch beyond tolerance (max abs err {max_err})")
    return max_err


# The library yardsticks: the shortest composition of PyTorch calls for
# each scan's function (page gather, [dequant,] cdist squared, [bias,
# top-k]).  Timed here only; the port never calls them.
LIB_TEXT = {
    "scan_per_query": "gather + cdist^2",
    "scan_batched": "gather + cdist^2",
    "scan_per_query_topk": "gather + cdist^2 + bias + topk",
    "scan_batched_topk": "gather + cdist^2 + bias + topk",
    "scan_per_query_topk_q8": "gather + dequant + cdist^2 + bias + topk",
    "scan_batched_topk_q8": "gather + dequant + cdist^2 + bias + topk",
}


def lib_per_query(torch, table, q, blocks, bias=None, page_sz=None, k=None):
    """``(Q, NB, BS)`` distances, or their per-page k-min with ``bias``."""
    q_n, nb = table.shape
    _, bs, d = blocks.shape
    pages = blocks[table.long()].float()                  # (Q, NB, BS, d)
    if page_sz is not None:
        pages = pages * page_sz[..., 0, None, None] + page_sz[..., 1, None, None]
    dist = torch.cdist(q[:, None, :], pages.reshape(q_n, nb * bs, d)).square_()
    dist = dist.reshape(q_n, nb, bs)
    if bias is None:
        return dist
    return torch.topk(dist + bias, k, dim=-1, largest=False)


def lib_batched(torch, ids, q, blocks, bias=None, page_sz=None, k=None):
    """``(Q, NB, BS)`` distances (the kernel's ``(NB, Q, BS)`` transposed),
    or the per-(page, query) k-min with ``bias``: one 2-D cdist keeps the
    k-min on the contiguous last axis."""
    nb = ids.shape[0]
    _, bs, d = blocks.shape
    pages = blocks[ids.long()].float()                     # (NB, BS, d)
    if page_sz is not None:
        pages = pages * page_sz[:, 0, None, None] + page_sz[:, 1, None, None]
    dist = torch.cdist(q, pages.reshape(nb * bs, d)).square_().reshape(-1, nb, bs)
    if bias is None:
        return dist
    return torch.topk(dist + bias, k, dim=-1, largest=False)


def check_library(torch, got, want, what):
    """A library yardstick computes its kernel's function: values within
    1e-4 relative (cdist's square root, squared back, costs ~1e-6)."""
    check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-2)),
          f"the library composition for {what} disagrees with the plain version")


def _result(name, replaces, err, ms, plain_ms, lib_ms, b, source="posting_scan.cu"):
    return dict(
        name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
        replaces=f"src/repro/kernels/posting_scan/kernel.py:{replaces}",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
        library_ms=lib_ms,
    )


def _log_kernel(name, err, swaps, ms, plain_ms, lib_ms, b, extra="", tail=""):
    log(f"{name}: max_abs_err={err:.3g} ({TOL_TEXT}, atol 1e-2) tie_swaps={swaps} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}{extra} library_ms={lib_ms:.4f} "
        f"({LIB_TEXT[name]}) bound_ms={b[0]:.4f} ({b[1]}){tail}")


# spfresh-1b scan shapes: per_query Q=1024 x NB=nprobe*MB=256 pages of
# BS=32 slots at d=100 over a 262,144-block int8 pool; batched NB =
# scan_page_budget = 32,768 unique pages against Q=1024.  k = min(10, BS)
# for the fp32 and bf16 codecs, min(10*4, BS) = 32 for int8 with rerank.
PQ = dict(q_n=1024, nb=256, bs=32, d=100, n_blocks=262_144)
BATCHED_NB = 32_768
# distinct pages one Q=1024 search probes on the main path (PERF.md §4):
# the rest of the batched budget is padding
MAIN_PATH_PAGES = 10_393
# ... and in a 1,024-row batch of the spacev.search_sat cells at N=250,000
# (the benchmark's unique_pages.sat on an H100, PERF.md)
SEARCH_SAT_PAGES = 27_700
# share of a query's NB = 256 probe rows that hold a page (postings of
# fewer than MB blocks leave the rest -1)
PROBE_ROWS_HELD = 0.7
PLAIN_STEP = 2048      # pages per chunk of a batched plain version


def _per_query_inputs(torch, gen, blocks):
    q_n, nb, bs, d = PQ["q_n"], PQ["nb"], PQ["bs"], PQ["d"]
    q = torch.randn(q_n, d, device="cuda", generator=gen) * 32
    table = torch.randint(0, blocks.shape[0], (q_n, nb), device="cuda", generator=gen,
                          dtype=torch.int32)
    bias = torch.where(torch.rand(q_n, nb, bs, device="cuda", generator=gen) < 0.2,
                       3.0e38, 0.0).contiguous()
    bias[:, -1] = 3.0e38                                  # all-dead pages
    return q, table, bias


def _batched_inputs(torch, gen, blocks):
    nb, bs, d = BATCHED_NB, PQ["bs"], PQ["d"]
    ids = torch.sort(torch.randperm(blocks.shape[0], device="cuda", generator=gen)[:nb]).values
    ids = ids.to(torch.int32).contiguous()
    q = torch.randn(PQ["q_n"], d, device="cuda", generator=gen) * 32
    bias = torch.where(torch.rand(nb, bs, device="cuda", generator=gen) < 0.2, 3.0e38, 0.0)
    bias[-7:] = 3.0e38                                    # all-dead pages
    return ids, q, bias.contiguous()


def phase_scan_per_query(torch, gen, results):
    """#4 ``scan_per_query_topk`` at k=10 (fp32/bf16 codecs)."""
    from repro_torch.kernels.posting_scan import kernel as K

    q_n, nb, bs, d, k = PQ["q_n"], PQ["nb"], PQ["bs"], PQ["d"], 10
    blocks = _pool(torch, gen, PQ["n_blocks"], bs, d, torch.int8)
    q, table, bias = _per_query_inputs(torch, gen, blocks)
    kd, ki = K.scan_per_query_topk(table, q, blocks, bias, k=k)
    torch.cuda.synchronize()
    pd, pi = K.scan_per_query_topk_plain(table, q, blocks, bias, k=k)
    err, swaps = compare_kmin(kd, ki, pd, pi, atol=1e-2)
    del pd, pi
    ms = cuda_ms(lambda: K.scan_per_query_topk(table, q, blocks, bias, k=k))
    plain_ms = cuda_ms(lambda: K.scan_per_query_topk_plain(table, q, blocks, bias, k=k), reps=3)
    lib_ms = cuda_ms(lambda: lib_per_query(torch, table, q, blocks, bias, k=k), reps=3)
    uniq = int(torch.unique(table).numel())
    side = 4 * (table.numel() + q.numel() + bias.numel()) + 8 * q_n * nb * k
    b = bound(uniq * bs * d + side, 2.0 * q_n * nb * bs * d)
    pp = bound(q_n * nb * bs * d + side, 2.0 * q_n * nb * bs * d)
    # ragged small, and rows of an even number of 4-value units (d = 128:
    # padded in the kernel's ring) or pages not a multiple of 16 bytes
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for bs2, d2, k2 in ((32, 100, 10), (32, 128, 10), (7, 4, 3)):
            blk = _pool(torch, gen, 40, bs2, d2, dtype)
            q2 = torch.randn(5, d2, device="cuda", generator=gen)
            t2 = torch.randint(0, 40, (5, 7), device="cuda", generator=gen, dtype=torch.int32)
            b2 = torch.where(torch.rand(5, 7, bs2, device="cuda", generator=gen) < 0.3, 3.0e38, 0.0)
            b2[0, 0] = 3.0e38
            a = K.scan_per_query_topk(t2, q2, blk, b2, k=k2)
            torch.cuda.synchronize()
            e2, _ = compare_kmin(*a, *K.scan_per_query_topk_plain(t2, q2, blk, b2, k=k2), atol=1e-2)
            err = max(err, e2)
    _log_kernel("scan_per_query_topk", err, swaps, ms, plain_ms, lib_ms, b,
                f" unique_pages={uniq}", f" per_probe_bound_ms={pp[0]:.4f} ({pp[1]})")
    results["scan_per_query_topk"] = _result("scan_per_query_topk", 164, err, ms,
                                             plain_ms, lib_ms, b)
    results["scan_per_query_topk"]["per_probe_bound_ms"] = pp[0]
    results["scan_per_query_topk"]["main_mix"] = _per_query_main_mix(torch, gen, blocks, q, k)
    return blocks


def _per_query_main_mix(torch, gen, blocks, q, k, *, q8=False):
    """#4 (or, with ``q8``, #5 with per-pair (scale, zero) from
    ``_page_sz``) on the main path's page mix: a (Q, NB) table whose
    probes each hold two real pages and two absent ones (-1, clamped to
    page 0 with an all-+BIG bias, as ``ops.scan_posting_blocks_topk``
    builds them), 131,072 live entries (the main path's 131,962) drawn from
    ``MAIN_PATH_PAGES`` distinct pages.  Every dead pair must be exactly
    (BIG, slots 0..k-1).  The bound counts what these inputs need: each
    distinct live page once (they fit in L2), the product over the live
    pairs, every candidate written; the per-probe bound reads a live
    pair's page once per probe."""
    from repro_torch.kernels.posting_scan import kernel as K
    from repro_torch.kernels.posting_scan import ops

    name = "scan_per_query_topk_q8" if q8 else "scan_per_query_topk"
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    q_n, nb, bs, d = PQ["q_n"], PQ["nb"], PQ["bs"], PQ["d"]
    real = torch.randperm(blocks.shape[0], device="cuda", generator=gen)[:MAIN_PATH_PAGES]
    pages = real[torch.randint(0, MAIN_PATH_PAGES, (q_n, nb), device="cuda", generator=gen)]
    probe_slot = torch.arange(nb, device="cuda") % 4
    pages = torch.where((probe_slot < 2)[None, :], pages, -1).to(torch.int32)
    slot_live = torch.rand(q_n, nb, bs, device="cuda", generator=gen) >= 0.2
    table, bias = ops._clamped(pages), ops._per_query_bias(pages, slot_live)
    sz = (_page_sz(torch, gen, (q_n, nb)),) if q8 else ()
    kd, ki = kernel(table, q, blocks, bias, *sz, k=k)
    torch.cuda.synchronize()
    cut = slice(0, 128)                                   # plain on 128 queries
    pd, pi = plain(table[cut].contiguous(), q[cut].contiguous(), blocks, bias[cut].contiguous(),
                   *(x[cut].contiguous() for x in sz), k=k)
    err, _ = compare_kmin(kd[cut], ki[cut], pd, pi, atol=1e-2)
    dead = pages < 0
    slots = torch.arange(k, dtype=torch.int32, device="cuda")
    check(bool((kd[dead] == 3.0e38).all()) and bool((ki[dead] == slots).all()),
          f"{name}: a dead pair's candidates are not (BIG, slots 0..k-1)")
    live_n = int((~dead).sum())
    uniq = int(torch.unique(pages[~dead]).numel())
    del kd, ki, pd, pi
    ms = cuda_ms(lambda: kernel(table, q, blocks, bias, *sz, k=k))
    side = (4 * (table.numel() + q.numel() + bias.numel() + sum(x.numel() for x in sz))
            + 8 * q_n * nb * k)
    flops = 2.0 * live_n * bs * d
    b = bound(uniq * bs * d + side, flops)
    pp = bound(live_n * bs * d + side, flops)
    log(f"{name} (main path mix: {live_n} live of {q_n * nb} pairs on {uniq} distinct pages, "
        f"k={k}): ms={ms:.4f} max_abs_err={err:.3g} bound_ms={b[0]:.4f} ({b[1]}; each live page "
        f"once, the product over the live pairs, every candidate written) "
        f"per_probe_bound_ms={pp[0]:.4f} ({pp[1]}); dead pairs exactly (BIG, slots 0..{k - 1})")
    return dict(live_pairs=live_n, live_pages=uniq, ms=ms, max_abs_err=err, bound_ms=b[0],
                bound_by=b[1], per_probe_bound_ms=pp[0], per_probe_bound_by=pp[1])


def phase_scan_batched(torch, gen, results, blocks):
    """#6 ``scan_batched_topk`` at k=10 over the full page budget."""
    from repro_torch.kernels.posting_scan import kernel as K

    q_n, nb, bs, d, k = PQ["q_n"], BATCHED_NB, PQ["bs"], PQ["d"], 10
    ids, q, bias = _batched_inputs(torch, gen, blocks)
    kd, ki = K.scan_batched_topk(ids, q, blocks, bias, k=k)
    torch.cuda.synchronize()
    err, swaps = 0.0, 0
    step = PLAIN_STEP
    for s in range(0, nb, step):                          # plain, page chunks
        pd, pi = K.scan_batched_topk_plain(ids[s:s + step], q, blocks, bias[s:s + step], k=k)
        e, w = compare_kmin(kd[s:s + step], ki[s:s + step], pd, pi, atol=1e-2)
        err, swaps = max(err, e), swaps + w
    torch.cuda.synchronize()
    del kd, ki, pd, pi

    def plain_all():
        for s in range(0, nb, step):
            K.scan_batched_topk_plain(ids[s:s + step], q, blocks, bias[s:s + step], k=k)

    ms = cuda_ms(lambda: K.scan_batched_topk(ids, q, blocks, bias, k=k), reps=5)
    plain_ms = cuda_ms(plain_all, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: lib_batched(torch, ids, q, blocks, bias, k=k), reps=1, warm=1)
    by = nb * bs * d + 4 * (nb + q.numel() + bias.numel()) + 8 * nb * q_n * k
    flops = 2.0 * nb * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):     # ragged small
        blk = _pool(torch, gen, 40, 32, 100, dtype)
        q2 = torch.randn(13, 100, device="cuda", generator=gen)
        u2 = torch.arange(0, 40, 4, device="cuda", dtype=torch.int32)[:9].contiguous()
        b2 = torch.where(torch.rand(9, 32, device="cuda", generator=gen) < 0.3, 3.0e38, 0.0)
        b2[0] = 3.0e38
        a = K.scan_batched_topk(u2, q2, blk, b2, k=10)
        torch.cuda.synchronize()
        e2, _ = compare_kmin(*a, *K.scan_batched_topk_plain(u2, q2, blk, b2, k=10), atol=1e-2)
        err = max(err, e2)
    _log_kernel("scan_batched_topk", err, swaps, ms, plain_ms, lib_ms, b,
                f" (page chunks of {step})",
                f" tensor_core_bound_ms={tc[0]:.4f} ({tc[1]}, {passes} TF32 passes)")
    results["scan_batched_topk"] = _result("scan_batched_topk", 288, err, ms,
                                           plain_ms, lib_ms, b, source="scan_batched_topk.cu")
    results["scan_batched_topk"]["tensor_core_bound_ms"] = tc[0]
    results["scan_batched_topk"]["main_mix"] = _batched_main_mix(torch, gen, blocks, q, k)
    results["scan_batched_topk"]["pairs"] = {
        str(n): _batched_pairs_mix(torch, gen, blocks, q, k, n)
        for n in (MAIN_PATH_PAGES, SEARCH_SAT_PAGES)}


def _batched_main_mix(torch, gen, blocks, q, k, *, q8=False):
    """#6 (or, with ``q8``, #7 with per-page (scale, zero) from
    ``_page_sz``) on the main path's page mix: the 32,768-row budget holds
    ``MAIN_PATH_PAGES`` real rows, the rest -1, clamped to page 0 with a
    +BIG bias, as ``ops.scan_unique_blocks_topk`` builds them.  The bound
    counts what these inputs need: the product over the live pages only,
    and every candidate written."""
    from repro_torch.kernels.posting_scan import kernel as K
    from repro_torch.kernels.posting_scan import ops

    name = "scan_batched_topk_q8" if q8 else "scan_batched_topk"
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    nb, bs, d, live_n = BATCHED_NB, PQ["bs"], PQ["d"], MAIN_PATH_PAGES
    real = torch.sort(torch.randperm(blocks.shape[0], device="cuda", generator=gen)[:live_n]).values
    uniq = torch.full((nb,), -1, dtype=torch.int32, device="cuda")
    uniq[:live_n] = real.to(torch.int32)
    slot_live = torch.rand(nb, bs, device="cuda", generator=gen) >= 0.2
    ids, bias = ops._clamped(uniq), ops._batched_bias(uniq, slot_live)
    sz = (_page_sz(torch, gen, (nb,)),) if q8 else ()
    kd, ki = kernel(ids, q, blocks, bias, *sz, k=k)
    torch.cuda.synchronize()
    s = live_n - PLAIN_STEP // 2                          # across the live/padding edge
    cut = slice(s, s + PLAIN_STEP)
    pd, pi = plain(ids[cut], q, blocks, bias[cut], *(x[cut] for x in sz), k=k)
    err, _ = compare_kmin(kd[cut], ki[cut], pd, pi, atol=1e-2)
    slots = torch.arange(k, dtype=torch.int32, device="cuda")
    check(bool((kd[live_n:] == 3.0e38).all()) and bool((ki[live_n:] == slots).all()),
          f"{name}: a padding row's candidates are not (BIG, slots 0..k-1)")
    del kd, ki, pd, pi
    ms = cuda_ms(lambda: kernel(ids, q, blocks, bias, *sz, k=k), reps=5)
    q_n = q.shape[0]
    by = (live_n * bs * d + 4 * (nb + q.numel() + bias.numel() + sum(x.numel() for x in sz))
          + 8 * nb * q_n * k)
    flops = 2.0 * live_n * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    log(f"{name} (main path mix: {live_n} live of {nb} rows, k={k}): ms={ms:.4f} "
        f"max_abs_err={err:.3g} bound_ms={b[0]:.4f} ({b[1]}; the product over the live "
        f"pages, every candidate written) tensor_core_bound_ms={tc[0]:.4f} "
        f"({tc[1]}, {passes} TF32 passes); padding rows exactly (BIG, slots 0..{k - 1})")
    return dict(live_pages=live_n, ms=ms, max_abs_err=err, bound_ms=b[0], bound_by=b[1],
                tensor_core_bound_ms=tc[0], tensor_core_bound_by=tc[1])


def _batched_pairs_mix(torch, gen, blocks, q, k, live_n, *, q8=False):
    """#6 (or #7) in its pairs form beside the full form, on a budget of
    ``BATCHED_NB`` rows holding ``live_n`` real pages: each query's NB = 256
    probe rows name distinct pages of them, ``PROBE_ROWS_HELD`` of the rows
    held (the rest -1), as the search's ``member_pos``.  The pairs form must
    equal the full form gathered through ``member_pos`` bit for bit, and on
    the last ``PLAIN_STEP`` live pages the plain version gathered the same
    way; both forms are timed (the pairs form with its output fill), and
    the inverse map ``page_positions``.  The pairs form's bound counts the live pages once, the product over them,
    the int16 ``page_pos`` read and one store of the ``(Q, NB, k)``
    output.  The selected share is the probed pairs over ``live_n x Q``."""
    from repro_torch.kernels.posting_scan import kernel as K
    from repro_torch.kernels.posting_scan import ops, ref

    name = "scan_batched_topk_q8" if q8 else "scan_batched_topk"
    full_fn, pairs_fn = getattr(K, name), getattr(K, name + "_pairs")
    plain = getattr(K, name + "_plain")
    nb, bs, nbq, q_n = BATCHED_NB, PQ["bs"], PQ["nb"], q.shape[0]
    real = torch.sort(torch.randperm(blocks.shape[0], device="cuda", generator=gen)[:live_n]).values
    uniq = torch.full((nb,), -1, dtype=torch.int32, device="cuda")
    uniq[:live_n] = real.to(torch.int32)
    slot_live = torch.rand(nb, bs, device="cuda", generator=gen) >= 0.2
    ids, bias = ops._clamped(uniq), ops._batched_bias(uniq, slot_live)
    sz = (_page_sz(torch, gen, (nb,)),) if q8 else ()
    keys = torch.rand(q_n, live_n, device="cuda", generator=gen)
    member_pos = torch.topk(keys, nbq, dim=1).indices.to(torch.int32)   # distinct a row
    member_pos[torch.rand(q_n, nbq, device="cuda", generator=gen) >= PROBE_ROWS_HELD] = -1
    del keys
    page_pos = ops.page_positions(member_pos, nb)
    got = pairs_fn(ids, q, blocks, bias, *sz, page_pos, nbq=nbq, k=k)
    want = ref.gather_pairs(*full_fn(ids, q, blocks, bias, *sz, k=k), member_pos)
    check(bool(torch.equal(got[0], want[0])) and bool(torch.equal(got[1], want[1])),
          f"{name}_pairs differs from {name} gathered through member_pos ({live_n} live pages)")
    del want
    s = live_n - PLAIN_STEP                               # the last live pages
    cut = slice(s, s + PLAIN_STEP)
    in_cut = (member_pos >= s) & (member_pos < s + PLAIN_STEP)
    mp_cut = torch.where(in_cut, member_pos - s, -1)
    args = (ids[cut], q, blocks, bias[cut], *(x[cut] for x in sz))
    kd, ki = got[0][in_cut], got[1][in_cut]
    pd, pi = ref.gather_pairs(*plain(*args, k=k), mp_cut)
    err, _ = compare_kmin(kd, ki, pd[in_cut], pi[in_cut], atol=1e-2)
    # every kept slot carries its own distance (a tie swap cannot hide a wrong slot)
    ad, ai = plain(*args, k=bs)
    by_slot = ref.gather_pairs(torch.empty_like(ad).scatter_(2, ai.long(), ad), ai, mp_cut)[0]
    own = torch.gather(by_slot[in_cut], 1, ki.long().clamp(min=0))
    kept = kd < 3.0e38 / 2
    check(bool(((own - kd).abs() <= 1e-2 + RTOL * kd.abs())[kept].all()),
          f"{name}_pairs: a kept slot's distance is not its own ({live_n} live pages)")
    n_pairs, n_cut = int((member_pos >= 0).sum()), int(in_cut.sum())
    del got, kd, ki, pd, pi, ad, ai, by_slot, own
    full_ms = cuda_ms(lambda: full_fn(ids, q, blocks, bias, *sz, k=k), reps=5)
    pairs_ms = cuda_ms(lambda: pairs_fn(ids, q, blocks, bias, *sz, page_pos, nbq=nbq, k=k),
                       reps=5)
    pos_ms = cuda_ms(lambda: ops.page_positions(member_pos, nb), reps=5)
    d = q.shape[1]
    by = (live_n * bs * d + 4 * (nb + q.numel() + bias.numel() + sum(x.numel() for x in sz))
          + 2 * page_pos.numel() + 8 * q_n * nbq * k)
    flops = 2.0 * live_n * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    share = n_pairs / (live_n * q_n)
    log(f"{name}_pairs ({live_n} live of {nb} rows, Q={q_n}, NB={nbq}, k={k}): "
        f"pairs ms={pairs_ms:.4f} against full ms={full_ms:.4f} ({full_ms / pairs_ms:.2f}x); "
        f"bound_ms={b[0]:.4f} ({b[1]}) tensor_core_bound_ms={tc[0]:.4f} ({tc[1]}, {passes} "
        f"TF32 passes); page_positions ms={pos_ms:.4f}; {n_pairs} probed pairs, selected share "
        f"{100 * share:.3f}% of live pages x Q; bit-equal to the full form gathered; "
        f"max_abs_err={err:.3g} against plain on {n_cut} pairs of {PLAIN_STEP} pages")
    return dict(live_pages=live_n, n_pairs=n_pairs, selected_share=share, pairs_ms=pairs_ms,
                full_ms=full_ms, page_positions_ms=pos_ms, max_abs_err=err, bound_ms=b[0],
                bound_by=b[1], tensor_core_bound_ms=tc[0], tensor_core_bound_by=tc[1])


def _q8_tie_swaps(torch, gen, q_n, bs, d):
    """#7 at k = BS on tie-heavy pages: slot j of every page repeats code
    row j % 4, the four rows 30 code units apart on column 0, and 20% of
    the slots dead.  Integer-valued queries, scales 0.5 or 1 and integer
    zeros keep every distance exact in f32 in the kernel (the product is
    on the codes) and in the plain version, so equal distances are
    bit-equal and distinct ones differ by at least 1/4: the kernel must
    keep the plain version's slots, lowest first among ties.  Returns
    ``(tie_swaps, max_abs_err)`` over 2 x PLAIN_STEP pages."""
    from repro_torch.kernels.posting_scan import kernel as K

    nb, k = 2 * PLAIN_STEP, bs
    base = torch.randint(-60, 61, (512, 4, d), device="cuda", generator=gen, dtype=torch.int8)
    base[:, :, 0] = (torch.arange(4, device="cuda") * 30 - 45).to(torch.int8)[None, :]
    pool = base[:, torch.arange(bs, device="cuda") % 4].contiguous()
    ids = torch.randint(0, 512, (nb,), device="cuda", generator=gen, dtype=torch.int32)
    q = torch.round(torch.randn(q_n, d, device="cuda", generator=gen) * 8)
    bias = torch.where(torch.rand(nb, bs, device="cuda", generator=gen) < 0.2, 3.0e38, 0.0)
    scale = torch.tensor([0.5, 1.0], device="cuda")[
        torch.randint(0, 2, (nb,), device="cuda", generator=gen)]
    zero = torch.randint(-10, 11, (nb,), device="cuda", generator=gen).float()
    sz = torch.stack([scale, zero], dim=-1).contiguous()
    kd, ki = K.scan_batched_topk_q8(ids, q, pool, bias, sz, k=k)
    torch.cuda.synchronize()
    err, swaps = 0.0, 0
    for s in range(0, nb, PLAIN_STEP):
        cut = slice(s, s + PLAIN_STEP)
        pd, pi = K.scan_batched_topk_q8_plain(ids[cut], q, pool, bias[cut], sz[cut], k=k)
        e, w = compare_kmin(kd[cut], ki[cut], pd, pi, atol=1e-2)
        err, swaps = max(err, e), swaps + w
    return swaps, err


def phase_scan_unreduced(torch, gen, results, blocks):
    """#2 ``scan_per_query`` and #3 ``scan_batched``: every slot's distance,
    no bias, no k-min, at the spfresh-1b scan shapes over the int8 pool."""
    from repro_torch.kernels.posting_scan import kernel as K

    q_n, nb, bs, d = PQ["q_n"], PQ["nb"], PQ["bs"], PQ["d"]
    q, table, _ = _per_query_inputs(torch, gen, blocks)
    kd = K.scan_per_query(table, q, blocks)
    torch.cuda.synchronize()
    err = compare_dense(kd, K.scan_per_query_plain(table, q, blocks))
    del kd
    ms = cuda_ms(lambda: K.scan_per_query(table, q, blocks))
    plain_ms = cuda_ms(lambda: K.scan_per_query_plain(table, q, blocks), reps=3)
    lib_ms = cuda_ms(lambda: lib_per_query(torch, table, q, blocks), reps=3)
    uniq = int(torch.unique(table).numel())
    side = 4 * (table.numel() + q.numel()) + 4 * q_n * nb * bs
    b = bound(uniq * bs * d + side, 2.0 * q_n * nb * bs * d)
    pp = bound(q_n * nb * bs * d + side, 2.0 * q_n * nb * bs * d)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):     # ragged small
        blk = _pool(torch, gen, 40, 32, 100, dtype)
        for bs2 in (32, 8):
            blk2 = blk[:, :bs2].contiguous()
            q2 = torch.randn(5, 100, device="cuda", generator=gen)
            t2 = torch.randint(0, 40, (5, 7), device="cuda", generator=gen, dtype=torch.int32)
            a = K.scan_per_query(t2, q2, blk2)
            torch.cuda.synchronize()
            want = K.scan_per_query_plain(t2, q2, blk2)
            err = max(err, compare_dense(a, want))
            check_library(torch, lib_per_query(torch, t2, q2, blk2), want, "scan_per_query")
    _log_kernel("scan_per_query", err, 0, ms, plain_ms, lib_ms, b, f" unique_pages={uniq}",
                f" per_probe_bound_ms={pp[0]:.4f} ({pp[1]})")
    results["scan_per_query"] = _result("scan_per_query", 52, err, ms, plain_ms, lib_ms, b)
    results["scan_per_query"]["per_probe_bound_ms"] = pp[0]

    nb = BATCHED_NB
    ids, q, _ = _batched_inputs(torch, gen, blocks)
    kd = K.scan_batched(ids, q, blocks)                   # (NB, Q, BS): 4.3 GB
    torch.cuda.synchronize()
    err = 0.0
    step = PLAIN_STEP
    for s in range(0, nb, step):
        err = max(err, compare_dense(kd[s:s + step], K.scan_batched_plain(ids[s:s + step], q, blocks)))
    torch.cuda.synchronize()
    del kd

    def plain_all():
        for s in range(0, nb, step):
            K.scan_batched_plain(ids[s:s + step], q, blocks)

    ms = cuda_ms(lambda: K.scan_batched(ids, q, blocks), reps=5)
    plain_ms = cuda_ms(plain_all, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: lib_batched(torch, ids, q, blocks), reps=1, warm=1)
    by = nb * bs * d + 4 * (nb + q.numel()) + 4 * nb * q_n * bs
    flops = 2.0 * nb * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    # ragged small: Q not a multiple of the 64-query tile, NB not a
    # multiple of the 256-page run or the 4-page step, BS below 32, and -1
    # padding among the ids (pages 4..7, one whole step, all padding)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        blk = _pool(torch, gen, 40, 32, 100, dtype)
        for bs2, q_n2, n2, pad in ((32, 13, 9, False), (32, 77, 71, True), (8, 40, 300, True)):
            blk2 = blk[:, :bs2].contiguous()
            q2 = torch.randn(q_n2, 100, device="cuda", generator=gen)
            u2 = torch.randint(0, 40, (n2,), device="cuda", generator=gen, dtype=torch.int32)
            if pad:
                u2[[1, 4, 5, 6, 7, n2 - 1]] = -1
            a = K.scan_batched(u2, q2, blk2)
            torch.cuda.synchronize()
            want = K.scan_batched_plain(u2, q2, blk2)
            err = max(err, compare_dense(a, want))
            check(bool((a[u2 < 0] == 3.0e38).all()), "scan_batched: a padding row is not BIG")
            if not pad:
                check_library(torch, lib_batched(torch, u2, q2, blk2).transpose(0, 1), want,
                              "scan_batched")
    # #3 runs its product on the tensor cores and beats the f32 bound: its
    # bound is the tensor-core one (the 4.3 GB output), the f32 one beside
    _log_kernel("scan_batched", err, 0, ms, plain_ms, lib_ms, tc, f" (page chunks of {step})",
                f" = tensor_core_bound_ms ({passes} TF32 passes) f32_bound_ms={b[0]:.4f} "
                f"({b[1]})")
    results["scan_batched"] = _result("scan_batched", 95, err, ms, plain_ms, lib_ms, tc,
                                      source="scan_batched_topk.cu")
    results["scan_batched"]["tensor_core_bound_ms"] = tc[0]
    results["scan_batched"]["f32_bound_ms"] = b[0]
    results["scan_batched"]["main_mix"] = _unique_blocks_main_mix(torch, gen, blocks, q)


def _unique_blocks_main_mix(torch, gen, blocks, q):
    """``ops.scan_unique_blocks`` (#3 behind its wrapper) on the batched
    main path's page mix: ``MAIN_PATH_PAGES`` real rows of the
    32,768-row budget, the rest -1 padding, passed to the kernel as they
    are.  Held against the plain version (which masks padding rows to
    BIG) chunk by chunk, every padding row exactly BIG.  The bound counts
    the live pages once, the product over them, and every output row
    written; ``mask_pass_ms`` times the ``torch.where`` over the output
    that the wrapper took before the kernel wrote its padding rows."""
    from repro_torch.kernels.posting_scan import kernel as K
    from repro_torch.kernels.posting_scan import ops

    nb, bs, d, live_n = BATCHED_NB, PQ["bs"], PQ["d"], MAIN_PATH_PAGES
    real = torch.sort(torch.randperm(blocks.shape[0], device="cuda", generator=gen)[:live_n]).values
    uniq = torch.full((nb,), -1, dtype=torch.int32, device="cuda")
    uniq[:live_n] = real.to(torch.int32)
    out = ops.scan_unique_blocks(q, uniq, blocks)
    torch.cuda.synchronize()
    err = 0.0
    for s in range(0, nb, PLAIN_STEP):
        err = max(err, compare_dense(out[s:s + PLAIN_STEP],
                                     K.scan_batched_plain(uniq[s:s + PLAIN_STEP], q, blocks)))
    check(bool((out[live_n:] == 3.0e38).all()), "scan_unique_blocks: a padding row is not BIG")
    pad = (uniq < 0)[:, None, None]
    mask_ms = cuda_ms(lambda: torch.where(pad, 3.0e38, out), reps=3)
    del out
    ms = cuda_ms(lambda: ops.scan_unique_blocks(q, uniq, blocks), reps=5)
    q_n = q.shape[0]
    by = live_n * bs * d + 4 * (nb + q.numel()) + 4 * nb * q_n * bs
    flops = 2.0 * live_n * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    log(f"scan_unique_blocks (main path mix: {live_n} real of {nb} rows, the rest -1): "
        f"ms={ms:.4f} max_abs_err={err:.3g} bound_ms={b[0]:.4f} ({b[1]}; the live pages once, "
        f"the product over them, every row written) tensor_core_bound_ms={tc[0]:.4f} "
        f"({tc[1]}, {passes} TF32 passes) mask_pass_ms={mask_ms:.4f} (the torch.where the "
        f"wrapper no longer takes); padding rows exactly BIG")
    return dict(live_pages=live_n, ms=ms, max_abs_err=err, bound_ms=b[0], bound_by=b[1],
                tensor_core_bound_ms=tc[0], tensor_core_bound_by=tc[1], mask_pass_ms=mask_ms)


def phase_scan_q8(torch, gen, results, blocks):
    """#5 ``scan_per_query_topk_q8`` and #7 ``scan_batched_topk_q8`` over
    int8 codes with per-page (scale, zero), at k = min(10*4, BS) = 32."""
    from repro_torch.kernels.posting_scan import kernel as K

    q_n, nb, bs, d, k = PQ["q_n"], PQ["nb"], PQ["bs"], PQ["d"], 32
    q, table, bias = _per_query_inputs(torch, gen, blocks)
    sz = _page_sz(torch, gen, (q_n, nb))
    kd, ki = K.scan_per_query_topk_q8(table, q, blocks, bias, sz, k=k)
    torch.cuda.synchronize()
    pd, pi = K.scan_per_query_topk_q8_plain(table, q, blocks, bias, sz, k=k)
    err, swaps = compare_kmin(kd, ki, pd, pi, atol=1e-2)
    del kd, ki, pd, pi
    ms = cuda_ms(lambda: K.scan_per_query_topk_q8(table, q, blocks, bias, sz, k=k))
    plain_ms = cuda_ms(lambda: K.scan_per_query_topk_q8_plain(table, q, blocks, bias, sz, k=k),
                       reps=3)
    lib_ms = cuda_ms(lambda: lib_per_query(torch, table, q, blocks, bias, sz, k=k), reps=3)
    uniq = int(torch.unique(table).numel())
    side = 4 * (table.numel() + q.numel() + bias.numel() + sz.numel()) + 8 * q_n * nb * k
    flops = 2.0 * q_n * nb * bs * d + 2.0 * uniq * bs * d
    b = bound(uniq * bs * d + side, flops)
    pp = bound(q_n * nb * bs * d + side, flops)
    # ragged small; d = 128 pads the ring's rows, (7, 4) copies 4 bytes
    for bs2, d2, k2 in ((32, 100, 32), (32, 100, 10), (8, 100, 8), (16, 100, 1),
                        (32, 128, 32), (7, 4, 7)):
        blk = _pool(torch, gen, 40, bs2, d2, torch.int8)
        q2 = torch.randn(5, d2, device="cuda", generator=gen) * 32
        t2 = torch.randint(0, 40, (5, 7), device="cuda", generator=gen, dtype=torch.int32)
        b2 = torch.where(torch.rand(5, 7, bs2, device="cuda", generator=gen) < 0.3, 3.0e38, 0.0)
        b2[0, 0] = 3.0e38
        s2 = _page_sz(torch, gen, (5, 7))
        a = K.scan_per_query_topk_q8(t2, q2, blk, b2, s2, k=k2)
        torch.cuda.synchronize()
        want = K.scan_per_query_topk_q8_plain(t2, q2, blk, b2, s2, k=k2)
        e2, _ = compare_kmin(*a, *want, atol=1e-2)
        check_library(torch, lib_per_query(torch, t2, q2, blk, b2, s2, k=k2).values,
                      want[0], "scan_per_query_topk_q8")
        err = max(err, e2)
    _log_kernel("scan_per_query_topk_q8", err, swaps, ms, plain_ms, lib_ms, b,
                f" unique_pages={uniq}", f" per_probe_bound_ms={pp[0]:.4f} ({pp[1]})")
    results["scan_per_query_topk_q8"] = _result("scan_per_query_topk_q8", 225, err, ms,
                                                plain_ms, lib_ms, b)
    results["scan_per_query_topk_q8"]["per_probe_bound_ms"] = pp[0]
    results["scan_per_query_topk_q8"]["main_mix"] = _per_query_main_mix(torch, gen, blocks, q,
                                                                        k, q8=True)

    nb = BATCHED_NB
    ids, q, bias = _batched_inputs(torch, gen, blocks)
    sz = _page_sz(torch, gen, (nb,))
    kd, ki = K.scan_batched_topk_q8(ids, q, blocks, bias, sz, k=k)   # 8.6 GB
    torch.cuda.synchronize()
    err, swaps = 0.0, 0
    step = PLAIN_STEP
    for s in range(0, nb, step):
        pd, pi = K.scan_batched_topk_q8_plain(ids[s:s + step], q, blocks, bias[s:s + step],
                                              sz[s:s + step], k=k)
        e, w = compare_kmin(kd[s:s + step], ki[s:s + step], pd, pi, atol=1e-2)
        err, swaps = max(err, e), swaps + w
    torch.cuda.synchronize()
    # the card's own rate for the same stores: fill the 8.6 GB of candidates
    store_ms = cuda_ms(lambda: (kd.fill_(0.0), ki.fill_(0)), reps=3)
    del kd, ki, pd, pi

    def plain_all():
        for s in range(0, nb, step):
            K.scan_batched_topk_q8_plain(ids[s:s + step], q, blocks, bias[s:s + step],
                                         sz[s:s + step], k=k)

    ms = cuda_ms(lambda: K.scan_batched_topk_q8(ids, q, blocks, bias, sz, k=k), reps=5)
    plain_ms = cuda_ms(plain_all, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: lib_batched(torch, ids, q, blocks, bias, sz, k=k), reps=1, warm=1)
    by = nb * bs * d + 4 * (nb + q.numel() + bias.numel() + sz.numel()) + 8 * nb * q_n * k
    flops = 2.0 * nb * q_n * bs * d
    b = bound(by, flops + 2.0 * nb * bs * d)
    # the product on the codes, exact in TF32: two split passes
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    for bs2, k2 in ((32, 32), (32, 17), (32, 10), (8, 8), (16, 1)):   # ragged small
        blk = _pool(torch, gen, 40, bs2, 100, torch.int8)
        q2 = torch.randn(13, 100, device="cuda", generator=gen) * 32
        u2 = torch.arange(0, 40, 4, device="cuda", dtype=torch.int32)[:9].contiguous()
        b2 = torch.where(torch.rand(9, bs2, device="cuda", generator=gen) < 0.3, 3.0e38, 0.0)
        b2[0] = 3.0e38
        s2 = _page_sz(torch, gen, (9,))
        a = K.scan_batched_topk_q8(u2, q2, blk, b2, s2, k=k2)
        torch.cuda.synchronize()
        want = K.scan_batched_topk_q8_plain(u2, q2, blk, b2, s2, k=k2)
        e2, _ = compare_kmin(*a, *want, atol=1e-2)
        check_library(torch, lib_batched(torch, u2, q2, blk, b2, s2, k=k2).values.transpose(0, 1),
                      want[0], "scan_batched_topk_q8")
        err = max(err, e2)
    tie_swaps, e2 = _q8_tie_swaps(torch, gen, q_n, bs, d)
    check(tie_swaps == 0, f"{tie_swaps} candidates of the tie-heavy q8 input are not the "
          "lowest slots of their tie")
    err = max(err, e2)
    _log_kernel("scan_batched_topk_q8", err, swaps, ms, plain_ms, lib_ms, b,
                f" (page chunks of {step})",
                f" tensor_core_bound_ms={tc[0]:.4f} ({tc[1]}, {passes} TF32 passes on the "
                f"codes) store_floor_ms={store_ms:.4f} (fill_ of the candidates) tie_swaps on "
                f"the tie-heavy input at k={bs}: {tie_swaps}")
    results["scan_batched_topk_q8"] = _result("scan_batched_topk_q8", 352, err, ms, plain_ms,
                                              lib_ms, b, source="scan_batched_topk.cu")
    results["scan_batched_topk_q8"]["tensor_core_bound_ms"] = tc[0]
    results["scan_batched_topk_q8"]["store_floor_ms"] = store_ms
    results["scan_batched_topk_q8"]["main_mix"] = _batched_main_mix(torch, gen, blocks, q, k,
                                                                    q8=True)
    results["scan_batched_topk_q8"]["pairs"] = {
        str(n): _batched_pairs_mix(torch, gen, blocks, q, k, n, q8=True)
        for n in (MAIN_PATH_PAGES, SEARCH_SAT_PAGES)}


# The retrieval path's scan geometry at 524,288 items (configs/
# two_tower_retrieval.py ann_index_cfg at its capacities x 16): d=256, bf16
# pages of BS=32 in a 65,536-block pool, nprobe 16 (64 pages a query, #4),
# navigation over 32,768 centroid slots; a batch of Q=1,024 users; #6 and
# #3 over a 32,768-page budget, as the d=100 rows.
D256 = dict(q_n=1024, d=256, bs=32, n_blocks=65_536, nb_per_query=64, nprobe=16,
            p_n=32_768, k=10)


def phase_d256(torch, gen, results):
    """#1, #4, #6 and #3 at ``D256`` (unit-scale data, as the tower's unit
    vectors): each held against its plain version, timed beside it and
    beside its library call, its bound reckoned at d=256; ``results[name]
    ["d256"]``.  Then #6, #7 and #3 at d=256 for every payload (f32, bf16,
    int8 values, int8 codes) at ragged small shapes: the wide shape of the
    f32 and bf16 layouts, the default one of int8 pages."""
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as K

    g = D256
    q_n, d, bs, k = g["q_n"], g["d"], g["bs"], g["k"]
    q = torch.nn.functional.normalize(torch.randn(q_n, d, device="cuda", generator=gen), dim=1)
    # #1: navigation, k = nprobe
    c = torch.nn.functional.normalize(torch.randn(g["p_n"], d, device="cuda", generator=gen), dim=1)
    csq = torch.sum(c * c, dim=1)
    csq[torch.rand(g["p_n"], device="cuda", generator=gen) < 0.2] = 3.0e38
    csq = csq[None].contiguous()
    kk = g["nprobe"]
    err, _ = compare_kmin(*LK.l2_topk_tiles(q, c, csq, k=kk, block_p=512),
                          *LK.l2_topk_tiles_plain(q, c, csq, k=kk, block_p=512), atol=1e-4)
    ms = cuda_ms(lambda: LK.l2_topk_tiles(q, c, csq, k=kk, block_p=512))
    plain_ms = cuda_ms(lambda: LK.l2_topk_tiles_plain(q, c, csq, k=kk, block_p=512), reps=3)
    lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, c), kk, largest=False), reps=3)
    t = g["p_n"] // 512
    by = 4 * (q_n * d + g["p_n"] * d + g["p_n"]) + 8 * q_n * t * kk
    b = bound(by, 2.0 * q_n * g["p_n"] * d)
    tc = bound(by, 3 * 2.0 * q_n * g["p_n"] * d, TF32_FLOP_PER_S)   # three TF32 passes
    out = {"l2_topk_tiles": dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                                 bound_ms=b[0], bound_by=b[1], tensor_core_bound_ms=tc[0],
                                 tc_passes=3, shape=f"Q={q_n} P={g['p_n']} d={d} k={kk}")}
    del c, csq
    # #4: per_query, bf16 pages
    blocks = (torch.randn(g["n_blocks"], bs, d, device="cuda", generator=gen) * 0.0625
              ).to(torch.bfloat16)
    nb = g["nb_per_query"]
    table = torch.randint(0, g["n_blocks"], (q_n, nb), device="cuda", generator=gen,
                          dtype=torch.int32)
    bias = torch.where(torch.rand(q_n, nb, bs, device="cuda", generator=gen) < 0.2,
                       3.0e38, 0.0).contiguous()
    err, _ = compare_kmin(*K.scan_per_query_topk(table, q, blocks, bias, k=k),
                          *K.scan_per_query_topk_plain(table, q, blocks, bias, k=k), atol=1e-4)
    ms = cuda_ms(lambda: K.scan_per_query_topk(table, q, blocks, bias, k=k))
    plain_ms = cuda_ms(lambda: K.scan_per_query_topk_plain(table, q, blocks, bias, k=k), reps=3)
    lib_ms = cuda_ms(lambda: lib_per_query(torch, table, q, blocks, bias, k=k), reps=3)
    uniq = int(torch.unique(table).numel())
    b = bound(2 * uniq * bs * d + 4 * (table.numel() + q.numel() + bias.numel())
              + 8 * q_n * nb * k, 2.0 * q_n * nb * bs * d)
    out["scan_per_query_topk"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      max_abs_err=err, bound_ms=b[0], bound_by=b[1],
                                      shape=f"Q={q_n} NB={nb} BS={bs} d={d} bf16 k={k}")
    del table, bias
    # #6 and #3 over the batched budget, bf16 pages
    nbb = BATCHED_NB
    ids = torch.sort(torch.randperm(g["n_blocks"], device="cuda", generator=gen)[:nbb]).values
    ids = ids.to(torch.int32).contiguous()
    bias = torch.where(torch.rand(nbb, bs, device="cuda", generator=gen) < 0.2, 3.0e38, 0.0)
    bias = bias.contiguous()
    kd, ki = K.scan_batched_topk(ids, q, blocks, bias, k=k)
    torch.cuda.synchronize()
    err = 0.0
    for s in range(0, nbb, PLAIN_STEP):
        e, _ = compare_kmin(kd[s:s + PLAIN_STEP], ki[s:s + PLAIN_STEP],
                            *K.scan_batched_topk_plain(ids[s:s + PLAIN_STEP], q, blocks,
                                                       bias[s:s + PLAIN_STEP], k=k), atol=1e-4)
        err = max(err, e)
    del kd, ki

    def plain_topk():
        for s in range(0, nbb, PLAIN_STEP):
            K.scan_batched_topk_plain(ids[s:s + PLAIN_STEP], q, blocks, bias[s:s + PLAIN_STEP], k=k)

    ms = cuda_ms(lambda: K.scan_batched_topk(ids, q, blocks, bias, k=k), reps=5)
    plain_ms = cuda_ms(plain_topk, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: lib_batched(torch, ids, q, blocks, bias, k=k), reps=1, warm=1)
    by = 2 * nbb * bs * d + 4 * (nbb + q.numel() + bias.numel()) + 8 * nbb * q_n * k
    flops = 2.0 * nbb * q_n * bs * d
    b = bound(by, flops)
    passes = tf32_passes(blocks.dtype)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    out["scan_batched_topk"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                                    bound_ms=b[0], bound_by=b[1], tensor_core_bound_ms=tc[0],
                                    tc_passes=passes,
                                    shape=f"NB={nbb} Q={q_n} BS={bs} d={d} bf16 k={k}")
    out_d = K.scan_batched(ids, q, blocks)
    torch.cuda.synchronize()
    err = max(compare_dense(out_d[s:s + PLAIN_STEP],
                            K.scan_batched_plain(ids[s:s + PLAIN_STEP], q, blocks), atol=1e-4)
              for s in range(0, nbb, PLAIN_STEP))
    del out_d

    def plain_all():
        for s in range(0, nbb, PLAIN_STEP):
            K.scan_batched_plain(ids[s:s + PLAIN_STEP], q, blocks)

    ms = cuda_ms(lambda: K.scan_batched(ids, q, blocks), reps=5)
    plain_ms = cuda_ms(plain_all, reps=1, warm=1)
    lib_ms = cuda_ms(lambda: lib_batched(torch, ids, q, blocks), reps=1, warm=1)
    by = 2 * nbb * bs * d + 4 * (nbb + q.numel()) + 4 * nbb * q_n * bs
    b = bound(by, flops)
    tc = bound(by, passes * flops, TF32_FLOP_PER_S)
    # as at d=100, #3's bound is the tensor-core one, the f32 one beside
    out["scan_batched"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                               bound_ms=tc[0], bound_by=tc[1], tensor_core_bound_ms=tc[0],
                               f32_bound_ms=b[0], tc_passes=passes,
                               shape=f"NB={nbb} Q={q_n} BS={bs} d={d} bf16")
    del blocks, ids, bias
    # every payload at d=256, ragged small: Q past one query tile, dead and
    # padding pages
    for form in (torch.float32, torch.bfloat16, torch.int8, "q8"):
        codes = form == "q8"
        blk = _pool(torch, gen, 96, bs, d, torch.int8 if codes else form)
        q2 = torch.randn(70, d, device="cuda", generator=gen) * (32 if blk.dtype == torch.int8
                                                                  else 1)
        u2 = torch.randint(0, 96, (37,), device="cuda", generator=gen, dtype=torch.int32)
        b2 = torch.where(torch.rand(37, bs, device="cuda", generator=gen) < 0.3, 3.0e38, 0.0)
        b2[[0, 9]] = 3.0e38
        for kk in (10, 32):
            if codes:
                s2 = _page_sz(torch, gen, (37,))
                got = K.scan_batched_topk_q8(u2, q2, blk, b2, s2, k=kk)
                want = K.scan_batched_topk_q8_plain(u2, q2, blk, b2, s2, k=kk)
            else:
                got = K.scan_batched_topk(u2, q2, blk, b2, k=kk)
                want = K.scan_batched_topk_plain(u2, q2, blk, b2, k=kk)
            torch.cuda.synchronize()
            compare_kmin(*got, *want, atol=1e-2)
        if not codes:
            u3 = u2.clone()
            u3[[1, 4, 5, 6, 7]] = -1
            a = K.scan_batched(u3, q2, blk)
            torch.cuda.synchronize()
            compare_dense(a, K.scan_batched_plain(u3, q2, blk))
            check(bool((a[u3 < 0] == 3.0e38).all()),
                  "scan_batched at d=256: a padding row is not BIG")
    for name, r in out.items():
        log(f"{name} at d=256 ({r['shape']}): ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} max_abs_err={r['max_abs_err']:.3g} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
            + (f" tensor_core_bound_ms={r['tensor_core_bound_ms']:.4f} ({r['tc_passes']} TF32 "
               "passes)" if "tensor_core_bound_ms" in r else "")
            + (f" f32_bound_ms={r['f32_bound_ms']:.4f}" if "f32_bound_ms" in r else ""))
        results[name]["d256"] = r
    log("scan_batched_topk, scan_batched_topk_q8, scan_batched at d=256: f32, bf16, int8 "
        "values and int8 codes held against their plain versions (k 10 and 32; padding rows BIG)")


# ---------------------------------------------------------------------------
# the resource phase: spflint over the tree, the launchers' shared memory
# ---------------------------------------------------------------------------

# Past the spec's geometries, each entry and payload is also launched at
# its edge at BS = 32: the largest d (a multiple of 4, up to EDGE_MAX_D) at
# which the mirror says it fits, and d + 4, which it must refuse.
EDGE_MAX_D = 8192
CUDA_ERROR_INVALID_VALUE = 1


def _edge_geometries(SM, spec, form, payload):
    """The last fitting and the first refused geometry of one launcher."""
    def geo(d):
        return {"name": f"edge-d{d}", "dim": d, "bs": 32, "k": 10, "nav_k": 64,
                "block_p": 512, "payloads": (payload,)}

    for d in range(4, EDGE_MAX_D + 1, 4):
        if SM.shape_of(form, payload, geo(d), spec).variant < 0:
            return [geo(d - 4), geo(d)]
    raise Fail(f"[resources] {form} {payload} fits every d up to {EDGE_MAX_D}")


def _resource_launch(torch, gen, entry, form, payload, g):
    """Inputs at geometry ``g`` on a tiny Q and NB for ``entry``; returns
    ``(run, plain)``, callables of its wrapper and of its plain version on
    them."""
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as K

    d, dev = g["dim"], "cuda"
    if form == "l2":
        k, bp = g["nav_k"], g["block_p"]
        q = torch.randn(37, d, device=dev, generator=gen)
        c = torch.randn(2 * bp, d, device=dev, generator=gen)
        csq = torch.sum(c * c, dim=1)
        csq[torch.rand(2 * bp, device=dev, generator=gen) < 0.2] = 3.0e38
        csq = csq[None].contiguous()
        return (lambda: LK.l2_topk_tiles(q, c, csq, k=k, block_p=bp),
                lambda: LK.l2_topk_tiles_plain(q, c, csq, k=k, block_p=bp))
    bs, n_blocks, nb = g["bs"], 8, 5
    q8 = entry.endswith("_q8")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[payload]
    blk = _pool(torch, gen, n_blocks, bs, d, dtype)
    per_query = form.startswith("per_query")
    q_n = 3 if per_query else 70          # the batched forms: past one query tile
    q = torch.randn(q_n, d, device=dev, generator=gen) * (32 if dtype == torch.int8 else 1)
    lead = (q_n, nb) if per_query else (nb,)
    ids = torch.randint(0, n_blocks, lead, device=dev, generator=gen, dtype=torch.int32)
    bias = torch.where(torch.rand(*lead, bs, device=dev, generator=gen) < 0.3, 3.0e38, 0.0)
    sz = _page_sz(torch, gen, lead)
    k = min(g["k"], bs)
    if form == "per_query":
        return lambda: K.scan_per_query(ids, q, blk), lambda: K.scan_per_query_plain(ids, q, blk)
    if form == "batched":
        ids[1] = -1                                     # a padding page
        return lambda: K.scan_batched(ids, q, blk), lambda: K.scan_batched_plain(ids, q, blk)
    fn = {("per_query_topk", False): "scan_per_query_topk",
          ("per_query_topk", True): "scan_per_query_topk_q8",
          ("batched_topk", False): "scan_batched_topk",
          ("batched_topk", True): "scan_batched_topk_q8"}[form, q8]
    args = (ids, q, blk, bias, sz) if q8 else (ids, q, blk, bias)
    return (lambda: getattr(K, fn)(*args, k=k),
            lambda: getattr(K, f"{fn}_plain")(*args, k=k))


def phase_resources(torch, gen, report):
    """spflint's passes over ``src`` (0 findings), then every launch entry
    x payload x the spec's geometries, and each entry's edge at BS = 32:
    the C query's bytes and shape must equal the mirror's
    (``repro_torch.analysis.smem``), its occupancy at most the mirror's
    blocks an SM; the launcher runs at a tiny Q and NB where the mirror says
    it fits (against its plain version) and must refuse with
    cudaErrorInvalidValue, raising and counting no launch, where it says it
    refuses.  The card's opt-in shared memory a block must be the limit the
    launchers hard-code.  Prints the table on a ``resources:`` line."""
    from repro_torch.analysis import run_all
    from repro_torch.analysis import smem as SM
    from repro_torch.analysis.config import DEFAULT_SPEC
    from repro_torch.kernels import build
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as K

    t0 = time.perf_counter()
    spec = DEFAULT_SPEC.smem
    res = run_all(ROOT / "src")
    check(not res["findings"], "[resources] spflint findings: "
          + "; ".join(f.render() for f in res["findings"]))
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    check(optin == spec.limit_bytes, f"[resources] the card lets a block opt in to {optin} "
          f"bytes of shared memory; the launchers hard-code {spec.limit_bytes}")
    rows = list(res["smem_table"])
    for entry, (form, payloads) in spec.entries.items():
        for payload in payloads:
            for g in _edge_geometries(SM, spec, form, payload):
                shape = SM.shape_of(form, payload, g, spec)
                rows.append(dict(entry=entry, form=form, payload=payload, geometry=g["name"],
                                 bytes=shape.bytes, variant=shape.variant, warps=shape.warps,
                                 stages=shape.stages, blocks_per_sm=SM.blocks_per_sm(shape, spec),
                                 g=g))
    geos = {g["name"]: g for g in spec.bindings}

    def counts():
        return sum(LK.LAUNCHES.values()) + sum(K.LAUNCHES.values())

    table, n_launched, n_refused = [], 0, 0
    for r in rows:
        g = r.pop("g", None) or geos[r["geometry"]]
        what = f"[resources] {r['entry']} {r['payload']} at {r['geometry']} (d={g['dim']})"
        got, shape = build.smem_query(r["entry"], *SM.query_args(r["entry"], r["form"],
                                                                   r["payload"], g))
        check((got, shape[:3]) == (r["bytes"], (r["variant"], r["warps"], r["stages"])),
              f"{what}: the launcher asks for {got} bytes as {shape[:3]}, the mirror says "
              f"{r['bytes']} as {(r['variant'], r['warps'], r['stages'])}")
        run, plain = _resource_launch(torch, gen, r["entry"], r["form"], r["payload"], g)
        err = None
        if r["variant"] >= 0:
            check(1 <= shape[3] <= r["blocks_per_sm"], f"{what}: {shape[3]} blocks an SM by the "
                  f"occupancy calculator, the shared memory allows {r['blocks_per_sm']}")
            got_out, want = run(), plain()
            torch.cuda.synchronize()
            if isinstance(got_out, tuple):
                err, _ = compare_kmin(*got_out, *want, atol=1e-2)
            else:
                err = compare_dense(got_out, want)
            n_launched += 1
        else:
            before = counts()
            try:
                run()
                raised = None
            except RuntimeError as e:
                raised = str(e)
            check(raised is not None and raised.endswith(f"CUDA error {CUDA_ERROR_INVALID_VALUE}"),
                  f"{what}: the mirror says it refuses, the launcher "
                  f"{'raised ' + raised if raised else 'returned a result'}")
            check(counts() == before, f"{what}: a refused launch was counted")
            n_refused += 1
        table.append([r["entry"], r["payload"], r["geometry"], got,
                      SM.VARIANTS[r["variant"]], r["warps"], r["stages"], r["blocks_per_sm"],
                      shape[3], err])
    secs = time.perf_counter() - t0
    report["resources"] = dict(seconds=secs, findings=0, optin_bytes=optin, rows=len(table),
                               launched=n_launched, refused=n_refused)
    print("resources: " + json.dumps({
        "columns": ["entry", "payload", "geometry", "bytes", "shape", "warps", "stages",
                    "blocks_per_sm_by_smem", "blocks_per_sm_on_card", "max_abs_err"],
        "rows": table}))
    log(f"[resources] spflint clean over src; {len(table)} rows (entry x payload x geometry, "
        f"and each entry's edge at BS=32): C query = mirror on every row, {n_launched} "
        f"launched against their plain versions, {n_refused} refused with "
        f"cudaErrorInvalidValue; opt-in shared memory {optin} bytes a block; {secs:.1f} s")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def recall_at_10(torch, base_t, queries, got, ids=None):
    """Recall@10 against brute force (plain torch, f32 expansion); row
    ``i`` of ``base_t`` is vid ``ids[i]`` (``i`` without ``ids``)."""
    q = torch.as_tensor(queries, device=base_t.device)
    bsq = torch.sum(base_t * base_t, dim=1)
    best_d, best_i = None, None
    for s in range(0, base_t.shape[0], 262_144):
        chunk = base_t[s:s + 262_144]
        d = torch.sum(q * q, 1, keepdim=True) - 2 * q @ chunk.T + bsq[None, s:s + 262_144]
        vd, vi = torch.topk(d, 10, largest=False)
        vi = vi + s
        if best_d is None:
            best_d, best_i = vd, vi
        else:
            cd, ci = torch.cat([best_d, vd], 1), torch.cat([best_i, vi], 1)
            best_d, sel = torch.topk(cd, 10, largest=False)
            best_i = torch.gather(ci, 1, sel)
    gt = best_i.cpu().numpy()
    if ids is not None:
        gt = ids[gt]
    return float(sum(len(set(a) & set(b)) for a, b in zip(gt.tolist(), got.tolist()))
                 / (10 * len(gt)))


def overlap(a, b) -> float:
    return float(sum(len(set(x) & set(y)) for x, y in zip(a.tolist(), b.tolist()))
                 / a.size)


def timed(torch, fn):
    """``(fn(), seconds)`` on the host clock, the device drained first and
    after (a no-op without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_navigation(torch, state, q_t, nprobe):
    """Kernel ``navigate`` against the plain ``pairwise_sql2`` +
    ``masked_topk`` on the index's own centroids, tie-tolerant: the i-th
    distances agree, every returned centroid is valid, distinct and lies
    at the distance reported for it.  The comparison launch is not
    counted.  Returns the id overlap."""
    from repro_torch.core import lire
    from repro_torch.core.distance import MASK_DISTANCE, masked_topk, pairwise_sql2
    from repro_torch.kernels.l2_topk import kernel as LK

    saved = dict(LK.LAUNCHES)
    kd, ki = lire.navigate(state, q_t, nprobe)
    LK.LAUNCHES.update(saved)
    full = pairwise_sql2(q_t, state.centroids, state.centroid_sqn)
    pd, pi = masked_topk(full, state.centroid_valid[None, :], nprobe)
    # both expand ||q||^2 - 2 q.c + ||c||^2 in f32, summed in another
    # order: the error scales with the terms, not with their difference
    tol = 1e-5 * (torch.sum(q_t * q_t, 1, keepdim=True) + pd.abs())
    live = ki >= 0
    check(bool(torch.equal(live, pd < MASK_DISTANCE / 2)), "navigate: live probes differ")
    check(bool(((kd - pd).abs() <= tol)[live].all()), "navigate: distances differ")
    safe = ki.clamp(min=0).long()
    check(bool(state.centroid_valid[safe][live].all()), "navigate: invalid centroid")
    srt = torch.sort(torch.where(live, safe, -1 - torch.arange(nprobe, device=safe.device)),
                     dim=1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()), "navigate: a centroid twice in one row")
    true_d = torch.gather(full, 1, safe)
    check(bool(((true_d - kd).abs() <= tol)[live].all()),
          "navigate: a centroid's distance is misreported")
    return overlap(ki.cpu().numpy(), pi.cpu().numpy())


def kernel_ms_in(torch, fn):
    """Run ``fn`` once with CUDA events around every launch of the kernel
    wrappers of the search path, patched where the path looks them up.
    Returns ``(fn(), {kernel: summed ms}, host ms)``; a kernel's ms include
    its wrapper's host work whenever the stream was idle at the launch."""
    from repro_torch.kernels.l2_topk import ops as l2_ops
    from repro_torch.kernels.posting_scan import kernel as SK

    sites = ((l2_ops, "l2_topk_tiles"), (SK, "scan_per_query_topk"),
             (SK, "scan_batched_topk_pairs"), (SK, "scan_per_query_topk_q8"),
             (SK, "scan_batched_topk_q8_pairs"))
    events = {name: [] for _, name in sites}

    def wrap(name, f):
        def timed_launch(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = f(*a, **kw)
            e.record()
            events[name].append((s, e))
            return out
        return timed_launch

    originals = [(mod, name, getattr(mod, name)) for mod, name in sites]
    for mod, name, f in originals:
        setattr(mod, name, wrap(name, f))
    try:
        out, host_s = timed(torch, fn)
    finally:
        for mod, name, f in originals:
            setattr(mod, name, f)
    ms = {n: sum(s.elapsed_time(e) for s, e in ev) for n, ev in events.items()}
    return out, ms, host_s * 1e3


# The two main paths: the fp32 path stores the bytes as they are; the
# int8 path is the reference's int8 cell (benchmarks/bench_search_path.py:43,
# CODEC_CELLS: codec "int8", rerank_factor 4) at the spfresh-1b widths.
CELLS = {"fp32": {}, "int8": {"codec": "int8", "rerank_factor": 4}}
# insert batches of UPDATE_B rows per path
INSERT_BATCHES = {"fp32": 4, "int8": 1}
# the kernels each path must launch
PATH_KERNELS = {
    "fp32": ("l2_topk_tiles", "scan_per_query_topk", "scan_batched_topk_pairs"),
    "update": ("l2_topk_tiles", "scan_per_query_topk", "scan_batched_topk_pairs"),
    "int8": ("l2_topk_tiles", "scan_per_query_topk_q8", "scan_batched_topk_q8_pairs"),
    "serve": ("l2_topk_tiles", "scan_batched_topk_pairs", "scan_per_query_topk"),
    "grouped": ("scan_batched_topk_pairs",),
    "durable": ("l2_topk_tiles", "scan_batched_topk_pairs", "scan_per_query_topk"),
    "sharded": ("l2_topk_tiles", "scan_batched_topk_pairs", "scan_per_query_topk"),
    "retrieval": ("l2_topk_tiles", "scan_per_query_topk", "scan_batched_topk_pairs"),
    "train": ("l2_topk_tiles", "scan_per_query_topk"),
    "lm": (),                       # the LM path reaches no kernel of the table
    "lm_train": (),                 # nor LM training
    "gnn": (),                      # nor the GAT
}


def path_config(cell):
    """spfresh-1b ``CONFIG_PAGED`` with kernel navigation, in ``cell``."""
    from repro_torch.configs.spfresh import CONFIG_PAGED

    return dataclasses.replace(CONFIG_PAGED, use_pallas_nav=True, **CELLS[cell])


def check_exact(np, data, queries, d, v, what):
    """Every returned distance is the exact f32 diff² of its vid's vector
    (the rerank ran): within ``1e-5 * ||q||^2``."""
    live = v >= 0
    rows = data[np.maximum(v, 0)].astype(np.float64)
    q64 = queries.astype(np.float64)
    true = np.sum((rows - q64[:, None, :]) ** 2, axis=-1)
    tol = 1e-5 * np.sum(q64 * q64, axis=1, keepdims=True)
    err = np.abs(true - d)
    check(bool((err <= tol)[live].all()), f"{what}: a distance is not the exact one "
          f"(max err {float(err[live].max())})")
    return float(err[live].max())


def main_path(torch, np, seed, report, *, cell="fp32", cfg=None, device="cuda",
              index_cells=None):
    """Build from ``N_BASE`` vectors, search, insert, delete, search, through
    ``SPFreshIndex``, in the codec ``cell`` (``CELLS``).  ``cfg`` defaults
    to :func:`path_config`; a smaller ``cfg``, ``N_BASE`` and
    ``device="cpu"`` rehearse the path without a card.  Given a dict
    ``index_cells``, the final state also runs spfresh-1b's
    ``serve_search``, ``serve_search_paged`` and ``serve_update`` cells
    (:func:`fp32_index_cells`; the update batch is the path's first
    ``UPDATE_B`` fresh rows, inserted again under new vids)."""
    from repro_torch.configs.spfresh import SEARCH_Q, UPDATE_B
    from repro_torch.core import lire
    from repro_torch.core.index import SPFreshIndex
    from repro_torch.data.vectors import make_queries, make_spacev_int8
    from repro_torch.utils.tree import clone_state, tensor_leaves

    if cfg is None:
        cfg = path_config(cell)
    rerank = cfg.codec != "fp32" and cfg.rerank_factor > 1
    n, k, nprobe = N_BASE, 10, cfg.nprobe
    n_batches = INSERT_BATCHES[cell]
    n_ins = n_batches * UPDATE_B
    # the same data for every cell: the base and the first inserts agree
    data, gen_s = timed(torch, lambda: make_spacev_int8(n + 4 * UPDATE_B, cfg.dim, seed=seed))
    base, fresh = data[:n], data[n:n + n_ins]
    queries = make_queries(base, SEARCH_Q, seed=seed)
    log(f"[{cell}] data: N={n} inserts={n_ins} d={cfg.dim} codec={cfg.codec} "
        f"rerank_factor={cfg.rerank_factor} made in {gen_s:.1f} s")

    idx, build_s = timed(
        torch, lambda: SPFreshIndex.build(cfg, base, seed=seed, device=device))
    st = idx.stats()
    mem = idx.memory_bytes()
    log(f"[{cell}] build: {build_s:.1f} s n_postings={st['n_postings']} "
        f"used_blocks={st['used_blocks']} state_bytes={mem['memory'] + mem['disk']} "
        f"(hot {mem['hot']}, exact tier {mem['cold']})")
    report.update(n=n, build_s=build_s, n_postings=st["n_postings"],
                  used_blocks=st["used_blocks"], memory_bytes=mem)
    q_t = torch.as_tensor(queries, device=device)
    for name, v in lire.scan_page_stats(idx.state, q_t, nprobe=nprobe).items():
        report[f"page_stats_{name}"] = int(v)
    log(f"[{cell}] scan_page_stats (Q={len(queries)}, budget {cfg.scan_page_budget}): "
        + " ".join(f"{s}={report['page_stats_' + s]}" for s in ("n_pages", "n_unique", "overflow")))

    nav_overlap = check_navigation(torch, idx.state, q_t, nprobe)
    log(f"[{cell}] navigate: kernel vs plain pairwise_sql2 + masked_topk on {len(queries)} "
        f"queries at nprobe={nprobe}: agree up to ties, id overlap {nav_overlap:.6f}")

    def search(schedule, qs=queries, probes=nprobe):
        return idx.search_padded(qs, k, nprobe=probes, use_pallas_scan=True,
                                 scan_schedule=schedule)

    res, p50, in_search = {}, {}, {}
    for sched in ("batched", "per_query"):
        res[sched] = search(sched)
        times = [timed(torch, lambda: search(sched))[1] * 1e3 for _ in range(SEARCH_P50_REPS)]
        p50[sched] = statistics.median(times)
        if device == "cuda":
            _, kms, host_ms = kernel_ms_in(torch, lambda: search(sched))
            in_search[sched] = dict(kernel_ms=kms, host_ms=host_ms)
            log(f"[{cell}] inside one {sched} search ({host_ms:.3f} ms on the host clock): "
                + " ".join(f"{name}={v:.4f} ms" for name, v in kms.items() if v))
    base_t = torch.as_tensor(base, device=device)
    recall, exact_err = {}, {}
    for sched in ("batched", "per_query"):
        recall[f"{sched}@{nprobe}"] = recall_at_10(torch, base_t, queries, res[sched][1])
        d1, v1 = search(sched, probes=1)
        recall[f"{sched}@1"] = recall_at_10(torch, base_t, queries, v1)
        if rerank:
            exact_err[f"{sched}@{nprobe}"] = check_exact(np, data, queries, *res[sched],
                                                         f"{sched}@{nprobe}")
            exact_err[f"{sched}@1"] = check_exact(np, data, queries, d1, v1, f"{sched}@1")
    ref = REFERENCE_RECALL_20K[cell]
    floor = {key: ref[int(key.split("@")[1])] - RECALL_MARGIN for key in recall}
    log(f"[{cell}] recall@10 (schedule@nprobe): {recall} floors {floor} (reference at "
        f"N=20,000 {ref} minus {RECALL_MARGIN})")
    for key, r in recall.items():
        check(r >= floor[key], f"[{cell}] recall@10 {r} of {key} below the floor {floor[key]}")
    if rerank:
        log(f"[{cell}] every returned distance is the exact f32 diff² of its vid "
            f"(within 1e-5 ||q||^2; max abs err {exact_err})")
    _, v_oracle = idx.search_padded(queries, k, nprobe=nprobe, use_pallas_scan=False)
    ov = {s: overlap(v_oracle, res[s][1]) for s in res}
    log(f"[{cell}] kernel path vs gather oracle, id overlap: {ov}")
    for s, o in ov.items():
        check(o >= 0.95, f"[{cell}] {s} overlaps the oracle by {o} < 0.95")

    sample = queries[:256]
    d0, v0 = idx.search(sample, k, use_pallas_scan=True, scan_schedule="per_query")
    d1, v1 = idx.search(sample, k, use_pallas_scan=True, scan_schedule="batched")
    # The reference holds its schedules to 1e-4 at unit scale, where
    # ||q||^2 ~ 16: about 6e-6 ||q||^2 of f32 expansion noise.  Byte-scale
    # vectors carry ||q||^2 ~ 1e5, so the tolerance scales with it.
    qsq = np.sum(sample.astype(np.float64) ** 2, axis=1, keepdims=True)
    tol = np.broadcast_to(1e-5 * qsq, d0.shape)
    check(bool((np.abs(d0 - d1) <= tol).all()), f"[{cell}] schedules disagree on distances")
    check(bool((np.abs(d0 - d1)[v0 != v1] <= tol[v0 != v1]).all()),
          f"[{cell}] schedules disagree on ids beyond distance ties")
    log(f"[{cell}] schedules agree on 256 queries (tie swaps: {int((v0 != v1).sum())})")

    # inserts: the first batch is replayed on a clone for determinism
    before = clone_state(idx.state)
    ins_vids = np.arange(n, n + n_ins, dtype=np.int32)
    ins_s = []
    for b in range(n_batches):
        sl = slice(b * UPDATE_B, (b + 1) * UPDATE_B)
        _, s = timed(torch, lambda: idx.insert(fresh[sl], ins_vids[sl]))
        ins_s.append(s)
        if b == 0:
            after = tensor_leaves(idx.state)
            replay = SPFreshIndex(before)
            replay.insert(fresh[sl], ins_vids[sl])
            for name, t in tensor_leaves(replay.state).items():
                check(bool(torch.equal(t, after[name])),
                      f"[{cell}] insert replay differs in {name}")
            del replay, before, after
            log(f"[{cell}] insert determinism: replay on a clone is bit-identical")
    st = idx.stats()
    check(st["n_inserts"] == n_ins, f"[{cell}] {st['n_inserts']} inserts counted, {n_ins} sent")
    rng = np.random.default_rng(seed + 7)
    victims = rng.choice(n, size=UPDATE_B, replace=False).astype(np.int32)
    _, del_s = timed(torch, lambda: idx.delete(victims))

    gone = set(victims.tolist())
    for sched in ("batched", "per_query"):
        d, v = search(sched)
        check(not gone & set(v.reshape(-1).tolist()), f"[{cell}] {sched} returned a deleted vid")
        if rerank:
            exact_err[f"{sched}@{nprobe} after updates"] = check_exact(
                np, data, queries, d, v, f"{sched} after updates")
    found = 0
    for s in range(0, n_ins, SEARCH_Q):
        d, v = search("batched", fresh[s:s + SEARCH_Q])
        found += int((v == ins_vids[s:s + SEARCH_Q, None]).any(axis=1).sum())
        if rerank:
            check_exact(np, data, fresh[s:s + SEARCH_Q], d, v, "inserted vectors' search")
    self_frac = found / n_ins
    log(f"[{cell}] after updates: no deleted vid returned; inserted vectors in their own "
        f"top-10: {self_frac:.4f}")
    check(self_frac >= 0.95, f"[{cell}] only {self_frac} of the inserts find themselves")
    ins_rate = n_ins / sum(ins_s)
    del_rate = UPDATE_B / del_s
    if index_cells is not None:
        vecs = torch.as_tensor(np.asarray(fresh[:UPDATE_B], np.float32), device=device)
        fp32_index_cells(torch, index_cells, idx.state, q_t, vecs, device=device)
    report.update(recall_at_10=recall, recall_floor=floor, oracle_overlap=ov,
                  navigate_overlap=nav_overlap, search_p50_ms=p50,
                  kernels_inside_one_search=in_search, insert_rows_per_s=ins_rate,
                  delete_rows_per_s=del_rate, insert_self_top10=self_frac,
                  exact_distance_max_err=exact_err, stats=idx.stats())
    return p50, ins_rate, del_rate


# ---------------------------------------------------------------------------
# the update path: inserts past posting capacity, drained by the rebuilder
# ---------------------------------------------------------------------------

# Vectors the update path builds from, and the rows it then inserts.  A
# quarter of the main paths' N: recall on this generator falls as N grows
# (PERF.md §2), so its floor must come from the reference at the same N,
# and 250,000 is what the reference's CPU run reaches; at 1,000,000 the
# batched schedule's page budget also overflows (PERF.md §5).
UPDATE_N = 250_000
UPDATE_INSERT_BATCHES = 1
# Recall@10 of the JAX reference on the CPU after the same sequence on the
# same data (build from UPDATE_N vectors, insert UPDATE_B rows past
# capacity with backpressure, delete UPDATE_B, maintain), by nprobe
# (scripts/reference_recall.py, cell "update"); the port must reach each
# minus RECALL_MARGIN.
REFERENCE_RECALL_UPDATE_250K = {1: 0.417578125, 64: 0.9265625000000002}

# The serve path's cooperative phase: SERVE_STEPS steps, each one search
# ticket of SERVE_SEARCH_ROWS queries (cycling through the path's queries)
# and one insert ticket (the rows the update path deleted, under fresh
# vids), every SERVE_DELETE_EVERY-th step also a delete ticket of as many
# live base vids; the engine runs the paper's 2:1 pipeline.
SERVE_STEPS = 64
SERVE_SEARCH_ROWS = 128
SERVE_DELETE_EVERY = 4
SERVE_ENGINE = dict(search_k=10, max_batch=1024, min_bucket=8, policy="ratio",
                    fg_bg_ratio=2, maintain_budget=8, max_insert_retries=4)
# The grouped path: two-level routing at the reference's geometry
# (repro/configs/spfresh.py: 512 groups of 256, gprobe 32).
GROUPED = dict(n_groups=512, capacity=256, gprobe=32)


def serve_requests(np, seed, n, victims, queries, data, *, steps=SERVE_STEPS):
    """The cooperative phase's requests after the update path (build from
    ``n`` rows of ``data``, insert ``len(victims)`` rows under vids ``n..``,
    delete base vids ``victims``).  Returns ``{"steps": [[(op, array,
    vids)], ...], "ids": live vids after the phase, "rows": their vectors,
    "inserted": vids, "deleted": vids}``; each step's tickets are submitted
    in order.  The JAX reference runs the same requests
    (``scripts/reference_recall.py``, cell ``serve``)."""
    n_upd = len(victims)
    per = n_upd // steps
    rows_by_vid = np.concatenate([data[:n + n_upd], data[victims]])
    ins_vids = np.arange(n + n_upd, n + n_upd + steps * per, dtype=np.int32)
    alive = np.setdiff1d(np.arange(n), victims)
    n_del = (steps // SERVE_DELETE_EVERY) * per
    dels = np.random.default_rng(seed + 11).choice(alive, size=n_del, replace=False)
    dels = dels.astype(np.int32)
    out, d = [], 0
    for i in range(steps):
        q0 = (i * SERVE_SEARCH_ROWS) % len(queries)
        step = [("search", queries[q0:q0 + SERVE_SEARCH_ROWS], None),
                ("insert", rows_by_vid[ins_vids[i * per:(i + 1) * per]],
                 ins_vids[i * per:(i + 1) * per])]
        if i % SERVE_DELETE_EVERY == SERVE_DELETE_EVERY - 1:
            step.append(("delete", None, dels[d:d + per]))
            d += per
        out.append(step)
    keep = np.ones(len(rows_by_vid), bool)
    keep[victims] = False
    keep[dels] = False
    keep[ins_vids[-1] + 1:] = False
    ids = np.flatnonzero(keep)
    return {"steps": out, "ids": ids, "rows": rows_by_vid[ids], "inserted": ins_vids,
            "deleted": dels}


def live_vids(torch, state):
    """The vids with a live replica (stored version current, not deleted)."""
    from repro_torch.storage import versionmap as vm

    vids = state.pool.block_vid.reshape(-1)
    ok = (vids >= 0) & ~vm.is_stale(state.versions, vids, state.pool.block_ver.reshape(-1))
    return torch.unique(vids[ok])


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True)`` for the block: PyTorch
    raises on any op it does not promise to be deterministic (on the card
    cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``, which ``main`` sets before
    CUDA starts)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def round_launches(torch, fn, card: bool):
    """Run ``fn`` once and count its launches: ``(aten ops dispatched, CUDA
    kernels in the profiler's trace, their summed device ms)``, the last
    two None where ``fn`` does not run on the card."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    prof = profile(activities=[ProfilerActivity.CUDA]) if card else contextlib.nullcontext()
    with prof:
        with Count():
            fn()
        if card:
            torch.cuda.synchronize()
    if not card:
        return Count.n, None, None
    on_card = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in on_card)
    return Count.n, sum(e.count for e in on_card), busy_us / 1e3


def update_path(torch, np, seed, report, *, cfg=None, device="cuda", n=None,
                n_insert=None, floors=None, carry=None):
    """The maintenance round's main path through ``SPFreshIndex``, on the
    reference's generator (``make_spacev_like`` in byte values): build from
    ``n`` vectors (most postings come out over ``split_limit``, filled by
    closure replicas), replay one round on a clone, insert ``n_insert``
    drifted rows (their postings are full: every chunk waits for
    backpressure drains), delete as many base rows, ``maintain()``, and
    search under both schedules.  The default floors hold for the default
    ``n`` only.  ``cfg``, ``n``, ``n_insert``, ``floors`` ({nprobe: recall
    floor}) and ``device="cpu"`` rehearse it without a card.  A ``carry``
    dict receives the index, its data, the deleted vids and the queries,
    for the serve path to take over."""
    from repro_torch.configs.spfresh import SEARCH_Q, UPDATE_B
    from repro_torch.core import lire
    from repro_torch.core.index import SPFreshIndex
    from repro_torch.data.vectors import make_queries, make_spacev_like_bytes
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.utils.tree import clone_state, tensor_leaves

    cfg = cfg or path_config("fp32")
    n = n or UPDATE_N
    n_ins = n_insert or UPDATE_INSERT_BATCHES * UPDATE_B
    if floors is None:
        floors = {1: REFERENCE_RECALL_UPDATE_250K[1] - RECALL_MARGIN,
                  cfg.nprobe: REFERENCE_RECALL_UPDATE_250K[64] - RECALL_MARGIN}
    k, nprobe = 10, cfg.nprobe
    data, gen_s = timed(torch, lambda: make_spacev_like_bytes(n + n_ins, cfg.dim, seed=seed))
    base, fresh = data[:n], data[n:]
    queries = make_queries(base, min(SEARCH_Q, n), seed=seed)
    log(f"[update] data: make_spacev_like in bytes, N={n} inserts={n_ins} d={cfg.dim} "
        f"codec={cfg.codec} made in {gen_s:.1f} s")

    idx, build_s = timed(torch, lambda: SPFreshIndex.build(cfg, base, seed=seed, device=device))
    st = idx.stats()
    lens = idx.state.pool.posting_len[idx.state.centroid_valid]
    log(f"[update] build: {build_s:.1f} s n_postings={st['n_postings']} used_blocks="
        f"{st['used_blocks']} backlog={idx.backlog()} (postings over split_limit "
        f"{cfg.split_limit}; {int((lens == cfg.posting_capacity).sum())} at capacity)")
    report.update(build_s=build_s, n=n, n_insert=n_ins, n_postings=st["n_postings"],
                  backlog_after_build=idx.backlog())

    # one round replayed on a clone of its input is bit-identical, both
    # under torch.use_deterministic_algorithms: an op PyTorch does not
    # promise to be deterministic raises (the runtime half of spflint's
    # SPF107)
    before = clone_state(idx.state)
    with deterministic_algorithms(torch):
        did, round_s = timed(torch, idx.maintain_round)
        check(did > 0, "[update] the first round after the build did no work")
        after = tensor_leaves(idx.state)
        replay = SPFreshIndex(before)
        ops, kernels, busy_ms = round_launches(torch, lambda: replay.maintain_round(),
                                               card=device != "cpu")
    for name, t in tensor_leaves(replay.state).items():
        check(bool(torch.equal(t, after[name])), f"[update] round replay differs in {name}")
    del replay, before, after
    log(f"[update] one round ({did} jobs, {round_s * 1e3:.1f} ms, deterministic algorithms "
        f"on): replay on a clone is bit-identical; {ops} aten ops dispatched, {kernels} CUDA kernels launched, "
        f"busy on the card {busy_ms} ms (profiler)")
    report.update(first_round_jobs=did, first_round_ms=round_s * 1e3,
                  round_aten_ops=ops, round_cuda_kernels=kernels, round_device_ms=busy_ms)

    # inserts: every drain the backpressure runs is timed and counted
    drains = dict(calls=0, rounds=0, jobs=0, s=0.0, l2_topk_launches=0)
    drain = idx.maintain

    def counted_drain(*a, **kw):
        l0 = LK.LAUNCHES["l2_topk_tiles"]
        jobs, s = timed(torch, lambda: drain(*a, **kw))
        drains.update(calls=drains["calls"] + 1, rounds=drains["rounds"] + idx.last_drain_rounds,
                      jobs=drains["jobs"] + jobs, s=drains["s"] + s,
                      l2_topk_launches=drains["l2_topk_launches"]
                      + LK.LAUNCHES["l2_topk_tiles"] - l0)
        return jobs

    idx.maintain = counted_drain
    ins_vids = np.arange(n, n + n_ins, dtype=np.int32)
    _, ins_s = timed(torch, lambda: idx.insert(fresh, ins_vids))
    del idx.maintain
    check(drains["rounds"] > 0, "[update] no insert waited for a backpressure drain")
    if device == "cuda":
        check(drains["l2_topk_launches"] > 0, "[update] #1 was not launched in the drains")
    st = idx.stats()
    check(st["n_inserts"] == n_ins + idx.retried_rows,
          f"[update] {st['n_inserts']} inserts counted, {n_ins} sent + {idx.retried_rows} retried")
    live = live_vids(torch, idx.state).cpu().numpy()
    missing = np.setdiff1d(ins_vids, live)
    check(missing.size == 0, f"[update] {missing.size} inserted rows are not live")
    ms_round = drains["s"] * 1e3 / drains["rounds"]
    idle = None if busy_ms is None else 1.0 - busy_ms / ms_round
    log(f"[update] insert: {n_ins} rows in {ins_s:.1f} s ({n_ins / ins_s:.0f} rows/s with the "
        f"drains); {drains['calls']} backpressure drains, {drains['rounds']} rounds, "
        f"{drains['jobs']} jobs, {drains['s']:.1f} s ({ms_round:.2f} ms a round; the card idle "
        f"{idle} of it by the profiled round), #1 launched {drains['l2_topk_launches']} times in "
        f"them; {idx.retried_rows} rows retried; every inserted vid is live at its current "
        "version")

    rng = np.random.default_rng(seed + 7)
    victims = rng.choice(n, size=n_ins, replace=False).astype(np.int32)
    _, del_s = timed(torch, lambda: idx.delete(victims))
    jobs, maint_s = timed(torch, idx.maintain)
    lens = idx.state.pool.posting_len[idx.state.centroid_valid]
    check(idx.backlog() == 0, f"[update] backlog {idx.backlog()} after maintain()")
    check(int(lens.max()) <= cfg.split_limit, "[update] a posting is over split_limit")
    st = idx.stats()
    log(f"[update] delete {n_ins} rows in {del_s:.2f} s; maintain(): {jobs} jobs in "
        f"{idx.last_drain_rounds} rounds, {maint_s:.1f} s; backlog 0, longest posting "
        f"{int(lens.max())}; n_splits={st['n_splits']} n_merges={st['n_merges']} "
        f"n_reassigned={st['n_reassigned']} n_reassign_overflow={st['n_reassign_overflow']} "
        f"n_postings={st['n_postings']}")

    q_t = torch.as_tensor(queries, device=device)
    for name, v in lire.scan_page_stats(idx.state, q_t, nprobe=nprobe).items():
        report[f"page_stats_{name}"] = int(v)
    log(f"[update] scan_page_stats (Q={len(queries)}, budget {cfg.scan_page_budget}): "
        + " ".join(f"{s}={report['page_stats_' + s]}" for s in ("n_pages", "n_unique", "overflow")))

    keep = np.ones(n + n_ins, bool)
    keep[victims] = False
    ids = np.flatnonzero(keep)
    live_t = torch.as_tensor(data[ids], device=device)
    gone = set(victims.tolist())
    recall = {}
    for sched in ("batched", "per_query"):
        for probes in (nprobe, 1):
            _, v = idx.search_padded(queries, k, nprobe=probes, use_pallas_scan=True,
                                     scan_schedule=sched)
            check(not gone & set(v.reshape(-1).tolist()), f"[update] {sched} returned a deleted vid")
            recall[f"{sched}@{probes}"] = recall_at_10(torch, live_t, queries, v, ids)
    floor = {key: floors[int(key.split("@")[1])] for key in recall}
    log(f"[update] recall@10 (schedule@nprobe): {recall} floors {floor}")
    for key, r in recall.items():
        check(r >= floor[key], f"[update] recall@10 {r} of {key} below the floor {floor[key]}")
    found = 0
    for s in range(0, n_ins, SEARCH_Q):
        _, v = idx.search_padded(fresh[s:s + SEARCH_Q], k, nprobe=nprobe,
                                 use_pallas_scan=True, scan_schedule="batched")
        found += int((v == ins_vids[s:s + SEARCH_Q, None]).any(axis=1).sum())
    self_frac = found / n_ins
    log(f"[update] no deleted vid returned; inserted vectors in their own top-10: {self_frac:.4f}")
    check(self_frac >= 0.95, f"[update] only {self_frac} of the inserts find themselves")
    report.update(drains=drains, drain_ms_per_round=ms_round, drain_idle_share=idle,
                  insert_s=ins_s,
                  insert_rows_per_s_with_drains=n_ins / ins_s, delete_s=del_s,
                  maintain_jobs=jobs, maintain_rounds=idx.last_drain_rounds, maintain_s=maint_s,
                  recall_at_10=recall, recall_floor=floor, insert_self_top10=self_frac,
                  stats=st)
    if carry is not None:
        carry.update(idx=idx, data=data, victims=victims, queries=queries, n=n)
    return drains, ms_round


# ---------------------------------------------------------------------------
# the serve path: the engine over the update path's index, and the grouped
# search
# ---------------------------------------------------------------------------

# Recall@10 of the JAX reference on the CPU after the update path and the
# cooperative phase's requests through its ServeEngine, then drain(), by
# nprobe, and of its search_grouped at GROUPED's geometry
# (scripts/reference_recall.py, cell "serve"); the port must reach each
# minus RECALL_MARGIN.
REFERENCE_RECALL_SERVE_250K = {1: 0.4193359375, 64: 0.92646484375, "grouped": 0.9265625000000001}
# the async phase: submitter threads, operations each (cut from 200 with the
# gnn and lm_train paths, for the smoke's time budget), rows per request
ASYNC_THREADS = 4
ASYNC_OPS = 50
ASYNC_ROWS = 64
ASYNC_MISS_LIMIT = 0.05
JOIN_S = 600


def submit_step(engine, step):
    """Submit one step's tickets in order, then wait for each."""
    tickets = []
    for op, arr, vids in step:
        if op == "search":
            tickets.append(engine.submit_search(arr))
        elif op == "insert":
            tickets.append(engine.submit_insert(arr, vids))
        else:
            tickets.append(engine.submit_delete(vids))
    return [t.result(timeout=JOIN_S) for t in tickets]


def async_clients(np, engine, vecs_for, n_threads, ops_each, *, vid0, stride, max_rows,
                  pool, k=10, nprobe=None, seed=100, on_update=None):
    """Drive ``engine`` from ``n_threads`` submitter threads of ``ops_each``
    operations, each thread from its own seed: 50% searches of 1 to
    ``max_rows`` queries (the thread's own live vectors, its last deleted
    ones, the rest from ``pool``), 30% inserts of 1 to ``max_rows`` rows
    (``vecs_for(rng, m)``, fresh vids from ``vid0 + stride * thread``), 20%
    deletes of its own live vids.  Every ticket is awaited.

    A search ticket carries the backend's applied dispatch seqno when it
    was dispatched, an update ticket the seqno once it ran.  An own live
    vector whose vid is not in its search's top-``k`` is an ordering
    violation when the search was dispatched before the insert (its
    submitter had awaited the insert before it submitted the search), and
    an ANN miss otherwise; a deleted vid in a search dispatched after the
    delete is a resurrection.  ``on_update(ticket)`` is called with each
    update ticket as soon as its ``result`` returns.  Returns ``(tally,
    live, dead)``: the counts, and per thread ``{vid: vector}`` of the
    rows alive and deleted."""
    import threading

    tally = {"violations": 0, "resurrected": 0, "misses": 0, "checks": 0, "ops": 0}
    lock = threading.Lock()
    errors = []
    live_sets = [{} for _ in range(n_threads)]
    dead_sets = [{} for _ in range(n_threads)]

    def worker(tid):
        trng = np.random.default_rng(seed + tid)
        vid = vid0 + stride * tid
        live, dead = live_sets[tid], dead_sets[tid]      # vid -> (vector, seqno)
        try:
            for _ in range(ops_each):
                op = trng.integers(0, 10)
                m = int(trng.integers(1, max_rows + 1))
                if op < 3 or not live:
                    ids = np.arange(vid, vid + m, dtype=np.int32)
                    vecs = vecs_for(trng, m)
                    tk = engine.submit_insert(vecs, ids)
                    _, landed = tk.result(timeout=JOIN_S)
                    if on_update is not None:
                        on_update(tk)
                    if not landed.all():
                        raise AssertionError(f"thread {tid}: an insert was dropped")
                    for j in range(m):
                        live[int(ids[j])] = (vecs[j], tk.seqno)
                    vid += m
                elif op < 8:
                    own = sorted(live)
                    picks = [int(p) for p in trng.choice(own, size=min(len(own), m),
                                                         replace=False)]
                    gone = sorted(dead)[-min(4, m - len(picks)):] if m > len(picks) else []
                    rest = m - len(picks) - len(gone)
                    q = np.concatenate(
                        [np.stack([live[p][0] for p in picks] + [dead[g][0] for g in gone]),
                         pool[trng.integers(0, len(pool), rest)]]).astype(np.float32)
                    tk = engine.submit_search(q, k=k, nprobe=nprobe)
                    _, hit = tk.result(timeout=JOIN_S)
                    with lock:
                        for row, p in enumerate(picks):
                            tally["checks"] += 1
                            if p in hit[row].tolist():
                                continue
                            key = "violations" if tk.seqno < live[p][1] else "misses"
                            tally[key] += 1
                        for row, g in enumerate(gone, start=len(picks)):
                            if tk.seqno >= dead[g][1] and g in hit[row].tolist():
                                tally["resurrected"] += 1
                else:
                    own = sorted(live)
                    picks = trng.choice(own, size=min(len(own), m), replace=False)
                    tk = engine.submit_delete(picks.astype(np.int32))
                    tk.result(timeout=JOIN_S)
                    if on_update is not None:
                        on_update(tk)
                    for p in picks:
                        dead[int(p)] = (live.pop(int(p))[0], tk.seqno)
                with lock:
                    tally["ops"] += 1
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    hung = [t.name for t in threads if t.is_alive()]
    check(not hung, f"submitter threads outlived their join timeout: {hung}")
    if errors:
        raise errors[0]
    check(tally["ops"] == n_threads * ops_each, f"only {tally['ops']} operations ran")
    live = {v: x for s in live_sets for v, (x, _) in s.items()}
    dead = {v: x for s in dead_sets for v, (x, _) in s.items()}
    return tally, live, dead


def device_busy(torch, np, fn, card: bool):
    """``(fn(), device busy ms, wall ms, device activities)``: the union of
    the card's activity intervals (kernels, copies) in the profiler's trace
    over ``fn``, read from the raw trace (building the profiler's event
    tables for ~10^5 kernels would take minutes).  None without a card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA]) if card else contextlib.nullcontext()
    with prof:
        out, wall_s = timed(torch, fn)
    if not card:
        return out, None, wall_s * 1e3, None
    spans = np.array([(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                      if str(e.device_type()).endswith("CUDA")], np.int64).reshape(-1, 2)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    reach = np.maximum.accumulate(spans[:, 1])
    starts = np.concatenate([[True], spans[1:, 0] > reach[:-1]])   # a new busy run
    run_id = np.cumsum(starts) - 1
    run_end = np.zeros(int(starts.sum()), np.int64)
    np.maximum.at(run_end, run_id, spans[:, 1])
    busy_ns = int((run_end - spans[starts, 0]).sum())
    return out, busy_ns / 1e6, wall_s * 1e3, len(spans)


def same_leaves(torch, a, b, what):
    from repro_torch.utils.tree import tensor_leaves

    ta, tb = tensor_leaves(a), tensor_leaves(b)
    bad = [name for name in ta if not torch.equal(ta[name], tb[name])]
    check(not bad, f"{what}: replay differs in {bad}")


def dispatch_is_deferred(torch, np, idx, queries, k, nprobe):
    """Per schedule: one ``search_begin`` under ``set_sync_debug_mode
    ("error")`` (a host sync raises) behind a ~0.2 s device sleep, which
    must still be running when it returns; its readback must equal the
    blocking search.  Returns the host ms of each dispatch."""
    from repro_torch.serve import LocalBackend

    out = {}
    valid = np.ones(len(queries), bool)
    for sched in ("batched", "per_query"):
        be = LocalBackend(idx, use_pallas_scan=True, scan_schedule=sched)
        want = idx.search_padded(queries, k, nprobe=nprobe, use_pallas_scan=True,
                                 scan_schedule=sched)
        be.search(queries, k, nprobe, valid)        # the pinned buffers are cached now
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fin = be.search_begin(queries, k, nprobe, valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[sched] = (time.perf_counter() - t0) * 1e3
        pending = not torch.cuda.current_stream().query()
        check(pending, f"{sched}: the device finished before search_begin returned")
        d, v = fin()
        check(bool(np.array_equal(d, want[0]) and np.array_equal(v, want[1])),
              f"{sched}: the deferred readback differs from the blocking search")
    return out


def serve_path(torch, np, seed, report, carry, *, device="cuda", steps=SERVE_STEPS,
               threads=ASYNC_THREADS, ops_each=ASYNC_OPS, async_rows=ASYNC_ROWS,
               floors=None):
    """The serving engine over the update path's index (``carry``, after
    its ``maintain()`` and searches).

    Cooperative phase: ``serve_requests`` through ``ServeEngine`` (the
    paper's 2:1 pipeline, the configured ``batched`` scan), ``drain()``;
    the recorded dispatch stream replayed on a clone of the starting state
    must be bit-identical, ``engine.search`` must equal ``search_padded``
    bit for bit, recall at nprobe 64 and 1 must reach ``floors`` (the
    reference's after the same requests), no deleted vid may be returned,
    the inserted rows must find themselves, and the counters must add up.
    Async phase: a pump thread (``per_query`` scan, deferred readback,
    ``lock_check``) fed by ``threads`` submitter threads
    (:func:`async_clients`): no ordering violation, no resurrection, ANN
    misses at most ``ASYNC_MISS_LIMIT``, the stream replays bit-identically
    again.  Returns the live ``(vids, rows)`` for the grouped path."""
    from repro_torch.core.index import SPFreshIndex
    from repro_torch.serve import EngineConfig, LocalBackend, ServeEngine
    from repro_torch.storage.durability import RecordingSink
    from repro_torch.utils.tree import clone_state

    idx, data, victims, queries, n = (carry[key] for key in
                                      ("idx", "data", "victims", "queries", "n"))
    cfg = idx.state.cfg
    k, nprobe = SERVE_ENGINE["search_k"], cfg.nprobe
    if floors is None:
        floors = {1: REFERENCE_RECALL_SERVE_250K[1] - RECALL_MARGIN,
                  nprobe: REFERENCE_RECALL_SERVE_250K[64] - RECALL_MARGIN}
    reqs = serve_requests(np, seed, n, victims, queries, data, steps=steps)
    n_rows = len(reqs["inserted"])
    stages, mark = {}, [time.perf_counter()]

    def lap(name):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - mark[0]
        mark[0] = now

    # ---- cooperative phase
    engine = ServeEngine(idx, EngineConfig(nprobe=nprobe, **SERVE_ENGINE))
    st0 = idx.stats()
    before = clone_state(idx.state)
    sink = RecordingSink()
    engine.backend.attach_replication(sink)
    lap("setup")
    _, coop_s = timed(torch, lambda: [submit_step(engine, st) for st in reqs["steps"]])
    jobs, drain_s = timed(torch, engine.drain)
    rep = engine.report()
    st = idx.stats()
    check(rep["backlog"] == 0, f"[serve] backlog {rep['backlog']} after drain()")
    check(rep["insert_dropped"] == 0, f"[serve] {rep['insert_dropped']} insert rows dropped")
    sent = sum(int(r.payload["valid"].sum()) for r in sink.records if r.op == "insert")
    check(st["n_inserts"] - st0["n_inserts"] == sent and sent >= n_rows,
          f"[serve] n_inserts grew by {st['n_inserts'] - st0['n_inserts']}, {n_rows} rows "
          f"sent and {sent - n_rows} retried")
    check(st["n_deletes"] - st0["n_deletes"] == len(reqs["deleted"]),
          "[serve] n_deletes does not match the deletes sent")
    lap("cooperative")
    twin = LocalBackend(SPFreshIndex(before), track_access=False)
    _, replay_s = timed(torch, lambda: twin.replay(sink.records))
    same_leaves(torch, twin.index.state, idx.state, "[serve] cooperative phase")
    del twin, before
    ops = {op: sum(r.op == op for r in sink.records)
           for op in ("insert", "delete", "maintain", "drain")}
    log(f"[serve] cooperative: {steps} steps ({steps * SERVE_SEARCH_ROWS} queries, {n_rows} "
        f"inserted rows, {len(reqs['deleted'])} deletes) in {coop_s:.2f} s, drain() {jobs} jobs "
        f"in {drain_s:.2f} s; {len(sink.records)} dispatches logged {ops}; replay on a clone of "
        f"the starting state ({replay_s:.2f} s) is bit-identical")

    lap("cooperative_replay")
    q_all = queries[:SERVE_ENGINE["max_batch"]]
    d_e, v_e = engine.search(q_all)
    d_i, v_i = idx.search_padded(q_all, k, nprobe=nprobe)
    check(bool(np.array_equal(d_e, d_i) and np.array_equal(v_e, v_i)),
          "[serve] engine.search differs from search_padded")
    live_t = torch.as_tensor(reqs["rows"], device=device)
    gone = set(victims.tolist()) | set(reqs["deleted"].tolist())
    recall = {}
    for probes in (nprobe, 1):
        _, v = engine.search(queries, nprobe=probes)
        check(not gone & set(v.reshape(-1).tolist()), "[serve] a deleted vid was returned")
        recall[probes] = recall_at_10(torch, live_t, queries, v, reqs["ids"])
    log(f"[serve] engine.search equals search_padded bit for bit; recall@10 by nprobe "
        f"{recall}, floors {floors}")
    for probes, r in recall.items():
        check(r >= floors[probes], f"[serve] recall@10 {r} at nprobe {probes} below "
              f"{floors[probes]}")
    rows_by_vid = np.concatenate([data, data[victims]])
    found = 0
    for s in range(0, n_rows, len(q_all)):
        vids = reqs["inserted"][s:s + len(q_all)]
        _, v = engine.search(rows_by_vid[vids])
        found += int((v == vids[:, None]).any(axis=1).sum())
    self_frac = found / n_rows
    check(self_frac >= 0.95, f"[serve] only {self_frac} of the inserted rows find themselves")
    coop = dict(seconds=coop_s, drain_s=drain_s, drain_jobs=jobs, replay_s=replay_s,
                dispatches=ops, rows_sent=n_rows, rows_retried=sent - n_rows,
                recall_at_10=recall, recall_floor=floors, insert_self_top10=self_frac,
                report=rep, queries_per_s=steps * SERVE_SEARCH_ROWS / coop_s,
                insert_rows_per_s=n_rows / coop_s)
    lap("cooperative_checks")
    if device == "cuda":
        coop["search_begin_host_ms"] = dispatch_is_deferred(torch, np, idx, q_all, k, nprobe)
        log(f"[serve] search_begin under set_sync_debug_mode('error') returns while the "
            f"card still works, host ms {coop['search_begin_host_ms']}; its readback equals "
            "the blocking search")

    lap("deferred_check")
    # ---- async phase
    acfg = EngineConfig(nprobe=nprobe, async_serve=True, max_wait_ms=1.0, max_inflight=2,
                        lock_check=True, scan_schedule="per_query", **SERVE_ENGINE)
    engine = ServeEngine(idx, acfg)
    st0 = idx.stats()
    before = clone_state(idx.state)
    sink = RecordingSink()
    engine.backend.attach_replication(sink)
    base_rows = data[:n]

    def vecs_for(trng, m):
        rows = base_rows[trng.integers(0, n, m)] + trng.integers(-3, 4, (m, base_rows.shape[1]))
        return np.clip(rows, -127, 127).astype(np.float32)

    def clients():
        return async_clients(np, engine, vecs_for, threads, ops_each,
                             vid0=int(reqs["inserted"][-1]) + 1, stride=ops_each * async_rows,
                             max_rows=async_rows, pool=queries, k=k, seed=seed + 100)

    try:
        (tally, live, dead), busy_ms, wall_ms, n_act = device_busy(torch, np, clients,
                                                                   device == "cuda")
        engine.pump()
        check(engine._pump_error is None, "[serve] the pump thread died")
        arep = engine.report()
    finally:
        engine.shutdown(timeout=JOIN_S)
    lap("async")
    st = idx.stats()
    sent = sum(int(r.payload["valid"].sum()) for r in sink.records if r.op == "insert")
    n_ins = len(live) + len(dead)
    check(tally["violations"] == 0, f"[serve] {tally['violations']} ordering violations")
    check(tally["resurrected"] == 0, f"[serve] {tally['resurrected']} deleted vids returned")
    check(tally["misses"] <= ASYNC_MISS_LIMIT * tally["checks"],
          f"[serve] {tally['misses']} ANN misses in {tally['checks']} checks")
    check(arep["insert_dropped"] == 0, "[serve] async insert rows dropped")
    check(st["n_inserts"] - st0["n_inserts"] == sent and sent >= n_ins,
          "[serve] async n_inserts is not the rows sent plus retried")
    check(st["n_deletes"] - st0["n_deletes"] == len(dead), "[serve] async n_deletes differs")
    twin = LocalBackend(SPFreshIndex(before), track_access=False)
    twin.replay(sink.records)
    same_leaves(torch, twin.index.state, idx.state, "[serve] async phase")
    del twin, before
    gone_t = np.asarray(sorted(dead), np.int64)
    if gone_t.size:
        _, v = ServeEngine(idx, EngineConfig(nprobe=nprobe, **SERVE_ENGINE)).search(
            np.stack([dead[int(g)] for g in gone_t]))
        check(not set(gone_t.tolist()) & set(v.reshape(-1).tolist()),
              "[serve] a vid deleted in the async phase came back")
    lap("async_replay_and_checks")
    busy = None if busy_ms is None else busy_ms / wall_ms
    log(f"[serve] async: {threads} threads x {ops_each} ops in {wall_ms / 1e3:.2f} s; "
        f"{tally['checks']} visibility checks: {tally['violations']} ordering violations, "
        f"{tally['misses']} ANN misses, {tally['resurrected']} resurrections; {len(dead)} "
        f"deletes stay gone; replay bit-identical; card busy {busy} of the phase ({n_act} "
        f"activities in the profiler's trace); "
        f"stage seconds {({k: round(v, 2) for k, v in stages.items()})}")
    report.update(cooperative=coop, async_phase=dict(
        seconds=wall_ms / 1e3, tally=tally, report=arep, device_busy_ms=busy_ms,
        device_activities=n_act,
        device_busy_share=busy, rows_inserted=n_ins, rows_deleted=len(dead),
        dispatches=len(sink.records)), stage_s=stages)
    ids = np.concatenate([reqs["ids"], np.asarray(sorted(live), np.int64)])
    rows = np.concatenate([reqs["rows"]] + ([np.stack([live[v] for v in sorted(live)])]
                                            if live else []))
    return ids, rows


def grouped_path(torch, np, seed, report, carry, ids, rows, *, device="cuda",
                 grouped=GROUPED, floor=None, index_cells=None):
    """Two-level routing on the serve path's final state: a group index of
    ``grouped``'s geometry; ``navigate_grouped`` over every group against
    the flat ``navigate`` (#1) on 64 queries (distances within 1e-4
    relative, probe overlap > 0.9, the reference test's criteria); then
    ``search_grouped`` at ``gprobe`` on the path's queries, recall@10 at
    least ``floor``.  Given a dict ``index_cells``, spfresh-1b's
    ``serve_search_grouped`` cell then runs on the state and the group
    index (at the cell's gprobe, 32)."""
    from repro_torch.core import grouping, lire
    from repro_torch.kernels.l2_topk import kernel as LK

    idx, queries = carry["idx"], carry["queries"]
    state, nprobe, k = idx.state, idx.state.cfg.nprobe, 10
    if floor is None:
        floor = REFERENCE_RECALL_SERVE_250K["grouped"] - RECALL_MARGIN
    gidx, build_s = timed(torch, lambda: grouping.build_group_index(
        state, n_groups=grouped["n_groups"], capacity=grouped["capacity"], seed=seed))
    q64 = torch.as_tensor(queries[:64], device=device)
    saved = dict(LK.LAUNCHES)
    d0, p0 = lire.navigate(state, q64, nprobe)
    LK.LAUNCHES.update(saved)
    (d1, p1), full_s = timed(torch, lambda: grouping.navigate_grouped(
        state, gidx, q64, nprobe=nprobe, gprobe=grouped["n_groups"]))
    # navigate expands ||q||^2 - 2 q.c + ||c||^2 in f32, level 2 takes
    # diff²: the reference test's 1e-4 relative and 1e-4 absolute at unit
    # scale (||q||^2 ~ 16), with the absolute part scaled by ||q||^2
    qsq = torch.sum(q64 * q64, dim=1, keepdim=True)
    live = p0 >= 0
    excess = ((d1 - d0).abs() - 1e-4 * d0.abs() - 1e-5 * qsq)[live]
    err = ((d1 - d0).abs() / d0.abs().clamp(min=1e-6))[live].max().item()
    check(bool((excess <= 0).all()), f"[grouped] full-gprobe distances differ from navigate "
          f"by more than 1e-4 |d| + 1e-5 ||q||^2 (max rel err {err})")
    ov = overlap(p0.cpu().numpy(), p1.cpu().numpy())
    check(ov > 0.9, f"[grouped] full-gprobe probes overlap navigate by {ov}")
    q_t = torch.as_tensor(queries, device=device)
    (_, v), search_s = timed(torch, lambda: grouping.search_grouped(
        state, gidx, q_t, k=k, nprobe=nprobe, gprobe=grouped["gprobe"]))
    recall = recall_at_10(torch, torch.as_tensor(rows, device=device), queries,
                          v.cpu().numpy(), ids)
    log(f"[grouped] group index {grouped['n_groups']} x {grouped['capacity']} built in "
        f"{build_s:.2f} s; gprobe={grouped['n_groups']} vs navigate on 64 queries: within "
        f"1e-4 |d| + 1e-5 ||q||^2 (max rel err {err:.3g}), overlap {ov:.4f} ({full_s * 1e3:.1f} ms); search_grouped at gprobe "
        f"{grouped['gprobe']} on {len(queries)} queries in {search_s * 1e3:.1f} ms: recall@10 "
        f"{recall} (floor {floor})")
    check(recall >= floor, f"[grouped] recall@10 {recall} below {floor}")
    if index_cells is not None:
        from repro_torch.configs.spfresh import GPROBE

        alive = torch.ones(1, dtype=torch.bool, device=device)
        check_index_cell(torch, index_cells, "spfresh-1b", "serve_search_grouped",
                         ([state], q_t, alive, [gidx]),
                         lambda: grouping.search_grouped(state, gidx, q_t, k=k, nprobe=nprobe,
                                                         gprobe=GPROBE), device=device)
    report.update(build_s=build_s, full_gprobe_rel_err=err, full_gprobe_overlap=ov,
                  search_ms=search_s * 1e3, recall_at_10=recall, recall_floor=floor,
                  geometry=grouped)
    return recall


# ---------------------------------------------------------------------------
# the durable path: a durable service through crash and recovery
# ---------------------------------------------------------------------------

# Cooperative request steps (``serve_requests``' steps: a 128-query search,
# a 64-row insert, every 4th step a 64-vid delete); the delta checkpoint
# falls after the first DURABLE_DELTA_AT of them, the rest leave the WAL
# tail.  The async phase: submitter threads, operations each, rows per
# request; update dispatches per WAL fsync window.
DURABLE_STEPS = 32
DURABLE_DELTA_AT = 16
# vectors the durable service is built from: cut from UPDATE_N with the gnn
# and lm_train paths, for the smoke's time budget (PERF.md section 4: its
# open and drain took 47.5 + 49.8 s at 250,000 on a slow host)
DURABLE_N = 125_000
DURABLE_THREADS = 4
DURABLE_OPS = 50
DURABLE_ROWS = 16
DURABLE_GROUP_COMMIT = 8


def fs_type(path) -> str:
    """The filesystem type of the mount holding ``path`` (/proc/mounts)."""
    import os

    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return f"{kind} ({best})"


def durable_path(torch, np, seed, report, *, cfg=None, device="cuda", n=None,
                 steps=DURABLE_STEPS, delta_at=DURABLE_DELTA_AT, threads=DURABLE_THREADS,
                 ops_each=DURABLE_OPS, async_rows=DURABLE_ROWS, root_dir=None):
    """A durable service (``repro_torch.api``) through crash and recovery at
    the update cell's geometry, on the reference's generator.

    Set-up: ``api.open(service_spec(durable_root=...), vectors=base)``
    builds and writes the open-time base unit; ``drain()`` runs the build's
    split backlog down and ``checkpoint(delta=False)`` re-bases.
    Cooperative phase (``group_commit``): ``delta_at`` of ``serve_requests``'
    steps through ``svc.search`` / ``insert`` / ``delete``, a delta
    checkpoint, the remaining steps (the WAL tail), a clone of the state and
    one Q=1024 search; then a crash (the engine stops: no checkpoint, no
    close) and ``api.open(spec)``: every leaf bit-identical, the same ids,
    distances within tolerance, no deleted vid returned.  Async phase: the
    recovered service checkpoints a second delta, reopens with the pump
    thread and the ``per_query`` scan, takes ``threads`` submitter threads
    (:func:`async_clients`) — no update ticket may resolve before the fsync
    that covers its seqno — and crashes and recovers bit-identically again.
    The durable root is a temporary directory under ``root_dir`` (default
    the checkout's ``build/``), removed at the end."""
    import os
    import shutil
    import tempfile

    from repro_torch import api
    from repro_torch.configs.spfresh import SEARCH_Q, service_spec
    from repro_torch.data.vectors import make_queries, make_spacev_like_bytes
    from repro_torch.utils.tree import clone_state

    cfg = cfg or path_config("fp32")
    n = n or DURABLE_N
    k = 10
    n_fresh = steps * (SERVE_SEARCH_ROWS // 2)
    data, gen_s = timed(torch, lambda: make_spacev_like_bytes(n + n_fresh, cfg.dim, seed=seed))
    base = data[:n]
    queries = make_queries(base, min(SEARCH_Q, n), seed=seed)
    # the fresh rows data[n:] are not in the index: serve_requests re-sends
    # its "victims" under fresh vids, so they stand in for them here
    reqs = serve_requests(np, seed, n, np.arange(n, n + n_fresh), queries, data, steps=steps)
    parent = root_dir or ROOT / "build"
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="durable_", dir=parent)
    fs = fs_type(root)
    spec = service_spec(durable_root=root)
    spec = dataclasses.replace(
        spec, index=api.IndexSpec(config=cfg),
        durability=dataclasses.replace(spec.durability, group_commit=DURABLE_GROUP_COMMIT))
    aspec = dataclasses.replace(
        spec, serve=dataclasses.replace(spec.serve, async_serve=True, max_wait_ms=1.0),
        scan=dataclasses.replace(spec.scan, scan_schedule="per_query"))
    log(f"[durable] data: make_spacev_like in bytes, N={n} fresh={n_fresh} made in "
        f"{gen_s:.1f} s; durable root on {fs}")
    wal_sets, current = [], [None]

    def opened(sp, **kw):
        svc, s = timed(torch, lambda: api.open(sp, device=device, **kw))
        current[0] = svc
        wal_sets.append(svc.backend.wal_set)
        return svc, s

    def crash(svc):
        svc.engine.shutdown(timeout=JOIN_S)      # no checkpoint, no close
        current[0] = None

    try:
        # ---- set-up: build, open-time base, drain, re-base
        svc, open_s = opened(spec, vectors=base)
        base0 = dict(svc.last_checkpoint)
        jobs, drain_s = timed(torch, svc.drain)
        rounds = svc.index.last_drain_rounds
        check(svc.backlog() == 0, f"[durable] backlog {svc.backlog()} after drain()")
        _, rebase_s = timed(torch, lambda: svc.checkpoint(delta=False))
        rebase = dict(svc.last_checkpoint)
        log(f"[durable] open (build + open-time base {base0['bytes']} bytes in "
            f"{base0['seconds']:.2f} s) {open_s:.1f} s; drain() {jobs} jobs in {rounds} rounds, "
            f"{drain_s:.1f} s; "
            f"re-base {rebase['bytes']} bytes in {rebase['seconds']:.2f} s")

        # ---- cooperative phase
        def run(step_list):
            for step in step_list:
                for op, arr, vids in step:
                    if op == "search":
                        svc.search(arr)
                    elif op == "insert":
                        svc.insert(arr, vids)
                    else:
                        svc.delete(vids)

        ws = svc.backend.wal_set
        wal_file = ws.shard_path(0)
        _, head_s = timed(torch, lambda: run(reqs["steps"][:delta_at]))
        head_stats = ws.stats()
        head_wal_bytes = os.path.getsize(wal_file)
        svc.checkpoint(delta=True)
        delta = dict(svc.last_checkpoint)
        check(delta["unit"].startswith("delta-"), f"[durable] {delta['unit']} is not a delta")
        _, tail_s = timed(torch, lambda: run(reqs["steps"][delta_at:]))
        stats = ws.stats()
        tail_records = stats["appends"] - head_stats["appends"]
        tail_bytes = os.path.getsize(wal_file)
        rep = svc.report()
        kept = clone_state(svc.index.state)
        want_d, want_v = svc.search(queries)
        crash(svc)
        del svc
        svc, reopen_s = opened(spec)
        rec = svc.recovery
        check(svc.recovered, "[durable] the reopened service did not recover")
        same_leaves(torch, kept, svc.index.state, "[durable] cooperative recovery")
        del kept
        got_d, got_v = svc.search(queries)
        check(bool(np.array_equal(got_v, want_v)), "[durable] recovered search ids differ")
        check(bool(np.all(np.abs(got_d - want_d) <= 1e-3 + RTOL * np.abs(want_d))),
              f"[durable] recovered search distances differ beyond {TOL_TEXT}")
        gone = reqs["deleted"]
        _, v = svc.search(data[gone[:SEARCH_Q]])
        check(not set(gone.tolist()) & set(v.reshape(-1).tolist()),
              "[durable] a deleted vid came back after recovery")
        check(rec["replayed_records"] == tail_records,
              f"[durable] replayed {rec['replayed_records']} records of a {tail_records}-record tail")
        replay_rate = rec["replayed_records"] / rec["replay_s"] if rec["replay_s"] else None
        coop = dict(
            head_steps=delta_at, tail_steps=steps - delta_at, head_s=head_s, tail_s=tail_s,
            base_bytes=rebase["bytes"], base_write_s=rebase["seconds"],
            open_time_base_bytes=base0["bytes"], open_time_base_write_s=base0["seconds"],
            delta_bytes=delta["bytes"], delta_write_s=delta["seconds"],
            delta_over_full=delta["bytes"] / rebase["bytes"],
            wal_head_records=head_stats["appends"], wal_head_bytes=head_wal_bytes,
            wal_tail_records=tail_records, wal_tail_bytes=tail_bytes,
            wal_fsyncs=stats["fsyncs"], wal_fsyncs_per_dispatch=stats["fsyncs_per_append"],
            insert_dropped=rep["insert_dropped"], recovery=rec, reopen_s=reopen_s,
            replayed_records_per_s=replay_rate)
        log(f"[durable] cooperative: {delta_at} steps ({head_s:.2f} s), delta {delta['bytes']} "
            f"bytes in {delta['seconds']:.2f} s ({coop['delta_over_full']:.4f} of the base), "
            f"{steps - delta_at} steps ({tail_s:.2f} s) leave a WAL tail of {tail_records} "
            f"records, {tail_bytes} bytes; {stats['appends']} dispatches logged, "
            f"{stats['fsyncs']} fsyncs ({stats['fsyncs_per_append']:.3f} a dispatch); "
            f"{rep['insert_dropped']} insert rows dropped by backpressure")
        log(f"[durable] crash + open: {reopen_s:.2f} s (load {rec['load_s']:.2f} s, upload "
            f"{rec['upload_s']:.2f} s, WAL read {rec['wal_read_s']:.3f} s, replay "
            f"{rec['replay_s']:.2f} s for {rec['replayed_records']} records, {replay_rate} "
            "records/s); every leaf bit-identical, the same ids, no deleted vid returned")

        # ---- async phase
        svc.checkpoint(delta=True)
        delta2 = dict(svc.last_checkpoint)
        crash(svc)
        del svc
        svc, aopen_s = opened(aspec)
        check(svc.engine.is_async, "[durable] the async service has no pump thread")
        ws = svc.backend.wal_set
        durable_seqno = [ws.next_seqno - 1]
        sync = ws.sync

        def counted_sync():
            sync()
            durable_seqno[0] = ws.next_seqno - 1

        ws.sync = counted_sync
        early = []

        def on_update(tk):
            if tk.seqno > durable_seqno[0]:
                early.append(tk.seqno)

        def vecs_for(trng, m):
            rows = base[trng.integers(0, n, m)] + trng.integers(-3, 4, (m, base.shape[1]))
            return np.clip(rows, -127, 127).astype(np.float32)

        (tally, live, dead), async_s = timed(torch, lambda: async_clients(
            np, svc.engine, vecs_for, threads, ops_each,
            vid0=int(reqs["inserted"][-1]) + 1, stride=ops_each * async_rows,
            max_rows=async_rows, pool=queries, k=k, seed=seed + 200, on_update=on_update))
        svc.flush()
        arep = svc.report()
        astats = ws.stats()
        check(not early, f"[durable] {len(early)} update tickets resolved before their fsync")
        check(tally["violations"] == 0, f"[durable] {tally['violations']} ordering violations")
        check(tally["resurrected"] == 0, f"[durable] {tally['resurrected']} deletes came back")
        check(tally["misses"] <= ASYNC_MISS_LIMIT * tally["checks"],
              f"[durable] {tally['misses']} ANN misses in {tally['checks']} checks")
        kept = clone_state(svc.index.state)
        crash(svc)
        del svc
        svc, areopen_s = opened(aspec)
        arec = svc.recovery
        same_leaves(torch, kept, svc.index.state, "[durable] async recovery")
        del kept
        crash(svc)
        arate = arec["replayed_records"] / arec["replay_s"] if arec["replay_s"] else None
        log(f"[durable] async: {threads} threads x {ops_each} ops in {async_s:.2f} s over a "
            f"base + 2 deltas ({delta2['bytes']} bytes); {astats['appends']} dispatches, "
            f"{astats['fsyncs']} fsyncs ({astats['fsyncs_per_append']:.3f} a dispatch), 0 "
            f"update tickets resolved before their fsync; {tally['checks']} visibility "
            f"checks, {tally['violations']} violations, {tally['misses']} ANN misses; crash + "
            f"open {areopen_s:.2f} s (replay {arec['replay_s']:.2f} s for "
            f"{arec['replayed_records']} records, {arate} records/s): every leaf bit-identical")
        report.update(
            fs=fs, n=n, open_s=open_s, drain_jobs=jobs, drain_rounds=rounds, drain_s=drain_s,
            cooperative=coop,
            async_phase=dict(seconds=async_s, tally=tally, dispatches=astats["appends"],
                             fsyncs=astats["fsyncs"],
                             fsyncs_per_dispatch=astats["fsyncs_per_append"],
                             early_acks=len(early), report=arep, open_s=aopen_s,
                             second_delta_bytes=delta2["bytes"],
                             second_delta_write_s=delta2["seconds"],
                             recovery=arec, reopen_s=areopen_s,
                             replayed_records_per_s=arate))
    finally:
        if current[0] is not None:
            current[0].engine.shutdown(timeout=JOIN_S)
        for ws in wal_sets:
            ws.close()
        shutil.rmtree(root, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# the sharded path: a sharded, replicated, durable service
# ---------------------------------------------------------------------------

SHARDS = 4
REPLICAS = 2
# request steps and async operations a thread: cut from 16 and 40 with the lm
# path, then from 8 and 20 with the gnn and lm_train paths, for the smoke's
# time budget (PERF.md section 4)
SHARDED_STEPS = 4
SHARDED_GROUP_COMMIT = 8
# The build's backlog is not drained first (a sharded round is four rounds
# of host dispatch): the engine's slots work it down, each a round of
# SHARDED_BUDGET jobs a shard, and a batch whose rows meet a full posting
# retries after up to SHARDED_RETRIES of them.  At fewer, rows are dropped
# (my chip runs, PR 20: 195 of 1,024 rows after 16 retries of 8 jobs, 16
# after 16 retries of 64).
SHARDED_BUDGET = 128
SHARDED_RETRIES = 32
SHARDED_THREADS = 4
SHARDED_OPS = 10
SHARDED_ROWS = 32
SHARDED_WINDOW = 4
SEARCH_REPS = 5
# Recall@10 of the JAX reference's ShardedIndex (4 shards, 4 fake CPU
# devices) built from the same UPDATE_N rows, by nprobe
# (scripts/reference_recall.py, cell "sharded"); the port must reach each
# minus RECALL_MARGIN.
REFERENCE_RECALL_SHARDED_250K = {1: 0.4994140625, 64: 0.9576171875000001}


def merge_of_shards(np, per_shard, n_cap, k):
    """The tournament merge on the host: each shard's ``(d, v)`` with its
    vids made handles, laid out shard-major, the ``k`` smallest kept in a
    stable order."""
    d = np.concatenate([x[0] for x in per_shard], axis=1)
    v = np.concatenate([np.where(x[1] >= 0, s * n_cap + x[1], -1)
                        for s, x in enumerate(per_shard)], axis=1)
    sel = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, sel, 1), np.take_along_axis(v, sel, 1)


def sharded_clients(np, engine, vecs_for, n_threads, ops_each, *, max_rows, pool, k=10,
                    seed=300, on_update=None):
    """``n_threads`` submitter threads of ``ops_each`` operations on a
    sharded engine (handles, not vids): 50% searches of the thread's own
    live rows, its last deleted ones and ``pool`` rows, 30% inserts of 1 to
    ``max_rows`` rows, 20% deletes of its own handles.  A search ticket's
    seqno is the seqno of the state that served it (a replica's, when it
    was routed): an own row absent from its top-``k`` is a stale read when
    that state predates the row's insert (what a replica within the
    freshness bound may serve) and an ANN miss otherwise; a deleted handle
    in a search served at or after its delete is a resurrection."""
    import threading

    tally = {"stale": 0, "misses": 0, "resurrected": 0, "checks": 0, "ops": 0}
    lock = threading.Lock()
    errors, dead_all = [], {}

    def worker(tid):
        trng = np.random.default_rng(seed + tid)
        live, dead = {}, {}                       # handle -> (vector, seqno)
        try:
            for _ in range(ops_each):
                op = trng.integers(0, 10)
                m = int(trng.integers(1, max_rows + 1))
                if op < 3 or not live:
                    vecs = vecs_for(trng, m)
                    tk = engine.submit_insert(vecs, np.full(m, -1, np.int32))
                    h, landed = tk.result(timeout=JOIN_S)
                    if on_update is not None:
                        on_update(tk)
                    if not landed.all():
                        raise AssertionError(f"thread {tid}: an insert was dropped")
                    for j in range(m):
                        live[int(h[j])] = (vecs[j], tk.seqno)
                elif op < 8:
                    picks = [int(p) for p in trng.choice(sorted(live), size=min(len(live), m),
                                                         replace=False)]
                    gone = sorted(dead)[-min(4, m - len(picks)):] if m > len(picks) else []
                    rest = m - len(picks) - len(gone)
                    q = np.concatenate(
                        [np.stack([live[p][0] for p in picks] + [dead[g][0] for g in gone]),
                         pool[trng.integers(0, len(pool), rest)]]).astype(np.float32)
                    tk = engine.submit_search(q, k=k)
                    _, hit = tk.result(timeout=JOIN_S)
                    with lock:
                        for row, p in enumerate(picks):
                            tally["checks"] += 1
                            if p not in hit[row].tolist():
                                tally["stale" if tk.seqno < live[p][1] else "misses"] += 1
                        for row, g in enumerate(gone, start=len(picks)):
                            if tk.seqno >= dead[g][1] and g in hit[row].tolist():
                                tally["resurrected"] += 1
                else:
                    picks = trng.choice(sorted(live), size=min(len(live), m), replace=False)
                    tk = engine.submit_delete(picks.astype(np.int32))
                    tk.result(timeout=JOIN_S)
                    if on_update is not None:
                        on_update(tk)
                    for p in picks:
                        dead[int(p)] = (live.pop(int(p))[0], tk.seqno)
                with lock:
                    tally["ops"] += 1
            with lock:
                dead_all.update({h: x for h, (x, _) in dead.items()})
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    check(not [t for t in threads if t.is_alive()], "sharded submitter threads hung")
    if errors:
        raise errors[0]
    check(tally["ops"] == n_threads * ops_each, f"only {tally['ops']} operations ran")
    return tally, dead_all


def sharded_path(torch, np, seed, report, *, cfg=None, device="cuda", n=None,
                 shards=SHARDS, steps=SHARDED_STEPS, threads=SHARDED_THREADS,
                 ops_each=SHARDED_OPS, async_rows=SHARDED_ROWS, floors=None, root_dir=None):
    """A sharded, replicated, durable service (``repro_torch.api``) at the
    update cell's per-shard geometry, built from ``n`` rows of the
    reference's generator: ``api.open(service_spec(n_shards=shards,
    n_replicas=2, durable_root=...))``, the build's backlog left to the
    engine's rounds.

    * Tournament merge: one Q=1024 sharded search per schedule and nprobe
      (64, 1) equals the host merge of the shards' own ``lire.search``
      results (tie-tolerant), reaches ``floors`` (the reference's sharded
      recall minus the margin) against brute force, and, with shard 2 set
      dead, returns no handle of it; search p50 over ``SEARCH_REPS``.
    * One ``search_begin`` under ``set_sync_debug_mode("error")`` returns
      while the card still works; its readback equals the blocking search.
    * ``steps`` of the serve path's request steps (deletes by handle) on
      the cooperative engine, searches routed to the replica: every insert
      lands after the retries; the recorded dispatch stream replays on a
      clone of the starting shards bit for bit; the replica, synced, equals
      the primary bit for bit (``states_equal``).
    * Crash and ``api.open(spec)``: every shard's leaves bit for bit after
      the per-shard WAL replay, the same search ids, no deleted handle.
    * Async: the recovered service on the pump thread with ``threads``
      submitter threads (:func:`sharded_clients`): searches routed to the
      replica (routed and fallback batches, lag), no update ticket acked
      before its fsync, no resurrection; a forced catch-up (the replica
      paused past its window, then resumed) and ``states_equal`` at equal
      seqno; no replica failed; a crash and a bit-identical recovery."""
    import os
    import shutil
    import tempfile

    from repro_torch import api
    from repro_torch.configs.spfresh import SEARCH_Q, UPDATE_B, service_spec
    from repro_torch.core import lire
    from repro_torch.data.vectors import make_queries, make_spacev_like_bytes
    from repro_torch.distributed import sharded_index as D
    from repro_torch.distributed.replication import states_equal
    from repro_torch.storage.durability import RecordingSink

    cfg = cfg or path_config("fp32")
    n = n or UPDATE_N
    k, nprobe = 10, cfg.nprobe
    if floors is None:
        floors = {p: REFERENCE_RECALL_SHARDED_250K[q] - RECALL_MARGIN
                  for p, q in ((1, 1), (nprobe, 64))}
    n_fresh = steps * (SERVE_SEARCH_ROWS // 2)
    data, gen_s = timed(torch, lambda: make_spacev_like_bytes(n + UPDATE_B, cfg.dim, seed=seed))
    base = data[:n]
    queries = make_queries(base, min(SEARCH_Q, n), seed=seed)
    reqs = serve_requests(np, seed, n, np.arange(n, n + n_fresh), queries, data, steps=steps)
    parent = root_dir or ROOT / "build"
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="sharded_", dir=parent)
    spec = service_spec(n_shards=shards, n_replicas=REPLICAS, durable_root=root)
    spec = dataclasses.replace(
        spec, index=api.IndexSpec(config=cfg),
        serve=dataclasses.replace(spec.serve, max_insert_retries=SHARDED_RETRIES),
        maintenance=dataclasses.replace(spec.maintenance, maintain_budget=SHARDED_BUDGET),
        durability=dataclasses.replace(spec.durability, group_commit=SHARDED_GROUP_COMMIT))
    aspec = dataclasses.replace(
        spec, serve=dataclasses.replace(spec.serve, async_serve=True, max_wait_ms=1.0),
        scan=dataclasses.replace(spec.scan, scan_schedule="per_query"))
    log(f"[sharded] data: make_spacev_like in bytes, N={n} over {shards} shards x "
        f"{REPLICAS} copies, made in {gen_s:.1f} s; durable root on {fs_type(root)}")
    current, wal_sets = [None], []

    def opened(sp, **kw):
        svc, s = timed(torch, lambda: api.open(sp, device=device, **kw))
        current[0] = svc
        wal_sets.append(svc.backend.wal_set)
        return svc, s

    def crash(svc):
        svc.engine.shutdown(timeout=JOIN_S)      # no checkpoint, no close; stops the replica
        current[0] = None

    def same_shards(a, b, what):
        for s, (x, y) in enumerate(zip(a, b)):
            same_leaves(torch, x, y, f"{what}, shard {s}")

    def healthy(svc, what):
        rep = svc.replicas.report()
        check(not any(r["failed"] for r in rep["per_replica"]), f"[sharded] {what}: a replica "
              f"failed: {[r.error for r in svc.replicas.replicas]}")
        return rep

    # the build inside api.open, timed on its own
    build_fn, build_s = D.ShardedIndex.__dict__["build"], []

    def timed_build(*a, **kw):
        out, secs = timed(torch, lambda: build_fn.__get__(None, D.ShardedIndex)(*a, **kw))
        build_s.append(secs)
        return out

    try:
        # ---- set-up: build every shard, clone the replica, the open-time base
        D.ShardedIndex.build = staticmethod(timed_build)
        try:
            svc, open_s = opened(spec, vectors=base)
        finally:
            D.ShardedIndex.build = build_fn
        handles = svc.initial_handles
        check(bool((handles >= 0).all()), "[sharded] a base row got no handle")
        be = svc.backend
        per_shard = be.state_bytes()
        base0 = dict(svc.last_checkpoint)
        n_cap = cfg.num_vectors_cap
        owners = np.bincount(handles // n_cap, minlength=shards)
        log(f"[sharded] open {open_s:.1f} s (the partition and {shards} shard builds "
            f"{build_s[0]:.1f} s, the replica's clone, the open-time base unit of "
            f"{base0['bytes']} bytes in {base0['seconds']:.2f} s); rows per shard "
            f"{owners.tolist()}; state bytes per "
            f"shard {per_shard}, {sum(per_shard)} a copy, {REPLICAS * sum(per_shard)} with the "
            f"replica; backlog {be.backlog()}")
        report.update(n=n, shards=shards, replicas=REPLICAS, open_s=open_s, build_s=build_s[0],
                      rows_per_shard=owners.tolist(), state_bytes_per_shard=per_shard,
                      state_bytes_total=REPLICAS * sum(per_shard), base_bytes=base0["bytes"],
                      base_write_s=base0["seconds"], backlog_after_build=be.backlog())

        # ---- tournament merge, recall, dead shard, p50
        q_t = torch.as_tensor(queries, device=device)
        alive = be.shard_alive
        base_t = torch.as_tensor(base, device=device)
        recall, p50, shard_p50 = {}, {}, {}
        for sched in ("batched", "per_query"):
            flags = dict(use_pallas_scan=True, scan_schedule=sched)
            for probes in (nprobe, 1):
                d, v = (x.cpu().numpy() for x in D.sharded_search(
                    be.states, q_t, alive, k=k, nprobe=probes, **flags))
                own = [tuple(x.cpu().numpy() for x in lire.search(st, q_t, k=k, nprobe=probes,
                                                                   **flags))
                       for st in be.states]
                md, mv = merge_of_shards(np, own, n_cap, k)
                tol = 1e-3 + RTOL * np.abs(md)
                check(bool(np.all(np.abs(d - md) <= tol)),
                      f"[sharded] {sched}@{probes}: merged distances differ beyond {TOL_TEXT}")
                swap = v != mv
                tie = np.abs(np.diff(md, axis=1)) <= tol[:, 1:]
                near = np.zeros_like(swap)
                near[:, 1:] |= tie
                near[:, :-1] |= tie
                check(not bool((swap & ~near).any()),
                      f"[sharded] {sched}@{probes}: the merge differs outside distance ties")
                recall[f"{sched}@{probes}"] = recall_at_10(torch, base_t, queries, v, handles)
            times = [timed(torch, lambda: D.sharded_search(be.states, q_t, alive, k=k,
                                                           **flags))[1] * 1e3
                     for _ in range(SEARCH_REPS)]
            p50[sched] = statistics.median(times)
            for s, st in enumerate(be.states):
                times = [timed(torch, lambda: lire.search(st, q_t, k=k, **flags))[1] * 1e3
                         for _ in range(SEARCH_REPS)]
                shard_p50.setdefault(sched, []).append(statistics.median(times))
        floor = {key: floors[int(key.split("@")[1])] for key in recall}
        log(f"[sharded] the merge equals the host merge of the shards' own searches; recall@10 "
            f"(schedule@nprobe) {recall}, floors {floor}; search p50 ms at Q={len(queries)} "
            f"{p50}, each shard's own search {shard_p50} (sum "
            f"{ {key: sum(x) for key, x in shard_p50.items()} })")
        for key, r in recall.items():
            check(r >= floor[key], f"[sharded] recall@10 {r} of {key} below {floor[key]}")
        be.set_alive([s != 2 for s in range(shards)])
        _, v = be.search(queries, k, nprobe)
        be.set_alive([True] * shards)
        check(not bool(((v // n_cap == 2) & (v >= 0)).any()), "[sharded] a dead shard leaked")
        report.update(recall_at_10=recall, recall_floor=floor, search_p50_ms=p50,
                      shard_search_p50_ms=shard_p50)

        # ---- one dispatch with no host sync between the shards
        if device == "cuda":
            valid = np.ones(len(queries), bool)
            want = be.search(queries, k, nprobe, valid)
            torch.cuda.synchronize()
            torch.cuda._sleep(400_000_000)
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fin = be.search_begin(queries, k, nprobe, valid)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            host_ms = (time.perf_counter() - t0) * 1e3
            check(not torch.cuda.current_stream().query(),
                  "[sharded] the card finished before search_begin returned")
            got = fin()
            check(bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])),
                  "[sharded] the deferred readback differs from the blocking search")
            report["search_begin_host_ms"] = host_ms
            log(f"[sharded] search_begin over {shards} shards under set_sync_debug_mode"
                f"('error') returns after {host_ms:.2f} ms of host work, the card still busy")

        # ---- cooperative steps: handles for the deletes, a recorded stream
        rs = svc.replicas
        before = be.fork_state()
        rec = RecordingSink()

        class Tee:
            def publish(self, *a):
                rs.publish(*a)
                rec.publish(*a)

        be.attach_replication(Tee())
        dropped = []

        def run(step_list):
            for step in step_list:
                for op, arr, vids in step:
                    if op == "search":
                        svc.search(arr)
                    elif op == "insert":
                        _, landed = svc.insert(arr)
                        dropped.append(int((~landed).sum()))
                    else:
                        svc.delete(handles[vids].astype(np.int32))

        routed0 = rs.routed
        _, coop_s = timed(torch, lambda: run(reqs["steps"]))
        be.attach_replication(rs)
        crep = svc.report()
        log(f"[sharded] cooperative steps {coop_s:.2f} s: {crep['insert_retries']} insert "
            f"retries, {crep['maintenance']['rounds']} rounds in "
            f"{crep['maintenance']['time_s']:.2f} s, backlog {crep['backlog']}")
        check(sum(dropped) == 0 and crep["insert_dropped"] == 0,
              f"[sharded] {sum(dropped)} insert rows dropped after {SHARDED_RETRIES} retries")
        twin = D.ShardedIndex(cfg, before)
        _, replay_s = timed(torch, lambda: twin.replay(rec.records))
        same_shards(twin.states, be.states, "[sharded] replay of the cooperative stream")
        del twin, before
        _, sync_s = timed(torch, lambda: rs.wait_sync(timeout=JOIN_S))
        check(states_equal(be.states, rs.replicas[0].backend.states),
              "[sharded] the synced replica differs from the primary")
        healthy(svc, "cooperative")
        m = crep["maintenance"]
        ms_round = m["time_s"] * 1e3 / m["rounds"] if m["rounds"] else None
        ops = {op: sum(r.op == op for r in rec.records) for op in ("insert", "delete", "maintain")}
        log(f"[sharded] cooperative: {steps} steps in {coop_s:.2f} s ({crep['insert_retries']} "
            f"insert retries, 0 rows dropped); {len(rec.records)} dispatches {ops}; "
            f"{m['rounds']} sharded rounds at {ms_round} ms; replay on a clone {replay_s:.2f} s, "
            f"bit-identical on every shard; {rs.routed - routed0} search batches routed to the "
            f"replica; replica synced in {sync_s:.2f} s, equal to the primary bit for bit")
        report["cooperative"] = dict(seconds=coop_s, replay_s=replay_s, dispatches=ops,
                                     ms_per_round=ms_round, report=crep,
                                     routed=rs.routed - routed0, replica_sync_s=sync_s)

        # ---- crash, recover every shard from the per-shard WALs
        kept = be.fork_state()
        want_d, want_v = svc.search(queries)
        crash(svc)
        del svc, be, rs
        svc, reopen_s = opened(spec)
        rcv = svc.recovery
        check(svc.recovered, "[sharded] the reopened service did not recover")
        same_shards(kept, svc.backend.states, "[sharded] recovery")
        del kept
        got_d, got_v = svc.search(queries)
        check(bool(np.array_equal(got_v, want_v)), "[sharded] recovered search ids differ")
        check(bool(np.all(np.abs(got_d - want_d) <= 1e-3 + RTOL * np.abs(want_d))),
              f"[sharded] recovered distances differ beyond {TOL_TEXT}")
        gone = handles[reqs["deleted"]]
        _, v = svc.search(data[reqs["deleted"]])
        check(not set(gone.tolist()) & set(v.reshape(-1).tolist()),
              "[sharded] a deleted handle came back after recovery")
        log(f"[sharded] crash + open {reopen_s:.2f} s: load {rcv['load_s']:.2f} s "
            f"({rcv['snapshot_bytes']} bytes), upload {rcv['upload_s']:.2f} s, replay "
            f"{rcv['replay_s']:.2f} s of {rcv['replayed_records']} records; every shard "
            "bit-identical, the same ids, no deleted handle returned")
        report["recovery"] = dict(rcv, reopen_s=reopen_s)
        crash(svc)
        del svc

        # ---- async: the pump thread, searches routed to the replica
        svc, aopen_s = opened(aspec)
        rs, be = svc.replicas, svc.backend
        ws = be.wal_set
        durable = [ws.next_seqno - 1]
        sync = ws.sync

        def counted_sync():
            sync()
            durable[0] = ws.next_seqno - 1

        ws.sync = counted_sync
        early = []

        def on_update(tk):
            if tk.seqno > durable[0]:
                early.append(tk.seqno)

        def vecs_for(trng, m):
            rows = base[trng.integers(0, n, m)] + trng.integers(-3, 4, (m, base.shape[1]))
            return np.clip(rows, -127, 127).astype(np.float32)

        routed0, fb0 = rs.routed, rs.fallback
        (tally, dead), async_s = timed(torch, lambda: sharded_clients(
            np, svc.engine, vecs_for, threads, ops_each, max_rows=async_rows, pool=queries,
            k=k, seed=seed + 300, on_update=on_update))
        svc.flush()
        arep = svc.report()
        lag_seen = max(r["lag"] for r in arep["replicas"]["per_replica"])
        check(not early, f"[sharded] {len(early)} update tickets acked before their fsync")
        check(tally["resurrected"] == 0, f"[sharded] {tally['resurrected']} deletes came back")
        check(tally["misses"] <= ASYNC_MISS_LIMIT * tally["checks"],
              f"[sharded] {tally['misses']} ANN misses in {tally['checks']} checks")
        check(rs.routed > routed0, "[sharded] no search batch was routed to the replica")
        # forced catch-up: the replica paused past its window, then resumed
        rs.pause(0)
        rs.window_cap = SHARDED_WINDOW
        extra = [svc.insert(vecs_for(np.random.default_rng(seed + 400 + i), 8))[1].all()
                 for i in range(SHARDED_WINDOW + 2)]
        check(all(extra), "[sharded] a catch-up insert was dropped")
        svc.flush()                      # the pump idle: no slot still due
        lag_paused = rs.report()["per_replica"][0]["lag"]
        rs.resume(0)
        _, catch_s = timed(torch, lambda: rs.wait_sync(timeout=JOIN_S))
        rrep = healthy(svc, "async")
        check(rrep["per_replica"][0]["catchups"] >= 1, "[sharded] the replica did not catch up")
        check(rrep["per_replica"][0]["applied_seqno"] == rrep["primary_seqno"],
              "[sharded] the replica is not at the primary's seqno")
        check(states_equal(be.states, rs.replicas[0].backend.states),
              "[sharded] the caught-up replica differs from the primary")
        log(f"[sharded] async: {threads} threads x {ops_each} ops in {async_s:.2f} s; "
            f"{rs.routed - routed0} search batches routed to the replica, "
            f"{rs.fallback - fb0} fell back to the primary, lag at the end {lag_seen}; "
            f"{tally['checks']} visibility checks: {tally['stale']} stale reads, "
            f"{tally['misses']} ANN misses, {tally['resurrected']} resurrections; 0 update "
            f"tickets acked before their fsync; catch-up from a lag of {lag_paused} past a "
            f"window of {SHARDED_WINDOW}: {rrep['per_replica'][0]['catchups']} fork(s), synced "
            f"in {catch_s:.2f} s, equal to the primary bit for bit")
        kept = be.fork_state()
        crash(svc)
        del svc, be, rs
        svc, areopen_s = opened(aspec)
        arcv = svc.recovery
        same_shards(kept, svc.backend.states, "[sharded] async recovery")
        del kept
        if dead:
            gone = np.asarray(sorted(dead), np.int64)
            _, v = svc.backend.search(np.stack([dead[int(g)] for g in gone]), k, nprobe)
            check(not set(gone.tolist()) & set(v.reshape(-1).tolist()),
                  "[sharded] an async delete came back after recovery")
        crash(svc)
        log(f"[sharded] async crash + open {areopen_s:.2f} s (replay {arcv['replay_s']:.2f} s of "
            f"{arcv['replayed_records']} records): every shard bit-identical")
        report["async_phase"] = dict(
            seconds=async_s, tally=tally, routed=arep["replicas"]["routed_batches"],
            fallback=arep["replicas"]["fallback_primary"], lag_at_end=lag_seen,
            lag_paused=lag_paused, catchup_s=catch_s, replicas=rrep, report=arep,
            early_acks=len(early), open_s=aopen_s, recovery=dict(arcv, reopen_s=areopen_s))
    finally:
        if current[0] is not None:
            current[0].engine.shutdown(timeout=JOIN_S)
        for ws in wal_sets:
            ws.close()
        shutil.rmtree(root, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# the retrieval path: two-tower retrieval served by the index
# ---------------------------------------------------------------------------

# The recall floor's corpus: the largest the reference's CPU run builds
# (scripts/reference_recall.py, cell "retrieval", about 50 minutes on 8
# CPU cores), capacities x 8.  Recall falls as N grows, so the floor holds
# at this size only.
RETRIEVAL_FLOOR_N = 262_144
RETRIEVAL_FLOOR_SCALE = 8
# The corpus the rest of the path serves: item ids 0..RETRIEVAL_N-1,
# embedded at SERVE_CONFIG's full width, in an index of the reference's
# ann_index_cfg with its three capacities times RETRIEVAL_SCALE.
# retrieval_cand has 1,000,000 candidates (the reference's
# configs/common.py:346); the path takes the floor's 262,144 and serves
# them from the floor's index: with the lm path a second build of 524,288
# took the whole smoke past its time budget (PERF.md section 4).
RETRIEVAL_N = RETRIEVAL_FLOOR_N
RETRIEVAL_SCALE = RETRIEVAL_FLOOR_SCALE
# Recall@10 of the reference's IndexedRetriever (gather oracle, nprobe 16)
# against its brute force on the same params, the floor's corpus and the
# users; the port must reach it minus RECALL_MARGIN under both schedules.
# Random towers spread the users' neighbours over many postings, so recall
# at nprobe 16 is low; the kernel path's ids are also held against the
# gather oracle's on the same state (ORACLE_OVERLAP, as the main paths).
REFERENCE_RECALL_RETRIEVAL = 0.10126953125
ORACLE_OVERLAP = 0.95
RETRIEVAL_USERS = 1024          # the Q=1,024 batch
RETRIEVAL_LOOKUPS = 64          # single-user lookups (the retrieval_cand batch)
# churn: items added (each must find itself) and removed; cut from 16,384
# and 4,096 with the lm path, for the smoke's time budget (PERF.md section 4)
RETRIEVAL_ADD = 4_096
RETRIEVAL_REMOVE = 1_024
RETRIEVAL_BURSTS = 8            # engine bursts of RETRIEVAL_USERS users
RETRIEVAL_ENGINE_ADD = 1024     # churn after the middle burst
RETRIEVAL_ENGINE_REMOVE = 256


def retrieval_index_cfg(scale):
    """``ann_index_cfg()`` with kernel navigation and scans and its three
    capacities times ``scale``."""
    from repro_torch.configs.two_tower_retrieval import ann_index_cfg

    c = ann_index_cfg()
    return dataclasses.replace(c, num_blocks=c.num_blocks * scale,
                               num_postings_cap=c.num_postings_cap * scale,
                               num_vectors_cap=c.num_vectors_cap * scale,
                               use_pallas_nav=True, use_pallas_scan=True)


def retrieval_users(np, seed, n, cfg):
    """``n`` users' field ids, uniform over each field's vocabulary."""
    rng = np.random.default_rng(seed + 11)
    return rng.integers(0, cfg.user_vocab_per_field, size=(n, cfg.n_user_fields)).astype(np.int32)


def with_schedule(retr, schedule):
    """The retriever's index set to scan with ``schedule`` (the state's
    config decides it; nothing is copied)."""
    st = retr.index.state
    retr.index.state = st.replace(cfg=dataclasses.replace(st.cfg, scan_schedule=schedule))


def retrieval_path(torch, np, seed, report, *, device="cuda", model_cfg=None, n=None, cfg=None,
                   floor_n=None, floor_cfg=None, floor=None, users_n=RETRIEVAL_USERS,
                   lookups=RETRIEVAL_LOOKUPS, n_add=RETRIEVAL_ADD, n_remove=RETRIEVAL_REMOVE,
                   bursts=RETRIEVAL_BURSTS, engine_add=RETRIEVAL_ENGINE_ADD,
                   engine_remove=RETRIEVAL_ENGINE_REMOVE, index_cells=None):
    """Two-tower retrieval through ``IndexedRetriever`` at ``model_cfg``
    (``SERVE_CONFIG``: bf16, the published widths), its params made on the
    device from ``seed`` (``twotower_init_counter``).

    The recall floor's corpus first: ``floor_n`` items in an index of
    config ``floor_cfg``, built; recall@10 of ``retrieve`` against
    ``retrieve_bruteforce`` under both schedules, each at least ``floor``
    (by default, at ``RETRIEVAL_FLOOR_N`` items, the reference's minus
    ``RECALL_MARGIN``), and each schedule's ids overlapping the gather
    oracle's on the same state by ``ORACLE_OVERLAP``.  Then ``n`` items in
    an index of config ``cfg`` (the floor's index itself where ``n`` and
    ``cfg`` are the floor's, as by default; else the floor's is dropped
    and this one built): ANN p50 at Q=1 (``lookups`` users) and
    Q=``users_n`` under both schedules, where a Q=``users_n`` lookup's time
    goes (towers, #1, the scan, the rest), brute-force p50; recall@10 (no
    floor past the floor's size) and the oracle overlap again.  Churn: ``add_items`` of ``n_add``
    items (inserts, drains, ``maintain(32)``), every fresh item in its own
    top-10 under both schedules, ``remove_items`` of ``n_remove``, none
    returned to the users or to its own embedding.  Then the engine,
    attached through a ``ServiceSpec`` as the reference example does:
    ``bursts`` bursts of ``users_n`` users, churn after the middle one
    (``engine_add`` items in, ``engine_remove`` out), ``drain()``,
    ``report()``.  The defaults are the card's sizes; a small
    ``model_cfg`` and configs rehearse the path on the CPU.  Given a dict
    ``index_cells``, the ``retrieval_cand_ann`` cell runs on one user
    against the path's index (:func:`ann_index_cell`)."""
    from repro_torch import api
    from repro_torch.configs.two_tower_retrieval import SERVE_CONFIG
    from repro_torch.models.recsys import twotower_init_counter
    from repro_torch.serve.policy import BacklogPolicy
    from repro_torch.serve.retrieval import IndexedRetriever

    model_cfg = model_cfg or SERVE_CONFIG
    n = n or RETRIEVAL_N
    cfg = cfg or retrieval_index_cfg(RETRIEVAL_SCALE)
    floor_n = floor_n or RETRIEVAL_FLOOR_N
    floor_cfg = floor_cfg or retrieval_index_cfg(RETRIEVAL_FLOOR_SCALE)
    if floor is None and floor_n == RETRIEVAL_FLOOR_N:
        floor = REFERENCE_RECALL_RETRIEVAL - RECALL_MARGIN
    k = 10
    params, init_s = timed(torch, lambda: twotower_init_counter(seed, model_cfg, device=device))
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    users = retrieval_users(np, seed, users_n, model_cfg)
    log(f"[retrieval] params {model_cfg.name} {model_cfg.dtype}: {param_bytes} bytes made on "
        f"{device} in {init_s:.2f} s (item table {tuple(params.item_embed.shape)})")
    report.update(param_bytes=param_bytes, init_s=init_s, n=n)

    def recall_of(got, want):
        return float(sum(len(set(a) & set(b)) for a, b in zip(got.tolist(), want.tolist()))
                     / want.size)

    def schedules(retr, fn):
        out = {}
        for sched in ("per_query", "batched"):
            with_schedule(retr, sched)
            out[sched] = fn()
        with_schedule(retr, "per_query")
        return out

    def quality(retr, n_items, fl):
        """Recall@10 against brute force and id overlap with the gather
        oracle on the same state, both schedules; recall held to ``fl``
        where given."""
        _, bf = retr.retrieve_bruteforce(users, k=k)
        rec = schedules(retr, lambda: recall_of(retr.retrieve(users, k=k)[1], bf))
        u = retr._users(users).cpu().numpy()
        oracle = retr.index.search(u, k, use_pallas_scan=False)[1]
        ov = schedules(retr, lambda: overlap(oracle, retr.index.search(u, k)[1]))
        log(f"[retrieval] N={n_items}: recall@10 at nprobe {retr.index_cfg.nprobe} {rec}, floor "
            f"{fl}; kernel path vs gather oracle, id overlap {ov}")
        for sched in rec:
            check(ov[sched] >= ORACLE_OVERLAP, f"[retrieval] {sched} overlaps the oracle by "
                  f"{ov[sched]} < {ORACLE_OVERLAP} (N={n_items})")
            if fl is not None:
                check(rec[sched] >= fl, f"[retrieval] recall@10 {rec[sched]} ({sched}, "
                      f"N={n_items}) below {fl}")
        return rec, ov

    # ---- the recall floor's corpus
    retr = IndexedRetriever(params, model_cfg, floor_cfg, device=device)
    _, fbuild_s = timed(torch, lambda: retr.build_corpus(np.arange(floor_n)))
    frec, fov = quality(retr, floor_n, floor)
    report["floor_corpus"] = dict(n=floor_n, build_s=fbuild_s, recall_at_10=frec,
                                  recall_floor=floor, oracle_overlap=fov)
    log(f"[retrieval] N={floor_n}: build {fbuild_s:.1f} s (the reference's size, floor "
        f"{floor}: its recall minus {RECALL_MARGIN})")

    # ---- the path's corpus: the floor's, unless another size or config
    if (n, cfg) == (floor_n, floor_cfg):
        build_s = fbuild_s
    else:
        del retr
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        retr = IndexedRetriever(params, model_cfg, cfg, device=device)
        _, build_s = timed(torch, lambda: retr.build_corpus(np.arange(n)))
    st = retr.index.stats()
    mem = retr.index.memory_bytes()
    backlog = retr.index.backlog()
    log(f"[retrieval] N={n}: build {build_s:.1f} s n_postings={st['n_postings']} "
        f"used_blocks={st['used_blocks']} state_bytes={mem['memory'] + mem['disk']} "
        f"backlog={backlog} (postings over split_limit {cfg.split_limit})")
    report.update(build_s=build_s, n_postings=st["n_postings"], used_blocks=st["used_blocks"],
                  state_bytes=mem["memory"] + mem["disk"], backlog_after_build=backlog)
    one = [users[i:i + 1] for i in range(lookups)]

    def p50(fn, reps):
        return statistics.median(timed(torch, fn)[1] * 1e3 for _ in range(reps))

    def lookup_p50():
        retr.retrieve(users, k=k)                         # warm
        return {"1": statistics.median(timed(torch, lambda: retr.retrieve(u, k=k))[1] * 1e3
                                       for u in one),
                str(users_n): p50(lambda: retr.retrieve(users, k=k), 5)}

    ann_p50 = schedules(retr, lookup_p50)
    if index_cells is not None:
        ann_index_cell(torch, np, index_cells, retr, params, users[:1], device=device)
    retr.retrieve_bruteforce(users[:1], k=k)
    bf_p50 = {"1": p50(lambda: retr.retrieve_bruteforce(users[:1], k=k), 5),
              str(users_n): p50(lambda: retr.retrieve_bruteforce(users, k=k), 3)}
    rec, ov = quality(retr, n, None)
    split = {}
    if device == "cuda":
        _, tower_s = timed(torch, lambda: retr._users(users))

        def traced():
            _, kms, host_ms = kernel_ms_in(torch, lambda: retr.retrieve(users, k=k))
            return dict(kernel_ms=kms, host_ms=host_ms, tower_ms=tower_s * 1e3)

        split = schedules(retr, traced)
    log(f"[retrieval] ANN p50 ms {ann_p50} (per_query, batched); brute force p50 ms {bf_p50} "
        f"(towers + GEMM + top-k)")
    for sched, sp in split.items():
        log(f"[retrieval] inside one Q={users_n} {sched} lookup ({sp['host_ms']:.3f} ms on the "
            f"host clock): towers {sp['tower_ms']:.3f} ms, "
            + " ".join(f"{name}={v:.4f} ms" for name, v in sp["kernel_ms"].items() if v))
    report.update(ann_p50_ms=ann_p50, bruteforce_p50_ms=bf_p50, recall_at_10=rec,
                  oracle_overlap=ov, inside_one_lookup=split)

    # ---- catalog churn (an item's vid is its position in the id map: here its id)
    fresh = np.arange(n, n + n_add)
    stats0 = retr.index.stats()
    _, add_s = timed(torch, lambda: retr.add_items(fresh))
    embs = retr.embed_items(fresh)
    found = schedules(retr, lambda: float(np.mean(
        [(retr.index.search(embs[s:s + users_n], k)[1] == fresh[s:s + users_n, None]).any(1).mean()
         for s in range(0, n_add, users_n)])))
    after = retr.index.stats()
    work = {key: after[key] - stats0[key] for key in ("n_splits", "n_merges", "n_reassigned")}
    log(f"[retrieval] +{n_add} items in {add_s:.1f} s ({n_add / add_s:.0f} items/s; the "
        f"drains {work}, {retr.index.retried_rows} rows retried); fresh items in their own "
        f"top-10: {found}")
    for sched, f in found.items():
        check(f == 1.0, f"[retrieval] {sched}: only {f} of the fresh items find themselves")
    gone = np.random.default_rng(seed + 13).choice(n, size=n_remove, replace=False)
    _, rm_s = timed(torch, lambda: retr.remove_items(gone))
    gone_embs = retr.embed_items(gone)
    gone_set = set(gone.tolist())

    def none_back():
        ids = retr.retrieve(users, k=k)[1]
        own = retr.index.search(gone_embs, k)[1]
        return not (gone_set & set(ids.ravel().tolist())) and not (
            gone_set & set(own.ravel().tolist()))

    back = schedules(retr, none_back)
    check(all(back.values()), f"[retrieval] a removed item was returned: {back}")
    log(f"[retrieval] -{n_remove} items in {rm_s:.2f} s; none returned to the users or to its "
        "own embedding, both schedules")
    report.update(add_s=add_s, add_items_per_s=n_add / add_s, add_drain_work=work,
                  fresh_self_top10=found, remove_s=rm_s, stats=retr.index.stats())

    # ---- the engine, attached through a ServiceSpec (the reference example's)
    spec = api.ServiceSpec(index=api.IndexSpec(config=retr.index_cfg),
                           serve=api.ServeSpec(search_k=k, max_batch=128, policy="backlog"),
                           maintenance=api.MaintenanceSpec(maintain_budget=16))
    engine = retr.attach_engine(spec, policy=BacklogPolicy(threshold=1, budget=16))
    rng = np.random.default_rng(seed + 17)
    more = np.arange(n + n_add, n + n_add + engine_add)
    gone2 = rng.choice(np.setdiff1d(np.arange(n), gone), size=engine_remove, replace=False)
    t0 = time.perf_counter()
    for b in range(bursts):
        retr.retrieve(rng.integers(0, model_cfg.user_vocab_per_field,
                                   size=(users_n, model_cfg.n_user_fields)).astype(np.int32), k=k)
        if b == bursts // 2 - 1:
            retr.add_items(more)
            retr.remove_items(gone2)
    engine.drain()
    eng_s = time.perf_counter() - t0
    rep = engine.report()
    ids = retr.retrieve(users, k=k)[1]
    check(not set(gone2.tolist()) & set(ids.ravel().tolist()),
          "[retrieval] the engine returned a removed item")
    log(f"[retrieval] engine: {bursts} bursts of {users_n} users + churn in {eng_s:.2f} s; "
        f"search p50/p99 {rep['search'].get('p50_ms')}/{rep['search'].get('p99_ms')} ms, "
        f"padding waste {rep['queue']['padding_waste_frac']:.4f}, maintenance "
        f"{rep['maintenance']['steps']} steps in {rep['maintenance']['slots']} slots "
        f"({rep['maintenance']['policy']})")
    report.update(engine_s=eng_s, engine_report=rep)
    engine.shutdown(timeout=JOIN_S)
    return report


# ---------------------------------------------------------------------------
# train: the recsys families' training path
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("two-tower-retrieval", "deepfm", "bert4rec", "mind")
# train_batch is 65,536 rows (the reference's configs/common.py
# RECSYS_SHAPES); cut only where one card's 80 GB forces it (PERF.md
# section 4): the (B, B) f32 in-batch logits of two-tower and MIND (17.2 GB
# at 65,536, and autograd keeps several), BERT4Rec's (B*4, 1,048,575) f32
# logits of the masked positions (16.8 MB a sequence).
TRAIN_BATCH = {"two-tower-retrieval": 32_768, "deepfm": 65_536, "bert4rec": 512,
               "mind": 32_768}
TRAIN_WARM = 2                  # warm-up steps, then the timed ones
TRAIN_TIMED = 4
TRAIN_RESTART = 6               # the MIND restart: 6 steps, or 3 + checkpoint + 3
# first step on the card against the CPU's on the same params and batch
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_SERVE_N = 65_536          # items the trained towers serve
TRAIN_SERVE_SCALE = 2           # ann_index_cfg capacities x2: 4 slots an item, as `retrieval`


def train_cells(arch):
    """``(config module, loss function, init function)`` of ``arch``."""
    from repro_torch.configs import bert4rec, deepfm, mind, two_tower_retrieval
    from repro_torch.models import recsys as R

    return {"two-tower-retrieval": (two_tower_retrieval, R.twotower_loss, None),
            "deepfm": (deepfm, R.deepfm_loss, R.deepfm_init),
            "bert4rec": (bert4rec, R.bert4rec_loss, R.bert4rec_init),
            "mind": (mind, R.mind_loss, R.mind_init)}[arch]


def train_batch_fn(np, arch, cfg, b, seed, device):
    """Step ``s``'s batch of ``b`` rows, drawn as the config's batch maker
    draws from ``np.random.default_rng((seed, s))``."""
    mod = train_cells(arch)[0]
    sh = {"kind": "train", "batch": b}
    if arch == "deepfm":
        return lambda s: mod._make_batch(cfg, sh, np.random.default_rng((seed, s)), device)
    return lambda s: mod._make_batch(cfg, sh, np.random.default_rng((seed, s)), "train",
                                     "train_batch", device)


def train_init(torch, arch, cfg, seed, device):
    """Parameters made on ``device``: two-tower by ``twotower_init_counter``
    (no host draw of its 10M-row table), the others from a generator."""
    from repro_torch.models.recsys import twotower_init_counter

    if arch == "two-tower-retrieval":
        return twotower_init_counter(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return train_cells(arch)[2](gen, cfg, device=device)


def train_host_copy(torch, np, arch, params, batch, cfg):
    """``(params, batch, cfg)`` on the CPU for the first-step check.  Two-
    tower copies only what the batch touches: each user field's ids and the
    items, remapped to rows 0.. of small tables (the same loss, the same
    gradient norm: untouched rows take no gradient)."""
    import copy

    from repro_torch import convert
    from repro_torch.models.recsys import TwoTower

    host = {k: v.cpu() for k, v in batch.items()}
    if arch != "two-tower-retrieval":
        from_np = {"deepfm": convert.deepfm_params_from_numpy,
                   "bert4rec": convert.bert4rec_params_from_numpy,
                   "mind": convert.mind_params_from_numpy}[arch]
        return from_np(convert.params_to_numpy(params), cfg, device="cpu"), host, cfg
    dev = params.device
    uf, items = host["user_fields"].numpy(), host["item_ids"].numpy()
    uniq = [np.unique(uf[:, j]) for j in range(cfg.n_user_fields)]
    vp = max(len(u) for u in uniq)
    user = torch.zeros((cfg.n_user_fields * vp, cfg.embed_dim))
    remapped = np.empty_like(uf)
    for j, u in enumerate(uniq):
        rows = torch.as_tensor(j * cfg.user_vocab_per_field + u, device=dev)
        user[j * vp:j * vp + len(u)] = params.user_embed.detach()[rows].cpu()
        remapped[:, j] = np.searchsorted(u, uf[:, j])
    ui = np.unique(items)
    item = params.item_embed.detach()[torch.as_tensor(ui, device=dev)].cpu()
    small = dataclasses.replace(cfg, n_items=len(ui), user_vocab_per_field=vp)
    model = TwoTower(small, user, item, copy.deepcopy(params.user_mlp).cpu(),
                     copy.deepcopy(params.item_mlp).cpu())
    host.update(user_fields=torch.as_tensor(remapped), item_ids=torch.as_tensor(
        np.searchsorted(ui, items).astype(np.int32)))
    return model, host, small


def leaf_samples(torch, params):
    """Up to 2^20 evenly strided values of every parameter leaf."""
    from repro_torch.convert import param_leaves

    return tensor_samples([t for _, t, _ in param_leaves(params)])


def tensor_samples(tensors):
    """Up to 2^20 evenly strided values of each tensor."""
    out = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() >> 20)].clone())
    return out


class Clock:
    """Marks between pieces of work: CUDA events on the card, the host
    clock on the CPU; ``ms()`` gives the time between consecutive marks."""

    def __init__(self, torch, card):
        self.torch, self.card, self.marks = torch, card, []

    def mark(self):
        if self.card:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self):
        if self.card:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def split_step(torch, loss_fn, params, opt_state, batch, device):
    """One more step from its parts (``value_and_grad`` is the forward and
    ``torch.autograd.grad``; then ``adamw_update``), each timed: CUDA
    events on the card, the host clock on the CPU."""
    from repro_torch.configs.common import OPT
    from repro_torch.convert import param_leaves
    from repro_torch.train.optimizer import adamw_update

    leaves = [t for _, t, _ in param_leaves(params)]
    clock = Clock(torch, device != "cpu")
    clock.mark()
    with torch.enable_grad():
        loss, _ = loss_fn(params, batch)
        clock.mark()
        grads = torch.autograd.grad(loss, leaves)
    clock.mark()
    adamw_update(grads, opt_state, params, OPT)
    clock.mark()
    return dict(zip(("forward_ms", "backward_ms", "adamw_ms"), clock.ms()))


def rel_err(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def first_step_vs_cpu(torch, first, loss_fn, host_params, host_batch, what):
    """Step 1's loss and ``grad_norm`` against the CPU's on a host copy of
    the same parameters and batch (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL)."""
    from repro_torch.train.optimizer import global_norm, value_and_grad

    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(loss_fn, host_params, host_batch)
    gnorm = float(global_norm(grads))
    out = dict(loss=first["loss"], cpu_loss=float(loss),
               loss_rel_err=rel_err(first["loss"], float(loss)),
               grad_norm=first["grad_norm"], cpu_grad_norm=gnorm,
               grad_norm_rel_err=rel_err(first["grad_norm"], gnorm),
               cpu_step_s=time.perf_counter() - t0)
    check(out["loss_rel_err"] <= TRAIN_LOSS_RTOL, f"{what}: first-step loss {out}")
    check(out["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL, f"{what}: first-step grad_norm {out}")
    return out


def train_family(torch, np, seed, rep, arch, cfg, b, device):
    """``arch``'s ``train_batch`` cell at ``cfg`` with ``b`` rows a batch
    through ``Trainer`` (OPT, no checkpoint): step 1 (checked against the
    CPU, every leaf must move), then the rest of TRAIN_WARM + TRAIN_TIMED;
    every step finite, ``grad_norm > 0``, ``lr == schedule(OPT, count)``;
    p50, peak memory, one step split.  Returns the trainer."""
    from repro_torch.configs.common import OPT
    from repro_torch.train.optimizer import schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    card = device != "cpu"
    loss = train_cells(arch)[1]
    loss_fn = lambda p, bt: loss(p, bt, cfg)        # noqa: E731
    if card:
        torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(torch, lambda: train_init(torch, arch, cfg, seed, device))
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    batch_for = train_batch_fn(np, arch, cfg, b, seed, device)
    host, copy_s = timed(torch, lambda: train_host_copy(torch, np, arch, params, batch_for(0),
                                                        cfg))
    before = leaf_samples(torch, params)
    steps = TRAIN_WARM + TRAIN_TIMED
    tr = Trainer(loss_fn=loss_fn, init_params_fn=lambda: params, batch_fn=batch_for,
                 opt_cfg=OPT, trainer_cfg=TrainerConfig(total_steps=steps,
                                                        checkpoint_every=steps + 1, log_every=1),
                 device=device)
    tr.run(steps=1)
    moved = [not torch.equal(x, y) for x, y in zip(before, leaf_samples(torch, params))]
    check(all(moved), f"[train] {arch}: {moved.count(False)} parameter leaves did not move "
          "in step 1")
    del before

    # ---- the first step against the CPU's on a host copy
    cpu_params, cpu_batch, cpu_cfg = host
    first = tr.history[0]
    first_step = first_step_vs_cpu(torch, first, lambda p, bt: loss(p, bt, cpu_cfg), cpu_params,
                                   cpu_batch, f"[train] {arch}")
    first_step["host_copy_s"] = copy_s
    del host, cpu_params, cpu_batch

    tr.run()
    for h in tr.history:
        lr = float(schedule(OPT, torch.tensor(h["step"], dtype=torch.int32, device=device)))
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0,
              f"[train] {arch}: step {h['step']} {h}")
        check(h["lr"] == lr, f"[train] {arch}: step {h['step']} lr {h['lr']} != schedule {lr}")
    check(int(tr.opt_state["count"]) == steps, f"[train] {arch}: count {tr.opt_state['count']}")
    step_ms = [h["dt"] * 1e3 for h in tr.history]
    split = split_step(torch, loss_fn, tr.params, tr.opt_state, batch_for(steps), device)
    peak = torch.cuda.max_memory_allocated() if card else None
    rep.update(batch=b, param_bytes=param_bytes, init_s=init_s, step_ms=step_ms,
               p50_ms=statistics.median(step_ms[TRAIN_WARM:]), peak_bytes=peak,
               split=split, first_step=first_step,
               losses=[h["loss"] for h in tr.history],
               grad_norms=[h["grad_norm"] for h in tr.history])
    log(f"[train] {arch}: B={b}, {param_bytes} bytes of params made in {init_s:.2f} s; step p50 "
        f"{rep['p50_ms']:.2f} ms (steps {', '.join(f'{x:.2f}' for x in step_ms)} ms); one step "
        f"forward {split['forward_ms']:.2f} / backward {split['backward_ms']:.2f} / AdamW "
        f"{split['adamw_ms']:.2f} ms; peak {peak} bytes; first step loss {first['loss']:.6f} "
        f"(CPU {first_step['cpu_loss']:.6f}, rel {first_step['loss_rel_err']:.2e}), grad_norm "
        f"{first['grad_norm']:.6f} (CPU {first_step['cpu_grad_norm']:.6f}, rel "
        f"{first_step['grad_norm_rel_err']:.2e}; CPU step {first_step['cpu_step_s']:.1f} s)")
    return tr


def restart_check(torch, rep, what, trainer, steps, parent):
    """A restart under deterministic algorithms: ``trainer(ckpt)`` makes a
    fresh ``Trainer`` (checkpointing under ``ckpt`` when given).  A runs
    ``steps`` steps; B runs half, checkpoints under a temporary root in
    ``parent``, and a fresh trainer restores it and runs to ``steps``.
    Every leaf of the parameters and the optimiser state, ``count``
    included, must be equal; the root is removed."""
    import shutil
    import tempfile

    from repro_torch.convert import train_state_leaves
    from repro_torch.train.checkpoint import CheckpointStore

    half = steps // 2
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_", dir=parent)
    try:
        with deterministic_algorithms(torch):
            a = trainer()
            a.run(steps=steps)
            b1 = trainer()
            b1.run(steps=half)
            store = CheckpointStore(root)
            _, write_s = timed(torch, lambda: store.save(
                half, (b1.params, b1.opt_state), extra={"straggler_steps": b1.straggler_steps}))
            del b1
            ckpt_bytes = sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())
            b2 = trainer(root)
            _, restore_s = timed(torch, lambda: b2.run(steps=0))
            check(b2.step == half, f"{what}: restored step {b2.step} != {half}")
            b2.run(steps=steps - half)
        la = train_state_leaves(a.params, a.opt_state)
        lb = train_state_leaves(b2.params, b2.opt_state)
        same = [bool(torch.equal(x, y)) for (x, _), (y, _) in zip(la, lb)]
        check(len(la) == len(lb) and all(same),
              f"{what}: {same.count(False)} of {len(la)} leaves differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep.update(steps=steps, checkpoint_at=half, checkpoint_bytes=ckpt_bytes,
               write_s=write_s, restore_s=restore_s, leaves=len(la), fs=fs_type(parent))
    log(f"{what} under deterministic algorithms: {len(la)} leaves bit-identical "
        f"after {steps} steps against {half} + checkpoint + {steps - half}; "
        f"checkpoint {ckpt_bytes} bytes written in {write_s:.2f} s, restored in "
        f"{restore_s:.2f} s (init + load; {rep['fs']})")


def restart_trainer(torch, loss_fn, init_fn, batch_fn, device):
    """``trainer(ckpt)`` for :func:`restart_check`: OPT, no periodic
    checkpoint, every step logged."""
    from repro_torch.configs.common import OPT
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def trainer(ckpt=None):
        return Trainer(loss_fn=loss_fn, init_params_fn=init_fn, batch_fn=batch_fn, opt_cfg=OPT,
                       trainer_cfg=TrainerConfig(total_steps=10 ** 9, checkpoint_every=10 ** 9),
                       ckpt_dir=ckpt, device=device)
    return trainer


def train_restart(torch, np, seed, rep, cfg, b, device, parent):
    """MIND restarted (:func:`restart_check`) over TRAIN_RESTART steps."""
    loss = train_cells("mind")[1]
    restart_check(torch, rep, "[train] MIND restart", restart_trainer(
        torch, lambda p, bt: loss(p, bt, cfg),
        lambda: train_init(torch, "mind", cfg, seed, device),
        train_batch_fn(np, "mind", cfg, b, seed, device), device), TRAIN_RESTART, parent)


def train_serve(torch, np, seed, rep, params, *, device, n, index_cfg, users_n):
    """The trained towers cast to bf16 (``SERVE_CONFIG``'s dtype, in place)
    serve ``n`` items through ``IndexedRetriever``: the kernel path's ids
    against the gather oracle's (``ORACLE_OVERLAP``), recall@10 against
    brute force (no floor)."""
    from repro_torch.serve.retrieval import IndexedRetriever

    k = 10
    params.to(torch.bfloat16)
    cfg = params.cfg = dataclasses.replace(params.cfg, dtype="bfloat16")
    retr = IndexedRetriever(params, cfg, index_cfg, device=device)
    _, build_s = timed(torch, lambda: retr.build_corpus(np.arange(n)))
    users = retrieval_users(np, seed, users_n, cfg)
    _, bf = retr.retrieve_bruteforce(users, k=k)
    (_, ids), lookup_s = timed(torch, lambda: retr.retrieve(users, k=k))
    recall = overlap(bf, ids)
    u = retr._users(users).cpu().numpy()
    oracle = retr.index.search(u, k, use_pallas_scan=False)[1]
    ov = overlap(oracle, retr.index.search(u, k)[1])
    check(ov >= ORACLE_OVERLAP, f"[train] served towers overlap the oracle by {ov} < "
          f"{ORACLE_OVERLAP}")
    rep.update(n=n, build_s=build_s, users=users_n, lookup_s=lookup_s, recall_at_10=recall,
               oracle_overlap=ov)
    log(f"[train] trained towers in bf16 serve {n} items: build {build_s:.1f} s, a Q={users_n} "
        f"lookup {lookup_s * 1e3:.2f} ms, recall@10 {recall} against brute force (no floor), "
        f"kernel path vs gather oracle id overlap {ov}")


def train_path(torch, np, seed, report, *, device="cuda", configs=None, batches=None,
               serve_n=TRAIN_SERVE_N, index_cfg=None, users_n=RETRIEVAL_USERS, ckpt_parent=None):
    """Each recsys family's ``train_batch`` cell at its published width
    (``configs``: each config module's ``CONFIG``), ``batches`` rows a
    batch (``TRAIN_BATCH``), through ``Trainer`` (:func:`train_family`),
    each family's state freed before the next; the trained two-tower
    serves (:func:`train_serve`); then the MIND restart
    (:func:`train_restart`).  Small configs and ``device="cpu"`` rehearse
    the path on the CPU."""
    configs = configs or {a: train_cells(a)[0].CONFIG for a in TRAIN_ARCHS}
    batches = batches or TRAIN_BATCH
    index_cfg = index_cfg or retrieval_index_cfg(TRAIN_SERVE_SCALE)
    report["reduced"] = {a: f"train_batch {batches[a]} rows of 65,536" for a in TRAIN_ARCHS
                         if batches[a] < 65_536}
    card = device != "cpu"
    for arch in TRAIN_ARCHS:
        report[arch] = {}
        t0 = time.perf_counter()
        tr = train_family(torch, np, seed, report[arch], arch, configs[arch], batches[arch],
                          device)
        if arch == "two-tower-retrieval":
            params = tr.params
            del tr
            gc.collect()
            report["serve"] = {}
            train_serve(torch, np, seed, report["serve"], params, device=device, n=serve_n,
                        index_cfg=index_cfg, users_n=users_n)
            del params
        else:
            del tr
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        report[arch]["seconds"] = time.perf_counter() - t0
    report["restart"] = {}
    train_restart(torch, np, seed, report["restart"], configs["mind"], batches["mind"], device,
                  ckpt_parent or ROOT / "build")
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# lm: the LM family's serving path
# ---------------------------------------------------------------------------

LM_MOE = "granite-moe-1b-a400m"     # GQA (G=2), 32 experts top-8, a padded vocab
LM_DENSE = "deepseek-7b"            # MHA at d=4,096, dense SwiGLU, an unpadded vocab
# prefill_32k is 32 sequences of 32,768 tokens, decode_32k 128 sequences
# against a 32,768-position cache (configs/common.py LM_SHAPES); the
# batches are cut to what one card serves within the path's time and 80 GB
# (PERF.md section 4): a prefill holds a (B, 8, 65,536, 1,024) f32 score
# chunk and its temporaries (~13 GB at B=2), a decode a 1.61 GB cache a
# sequence
LM_PREFILL = dict(batch=2, seq=32_768)
LM_DECODE = dict(batch=32, seq=32_768)
LM_DECODE_STEPS = 8                 # timed decode steps, after one warm-up
# deepseek-7b: a prefill of `seq` tokens, then decode_step of token `seq`
# on the cache padded to seq + 1, against a prefill over seq + 1 tokens.
# In bf16 each layer rounds its ~6 intermediates to 8 bits, and a decode's
# one-row products and the prefill's 1,025-row ones accumulate in other
# orders: the two part by a few bf16 ulps a layer (~1% of max|logits| over
# 30 layers at d=1,024 on the CPU).  A wrong position, mask or cache write
# moves the logits by their own size.
LM_CONSIST = dict(batch=2, seq=1024)
LM_CONSIST_REL = 5e-2
# each model cut to 2 layers at full width in f32 on the card and on the
# CPU, TF32 off: the last position's logits within LM_CPU_REL of their max
# |value|; the MoE's gate_idx equal but where the CPU's probabilities of the
# two experts are within LM_NEAR_TIE (ROADMAP.md, ground rules)
LM_CPU = dict(layers=2, batch=1, seq=128)
LM_CPU_REL = 1e-4
LM_NEAR_TIE = 1e-6


def lm_model(torch, cfg, seed, device):
    """``(params, prefill step, decode step)`` at ``cfg``: params made on
    ``device`` from a generator seeded ``seed``; the steps an LM's
    ``prefill_32k`` and ``decode_32k`` cells build for ``cfg``."""
    from repro_torch.configs.common import lm_step
    from repro_torch.models import transformer as tf

    params = tf.init_params(torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    return params, lm_step("prefill", cfg), lm_step("decode", cfg)


def lm_tokens(torch, np, seed, cfg, b, s, device):
    """``(b, s)`` int32 token ids uniform over ``[0, vocab)`` from ``seed``."""
    rng = np.random.default_rng(seed + 23)
    return torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)).to(device)


def lm_layer_split(torch, params, tokens, cfg, card):
    """Layer 0 of a prefill over ``tokens``, split by marks into attention
    (``chunked_attention``), FFN/MoE (``rms_norm`` + ``_ffn``) and the rest
    (the first norm, QKV, rotary, the output projection, the residual
    adds).  Returns the times and the layer's rotated ``(q, k, v)``."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf

    with torch.no_grad():
        x = params["embed"][tokens.long()]
        lp = tf.layer_params(params, 0)
        positions = torch.arange(x.shape[1], device=x.device)
        clock = Clock(torch, card)
        clock.mark()
        q, k, v = tf._qkv(lp, L.rms_norm(x, lp["ln1"]), cfg)
        q, k = L.rope(q, positions, cfg.rope_theta), L.rope(k, positions, cfg.rope_theta)
        clock.mark()
        att = L.chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
        clock.mark()
        x = x + att.reshape(*x.shape[:2], -1) @ lp["wo"]
        clock.mark()
        y, _ = tf._ffn(lp, L.rms_norm(x, lp["ln2"]), cfg)
        clock.mark()
        x = x + y
        clock.mark()
    ms = clock.ms()
    return dict(attention_ms=ms[1], ffn_ms=ms[3], rest_ms=ms[0] + ms[2] + ms[4]), (q, k, v)


def lm_attention_vs_sdpa(torch, q, k, v, cfg, card):
    """The port's ``chunked_attention`` and ``scaled_dot_product_attention``
    (causal, K and V repeated to the query heads before the clock) on the
    same bf16 inputs: ms each, CUDA events around back-to-back calls.  The
    library call is a yardstick, timed only."""
    from repro_torch.models import layers as L

    if not card:
        return dict(attention_ms=None, sdpa_ms=None)
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(g, dim=2),
                                              v.repeat_interleave(g, dim=2)))
    with torch.no_grad():
        ours = cuda_ms(lambda: L.chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk),
                       reps=2, warm=1)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=5, warm=1)
    return dict(attention_ms=ours, sdpa_ms=lib)


def lm_rel_err(got, want, cfg) -> float:
    """``max |got - want|`` over the live vocab columns, over their max |want|."""
    got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
    return float((got - want).abs().max() / want.abs().max())


def lm_logits_ok(torch, logits, cfg, what):
    """Finite logits of ``(B, vocab_padded)`` f32, the padded columns -1e30."""
    check(logits.dtype == torch.float32 and logits.shape[-1] == cfg.vocab_padded,
          f"[lm] {what}: logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"[lm] {what}: non-finite logits")
    check(bool((logits[..., cfg.vocab:] == -1e30).all()), f"[lm] {what}: padded columns")


def lm_serve_moe(torch, np, seed, rep, cfg, *, device, prefill, decode, steps):
    """granite-moe at ``cfg``: two prefills of ``prefill`` (bit-identical,
    timed), layer 0 split, attention against SDPA, then ``steps`` greedy
    decode steps on a zero cache of ``decode`` at ``pos = seq // 2``, one
    of them under ``set_sync_debug_mode("error")`` on the card."""
    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    (params, prefill_step, decode_step), init_s = timed(
        torch, lambda: lm_model(torch, cfg, seed, device))
    toks = lm_tokens(torch, np, seed, cfg, prefill["batch"], prefill["seq"], device)
    (logits, cache), first_s = timed(torch, lambda: prefill_step(params, toks))
    (logits2, cache2), prefill_s = timed(torch, lambda: prefill_step(params, toks))
    same = [torch.equal(a, b) for a, b in ((logits, logits2), (cache["k"], cache2["k"]),
                                           (cache["v"], cache2["v"]))]
    check(all(same), f"[lm] {LM_MOE}: two prefills differ (logits, k, v equal: {same})")
    lm_logits_ok(torch, logits, cfg, f"{LM_MOE} prefill")
    check(bool(torch.isfinite(cache["k"]).all() and torch.isfinite(cache["v"]).all()),
          f"[lm] {LM_MOE}: non-finite cache")
    cache_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    del logits2, cache2, cache
    split, (q, k, v) = lm_layer_split(torch, params, toks, cfg, card)
    vs = lm_attention_vs_sdpa(torch, q, k, v, cfg, card)
    del q, k, v
    n_tok = prefill["batch"] * prefill["seq"]
    rep["prefill"] = dict(batch=prefill["batch"], seq=prefill["seq"], first_s=first_s,
                          ms=prefill_s * 1e3, tokens_per_s=n_tok / prefill_s,
                          cache_bytes=cache_bytes, bit_identical=True, layer0=split, **vs)
    log(f"[lm] {LM_MOE} prefill B={prefill['batch']} S={prefill['seq']}: {prefill_s * 1e3:.1f} "
        f"ms ({n_tok / prefill_s:.0f} tokens/s; first {first_s:.2f} s), two prefills "
        f"bit-identical; layer 0: attention {split['attention_ms']:.2f} ms, MoE "
        f"{split['ffn_ms']:.2f} ms, rest {split['rest_ms']:.2f} ms; attention "
        f"{vs['attention_ms']} ms against SDPA {vs['sdpa_ms']} ms at the same shapes")

    from repro_torch.models import transformer as tf

    b, s = decode["batch"], decode["seq"]
    cache = tf.init_cache(cfg, b, s, device=device)
    pos = torch.tensor(s // 2, dtype=torch.int32, device=device)
    tok = lm_tokens(torch, np, seed + 1, cfg, b, 1, device)[:, 0]
    ok = torch.ones((), dtype=torch.bool, device=device)
    logits, cache2 = decode_step(params, cache, tok, pos, cfg)           # warm-up
    check(cache2 is cache, f"[lm] {LM_MOE}: decode_step did not write its cache in place")
    tok, pos = logits.argmax(dim=-1), pos + 1
    if card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = decode_step(params, cache, tok, pos, cfg)
    finally:
        if card:
            torch.cuda.set_sync_debug_mode("default")
    tok, pos = logits.argmax(dim=-1), pos + 1
    clock = Clock(torch, card)
    clock.mark()
    for _ in range(steps):
        logits, _ = decode_step(params, cache, tok, pos, cfg)
        ok = ok & torch.isfinite(logits).all()
        tok, pos = logits.argmax(dim=-1), pos + 1
    clock.mark()
    ms = clock.ms()[0] / steps
    check(bool(ok), f"[lm] {LM_MOE}: non-finite decode logits")
    lm_logits_ok(torch, logits, cfg, f"{LM_MOE} decode")
    written = int(pos) - s // 2
    check(bool(cache["k"][:, :, s // 2:s // 2 + written].abs().sum() > 0)
          and bool(cache["k"][:, :, s // 2 + written:].abs().sum() == 0)
          and bool(cache["k"][:, :, :s // 2].abs().sum() == 0),
          f"[lm] {LM_MOE}: the decode wrote other cache positions than {s // 2}..")
    peak = torch.cuda.max_memory_allocated() if card else None
    rep["decode"] = dict(batch=b, seq=s, pos0=s // 2, steps=steps, ms_per_step=ms,
                         tokens_per_s=b * 1e3 / ms, cache_bytes=2 * cache["k"].numel()
                         * cache["k"].element_size(), sync_free=card)
    rep.update(param_bytes=sum(t.numel() * t.element_size() for t in params.parameters()),
               init_s=init_s, peak_bytes=peak)
    log(f"[lm] {LM_MOE} decode B={b} at a {s}-position cache from pos {s // 2}: {ms:.2f} ms a "
        f"step ({b * 1e3 / ms:.0f} tokens/s), "
        f"{'one step under set_sync_debug_mode(error)' if card else 'no sync check on the CPU'}; "
        f"{rep['param_bytes']} bytes of params made in {init_s:.2f} s; peak {peak} bytes")


def lm_dense_consistency(torch, np, seed, rep, cfg, *, device, consist, tol):
    """deepseek-7b at ``cfg``: a prefill over ``seq + 1`` tokens, and a
    prefill over ``seq`` then ``decode_step`` of token ``seq`` on the cache
    padded to ``seq + 1`` (a warm-up, then the timed step under
    ``set_sync_debug_mode("error")`` on the card; each writes the same
    position): the two last-position logits within ``tol`` of their max."""
    from repro_torch.models import transformer as tf

    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    (params, prefill_step, decode_step), init_s = timed(
        torch, lambda: lm_model(torch, cfg, seed, device))
    b, s = consist["batch"], consist["seq"]
    toks = lm_tokens(torch, np, seed + 2, cfg, b, s + 1, device)
    full, _ = prefill_step(params, toks)
    (_, cache), prefill_s = timed(torch, lambda: prefill_step(params, toks[:, :s]))
    big = tf.init_cache(cfg, b, s + 1, device=device)
    for name in ("k", "v"):
        big[name][:, :, :s] = cache[name]
    del cache
    pos = torch.tensor(s, dtype=torch.int32, device=device)
    decode_step(params, big, toks[:, s], pos)           # warm-up: writes the same position
    if card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        (dec, _), decode_s = timed(torch, lambda: decode_step(params, big, toks[:, s], pos))
    finally:
        if card:
            torch.cuda.set_sync_debug_mode("default")
    lm_logits_ok(torch, full, cfg, f"{LM_DENSE} prefill")
    lm_logits_ok(torch, dec, cfg, f"{LM_DENSE} decode")
    err = lm_rel_err(dec, full, cfg)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    check(err <= tol, f"[lm] {LM_DENSE}: decode at {s} against a prefill over {s + 1}: "
          f"max error {err} of max |logits| > {tol}")
    peak = torch.cuda.max_memory_allocated() if card else None
    rep.update(batch=b, seq=s, init_s=init_s, prefill_ms=prefill_s * 1e3,
               prefill_tokens_per_s=b * s / prefill_s, decode_ms=decode_s * 1e3,
               decode_vs_prefill_rel_err=err, tol=tol, argmax_agree=agree, peak_bytes=peak,
               param_bytes=sum(t.numel() * t.element_size() for t in params.parameters()))
    log(f"[lm] {LM_DENSE}: {rep['param_bytes']} bytes of params made in {init_s:.2f} s; prefill "
        f"B={b} S={s} {prefill_s * 1e3:.1f} ms ({b * s / prefill_s:.0f} tokens/s); decode of "
        f"token {s} {decode_s * 1e3:.2f} ms{' (sync-free)' if card else ''}; against the prefill "
        f"over {s + 1}: max "
        f"error {err:.3e} of max |logits| (tol {tol}), argmax agree {agree}; peak {peak} bytes")


def lm_routed_prefill(torch, params, tokens, cfg):
    """``prefill``'s last logits and, for each MoE layer, the router's
    ``(gate_idx, probs)`` on its input, recorded around ``layers.moe``."""
    from unittest import mock

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf

    seen, real = [], L.moe

    def recording(p, x, **kw):
        probs, _, idx = L.moe_gates(p, x, kw["top_k"])
        seen.append((idx.cpu(), probs.cpu()))
        return real(p, x, **kw)

    with mock.patch.object(L, "moe", recording):
        logits, _ = tf.prefill(params, tokens, cfg)
    return logits.cpu(), seen


def lm_card_vs_cpu(torch, np, seed, rep, arch, cfg, *, device, shape):
    """``arch`` cut to ``shape["layers"]`` layers at full width in f32: the
    same params (made on ``device``, carried to the CPU by ``convert``) and
    prompt through ``prefill`` on both; the last logits within LM_CPU_REL of
    their max, the MoE's gate_idx equal but at near-ties."""
    from repro_torch import convert

    cut = dataclasses.replace(cfg, n_layers=shape["layers"], dtype="float32")
    params, _, _ = lm_model(torch, cut, seed, device)
    host, copy_s = timed(torch, lambda: convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(params), cut, device="cpu"))
    toks = lm_tokens(torch, np, seed + 3, cut, shape["batch"], shape["seq"], device)
    got, gates = lm_routed_prefill(torch, params, toks, cut)
    del params
    t0 = time.perf_counter()
    want, cpu_gates = lm_routed_prefill(torch, host, toks.cpu(), cut)
    cpu_s = time.perf_counter() - t0
    err = lm_rel_err(got, want, cut)
    check(err <= LM_CPU_REL, f"[lm] {arch} at {shape['layers']} layers: card against CPU "
          f"logits {err} of max |logits| > {LM_CPU_REL}")
    diff, ties, gap = 0, 0, 0.0
    for (idx, _), (cidx, cprobs) in zip(gates, cpu_gates):
        for t, kk in (idx != cidx).nonzero().tolist():
            g = abs(float(cprobs[t, idx[t, kk]] - cprobs[t, cidx[t, kk]]))
            diff += 1
            ties += g <= LM_NEAR_TIE
            gap = max(gap, g)
    check(diff == ties, f"[lm] {arch}: {diff - ties} gate_idx differ past a near-tie "
          f"(largest probability gap {gap})")
    rep.update(layers=shape["layers"], batch=shape["batch"], seq=shape["seq"],
               logits_rel_err=err, tol=LM_CPU_REL, moe_layers=len(gates),
               gate_idx_differ=diff, near_tie=LM_NEAR_TIE, host_copy_s=copy_s, cpu_s=cpu_s)
    log(f"[lm] {arch} at {shape['layers']} layers, f32, a {shape['seq']}-token prompt: card "
        f"against CPU logits {err:.3e} of max |logits| (tol {LM_CPU_REL}); gate_idx differ at "
        f"{diff} of {sum(g[0].numel() for g in gates)} (near-ties); CPU {cpu_s:.1f} s")


def lm_path(torch, np, seed, report, *, device="cuda", configs=None, prefill=LM_PREFILL,
            decode=LM_DECODE, steps=LM_DECODE_STEPS, consist=LM_CONSIST, cpu=LM_CPU,
            consist_tol=LM_CONSIST_REL):
    """The LM family served at its published widths and depths (``configs``:
    each arch's ``CONFIG``, bf16, params made on the device from ``seed``):
    granite-moe-1b-a400m prefills and decodes (:func:`lm_serve_moe`),
    deepseek-7b's decode against a longer prefill
    (:func:`lm_dense_consistency`), then both cut to 2 layers in f32 on the
    card against the CPU (:func:`lm_card_vs_cpu`); each model freed before
    the next.  Small configs and ``device="cpu"`` rehearse it on the CPU."""
    from repro_torch.configs import deepseek_7b, granite_moe_1b_a400m

    configs = configs or {LM_MOE: granite_moe_1b_a400m.CONFIG, LM_DENSE: deepseek_7b.CONFIG}
    card = device != "cpu"

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    report["reduced"] = {
        f"{LM_MOE}/prefill_32k": f"batch {prefill['batch']} of 32",
        f"{LM_MOE}/decode_32k": f"batch {decode['batch']} of 128, {steps} steps",
        f"{LM_DENSE}": f"prefill B={consist['batch']} S={consist['seq']}, one decode step",
        "card_vs_cpu": f"{cpu['layers']} layers, f32, one {cpu['seq']}-token prompt"}
    t0 = time.perf_counter()
    report[LM_MOE] = {}
    lm_serve_moe(torch, np, seed, report[LM_MOE], configs[LM_MOE], device=device,
                 prefill=prefill, decode=decode, steps=steps)
    report[LM_MOE]["seconds"] = time.perf_counter() - t0
    free()
    t0 = time.perf_counter()
    report[LM_DENSE] = {}
    lm_dense_consistency(torch, np, seed, report[LM_DENSE], configs[LM_DENSE], device=device,
                         consist=consist, tol=consist_tol)
    report[LM_DENSE]["seconds"] = time.perf_counter() - t0
    free()
    report["card_vs_cpu"] = {}
    for arch in (LM_MOE, LM_DENSE):
        report["card_vs_cpu"][arch] = {}
        lm_card_vs_cpu(torch, np, seed, report["card_vs_cpu"][arch], arch, configs[arch],
                       device=device, shape=cpu)
        free()
    return report


# ---------------------------------------------------------------------------
# lm_train: granite-moe-1b-a400m's train_4k cell on the card
# ---------------------------------------------------------------------------

# train_4k is 256 sequences of 4,096 tokens (configs/common.py LM_SHAPES);
# the batch is the largest power of two that one card's 80 GB holds with
# the remat (scripts/lm_train_on_card.py probe=8,16,32; PERF.md section 4):
# the (B, 4,096, 49,408) f32 logits, their softmax and gradient are ~0.8 GB
# a sequence each.  B=16 peaks at 82.9 GB in a one-step probe and runs out
# of memory in this part; B=32 asks for 24.12 GiB more than is free
LM_TRAIN_SEQ = 4096
LM_TRAIN_BATCH = 8
LM_TRAIN_WARM = 1                  # warm-up steps, then the timed ones
LM_TRAIN_TIMED = 3
# the first step of the model cut to 2 layers at full width in f32 (TF32
# off) on the card against the CPU, at the train path's bounds
LM_TRAIN_CPU = dict(layers=2, batch=1, seq=512)
# remat on against off: 2 layers at full width, a batch both hold
LM_REMAT = dict(layers=2, batch=8, seq=LM_TRAIN_SEQ)
# the restart: 2 layers at full width, 6 steps or 3 + checkpoint + 3
LM_RESTART = dict(layers=2, batch=2, seq=1024, steps=6)


def lm_train_batch_fn(np, seed, cfg, b, s):
    """Step ``t``'s batch: ``(b, s)`` tokens uniform over ``[0, vocab)``
    from ``default_rng((seed, 29, t))``, the labels the tokens (the
    ``train_4k`` cell's smoke batch)."""
    def batch_fn(t):
        toks = np.random.default_rng((seed, 29, t)).integers(0, cfg.vocab, size=(b, s))
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}
    return batch_fn


def on_device(torch, batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def lm_init(torch, cfg, seed, device):
    from repro_torch.models import transformer as tf

    return tf.init_params(torch.Generator(device=device).manual_seed(seed), cfg, device=device)


def run_steps(torch, np, step, params, opt, batch_for, n, card, what, *, moments=False):
    """``n`` steps of ``step`` from batch 0, each synchronised and timed on
    the host clock: every leaf must move in step 1 (``moments``: its AdamW
    first moment, for bf16 parameters, where step 1's update of a norm
    scale of 1 rounds away) and every step's loss and ``grad_norm`` be
    finite, ``grad_norm > 0``.  Returns the metrics (floats, with ``ms``)
    of each step."""
    from repro_torch.convert import param_leaves

    watch = (lambda: opt["m"]) if moments else (lambda: [t for _, t, _ in param_leaves(params)])
    before = tensor_samples(watch())
    out = []
    for t in range(n):
        batch = batch_for(t)
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        if card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append({**{k: float(v) for k, v in m.items()}, "ms": ms})
        if t == 0:
            moved = [not torch.equal(x, y) for x, y in zip(before, tensor_samples(watch()))]
            check(all(moved), f"{what}: {moved.count(False)} leaves did not move in step 1")
            del before
        check(np.isfinite(out[-1]["loss"]) and np.isfinite(out[-1]["grad_norm"])
              and out[-1]["grad_norm"] > 0, f"{what}: step {t + 1} {out[-1]}")
    return out


def lm_train_full(torch, np, seed, rep, cfg, *, device, batch, seq, warm, timed_steps):
    """granite-moe's ``train_4k`` cell at ``cfg`` (its full ``CONFIG``: bf16
    params, f32 AdamW state, the remat) through the cell's step: ``warm``
    + ``timed_steps`` steps on ``(batch, seq)`` tokens, then one more split
    into forward, backward and AdamW (CUDA events)."""
    from repro_torch.configs.common import lm_step
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init

    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(torch, lambda: lm_init(torch, cfg, seed, device))
    opt = adamw_init(params)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      [*params.parameters(), *opt["m"], *opt["v"]])
    batch_np = lm_train_batch_fn(np, seed, cfg, batch, seq)
    steps = run_steps(torch, np, lm_step("train", cfg), params, opt,
                      lambda t: on_device(torch, batch_np(t), device), warm + timed_steps, card,
                      f"[lm_train] {LM_MOE}", moments=cfg.dtype != "float32")
    split = split_step(torch, lambda p, b: tf.loss_fn(p, b, cfg), params, opt,
                       on_device(torch, batch_np(warm + timed_steps), device), device)
    peak = torch.cuda.max_memory_allocated() if card else None
    step_ms = [x["ms"] for x in steps]
    p50 = statistics.median(step_ms[warm:])
    rep.update(batch=batch, seq=seq, layers=cfg.n_layers, remat=cfg.remat, init_s=init_s,
               state_bytes=state_bytes, step_ms=step_ms, p50_ms=p50,
               tokens_per_s=batch * seq * 1e3 / p50, split=split, peak_bytes=peak,
               losses=[x["loss"] for x in steps], grad_norms=[x["grad_norm"] for x in steps])
    log(f"[lm_train] {LM_MOE} train_4k B={batch} S={seq}, {cfg.n_layers} layers: step p50 "
        f"{p50:.1f} ms ({rep['tokens_per_s']:.0f} tokens/s; steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms); one step forward "
        f"{split['forward_ms']:.1f} / backward {split['backward_ms']:.1f} / AdamW "
        f"{split['adamw_ms']:.1f} ms; {state_bytes} bytes of params and AdamW state made in "
        f"{init_s:.2f} s; peak {peak} bytes; losses {rep['losses']}")


def lm_train_vs_cpu(torch, np, seed, rep, cfg, *, device, shape):
    """The model cut to ``shape["layers"]`` layers at full width in f32:
    step 1 on the card against the CPU on the same params (carried by
    ``convert``) and batch."""
    from repro_torch import convert
    from repro_torch.configs.common import lm_step
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init

    cut = dataclasses.replace(cfg, n_layers=shape["layers"], dtype="float32")
    params = lm_init(torch, cut, seed, device)
    host, copy_s = timed(torch, lambda: convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(params), cut, device="cpu"))
    batch = lm_train_batch_fn(np, seed + 1, cut, shape["batch"], shape["seq"])(0)
    first = run_steps(torch, np, lm_step("train", cut), params, adamw_init(params),
                      lambda t: on_device(torch, batch, device), 1, device != "cpu",
                      f"[lm_train] {LM_MOE} at {shape['layers']} layers")[0]
    del params
    out = first_step_vs_cpu(torch, first, lambda p, b: tf.loss_fn(p, b, cut), host,
                            on_device(torch, batch, "cpu"),
                            f"[lm_train] {LM_MOE} at {shape['layers']} layers")
    rep.update(layers=shape["layers"], batch=shape["batch"], seq=shape["seq"],
               host_copy_s=copy_s, **out)
    log(f"[lm_train] {LM_MOE} at {shape['layers']} layers, f32, {shape['batch']} x "
        f"{shape['seq']} tokens: first step loss {out['loss']:.6f} (CPU {out['cpu_loss']:.6f}, "
        f"rel {out['loss_rel_err']:.2e}), grad_norm {out['grad_norm']:.6f} (CPU "
        f"{out['cpu_grad_norm']:.6f}, rel {out['grad_norm_rel_err']:.2e}; CPU step "
        f"{out['cpu_step_s']:.1f} s)")


def lm_remat_peaks(torch, np, seed, rep, cfg, *, device, shape):
    """One step at ``shape`` with ``remat`` on and off, from the same params
    and batch: the losses equal, the peak of each (the remat's must be the
    lower on the card)."""
    from repro_torch.configs.common import lm_step
    from repro_torch.train.optimizer import adamw_init

    card = device != "cpu"
    batch = lm_train_batch_fn(np, seed + 2, cfg, shape["batch"], shape["seq"])(0)
    out = {}
    for remat in (True, False):
        cut = dataclasses.replace(cfg, n_layers=shape["layers"], remat=remat)
        params = lm_init(torch, cut, seed, device)
        opt = adamw_init(params)
        b = on_device(torch, batch, device)
        gc.collect()
        if card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        m, ms = timed(torch, lambda: lm_step("train", cut)(params, opt, b)[2])
        out[remat] = dict(loss=m["loss"], grad_norm=float(m["grad_norm"]), ms=ms * 1e3,
                          peak_bytes=torch.cuda.max_memory_allocated() if card else None,
                          base_bytes=base if card else None)
        del params, opt, b, m
    on, off = out[True], out[False]
    check(bool(torch.equal(on["loss"].cpu(), off["loss"].cpu())),
          f"[lm_train] remat: loss {float(on['loss'])} != {float(off['loss'])} without it")
    if card:
        check(on["peak_bytes"] < off["peak_bytes"], f"[lm_train] remat: peak "
              f"{on['peak_bytes']} bytes not below {off['peak_bytes']} without it")
    for x in (on, off):
        x["loss"] = float(x["loss"])
    rep.update(layers=shape["layers"], batch=shape["batch"], seq=shape["seq"], remat_on=on,
               remat_off=off, grad_norm_rel_err=rel_err(on["grad_norm"], off["grad_norm"]))
    log(f"[lm_train] remat at {shape['layers']} layers, B={shape['batch']} S={shape['seq']}: "
        f"loss {on['loss']:.6f} both ways; peak {on['peak_bytes']} bytes with it, "
        f"{off['peak_bytes']} without (params and state {on['base_bytes']}); step "
        f"{on['ms']:.1f} ms against {off['ms']:.1f} ms; grad_norm rel "
        f"{rep['grad_norm_rel_err']:.2e}")


def lm_train_path(torch, np, seed, report, *, device="cuda", cfg=None, batch=LM_TRAIN_BATCH,
                  seq=LM_TRAIN_SEQ, warm=LM_TRAIN_WARM, timed_steps=LM_TRAIN_TIMED,
                  cpu=LM_TRAIN_CPU, remat=LM_REMAT, restart=LM_RESTART, ckpt_parent=None):
    """granite-moe-1b-a400m trained on the card: its ``train_4k`` cell at the
    full ``CONFIG`` (:func:`lm_train_full`), then at 2 layers and full
    width the first step against the CPU (:func:`lm_train_vs_cpu`), remat
    on against off (:func:`lm_remat_peaks`) and a restart
    (:func:`restart_check`); each model freed before the next.  Small
    configs and ``device="cpu"`` rehearse it on the CPU."""
    from repro_torch.configs import granite_moe_1b_a400m
    from repro_torch.models import transformer as tf

    cfg = cfg or granite_moe_1b_a400m.CONFIG
    card = device != "cpu"

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    report["reduced"] = {
        f"{LM_MOE}/train_4k": f"batch {batch} of 256, {warm} + {timed_steps} steps",
        "card_vs_cpu": f"{cpu['layers']} layers, f32, {cpu['batch']} x {cpu['seq']} tokens",
        "remat": f"{remat['layers']} layers, B={remat['batch']} S={remat['seq']}, one step",
        "restart": f"{restart['layers']} layers, B={restart['batch']} S={restart['seq']}"}
    for name, fn, kw in (
            ("train_4k", lm_train_full, dict(batch=batch, seq=seq, warm=warm,
                                             timed_steps=timed_steps)),
            ("card_vs_cpu", lm_train_vs_cpu, dict(shape=cpu)),
            ("remat", lm_remat_peaks, dict(shape=remat))):
        t0 = time.perf_counter()
        report[name] = {}
        fn(torch, np, seed, report[name], cfg, device=device, **kw)
        report[name]["seconds"] = time.perf_counter() - t0
        free()
    t0 = time.perf_counter()
    report["restart"] = {}
    cut = dataclasses.replace(cfg, n_layers=restart["layers"])
    restart_check(torch, report["restart"], f"[lm_train] {LM_MOE} restart at {cut.n_layers} "
                  "layers", restart_trainer(
                      torch, lambda p, b: tf.loss_fn(p, b, cut),
                      lambda: lm_init(torch, cut, seed, device),
                      lm_train_batch_fn(np, seed + 3, cut, restart["batch"], restart["seq"]),
                      device), restart["steps"], ckpt_parent or ROOT / "build")
    report["restart"]["seconds"] = time.perf_counter() - t0
    free()
    return report


# ---------------------------------------------------------------------------
# gnn: gat-cora's four cells in training
# ---------------------------------------------------------------------------

GNN_ARCH = "gat-cora"
# the cells in the order the path runs them, each at its published shape
# (configs/common.py GNN_SHAPES); minibatch_lg samples with fanouts 15-10
GNN_ORDER = ("full_graph_sm", "molecule", "minibatch_lg", "ogb_products")
GNN_WARM = 1                       # warm-up steps, then the timed ones
GNN_TIMED = 3
# step 1 on the card against the CPU (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL);
# ogb_products' CPU step would take minutes and ~60 GB of host memory
GNN_CPU_CHECK = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_RESTART = 6                    # minibatch_lg: 6 steps, or 3 + checkpoint + 3


def gnn_cell(torch, np, seed, rep, shape, sh, cfg, *, device, stream):
    """One GAT cell at shape ``sh``: the batch (``minibatch_lg``: batch
    ``t`` of ``stream``; the others one batch drawn from ``seed`` as the
    reference's smoke inputs draw it), params from ``seed``, GNN_WARM +
    GNN_TIMED steps of the cell's step, one more split into forward,
    backward and AdamW; two no-grad forwards bit-identical."""
    from repro_torch import convert
    from repro_torch.configs.common import gnn_batch, gnn_graph_batch, gnn_step
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import adamw_init

    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    if stream is not None:
        batch_for = lambda t: gnn_graph_batch(stream(t), device)         # noqa: E731
        b0, batch_s = timed(torch, lambda: batch_for(0))
    else:
        b0, batch_s = timed(torch, lambda: gnn_batch(shape, sh, np.random.default_rng(seed),
                                                     device=device))
        batch_for = lambda t: b0                                         # noqa: E731
    params, init_s = timed(torch, lambda: gnn.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device))
    host = None
    if shape in GNN_CPU_CHECK:
        host = (convert.gnn_params_from_numpy(convert.gnn_params_to_numpy(params), cfg,
                                              device="cpu"),
                {k: v.cpu() for k, v in b0.items()})
    opt = adamw_init(params)
    what = f"[gnn] {GNN_ARCH}/{shape}"
    steps = run_steps(torch, np, gnn_step(cfg), params, opt,
                      lambda t: b0 if t == 0 else batch_for(t), GNN_WARM + GNN_TIMED, card, what)
    loss_fn = lambda p, b: gnn.loss_fn(p, b, cfg)                        # noqa: E731
    split = split_step(torch, loss_fn, params, opt, batch_for(GNN_WARM + GNN_TIMED), device)
    with torch.no_grad():
        f1 = gnn.forward(params, b0, cfg)
        f2 = gnn.forward(params, b0, cfg)
        same = bool(torch.equal(f1, f2))
        finite = bool(torch.isfinite(f1).all())
    check(same, f"{what}: two forwards differ")
    check(finite and tuple(f1.shape) == (sh.get("n_graphs", b0["features"].shape[0]),
                                         cfg.n_classes), f"{what}: logits {tuple(f1.shape)}")
    del f1, f2
    peak = torch.cuda.max_memory_allocated() if card else None
    first = None
    if host is not None:
        del params, opt
        first = first_step_vs_cpu(torch, steps[0], loss_fn, host[0], host[1], what)
    step_ms = [x["ms"] for x in steps]
    rep.update(nodes=int(b0["features"].shape[0]), edges=int(b0["edge_src"].shape[0]),
               d_feat=cfg.d_in, classes=cfg.n_classes, batch_s=batch_s, init_s=init_s,
               step_ms=step_ms, p50_ms=statistics.median(step_ms[GNN_WARM:]), split=split,
               peak_bytes=peak, first_step=first, forward_bit_identical=same,
               losses=[x["loss"] for x in steps], accs=[x["acc"] for x in steps],
               grad_norms=[x["grad_norm"] for x in steps])
    log(f"{what}: {rep['nodes']} nodes, {rep['edges']} edges, {cfg.d_in} features; step p50 "
        f"{rep['p50_ms']:.2f} ms (steps {', '.join(f'{x:.2f}' for x in step_ms)} ms); one step "
        f"forward {split['forward_ms']:.2f} / backward {split['backward_ms']:.2f} / AdamW "
        f"{split['adamw_ms']:.2f} ms; peak {peak} bytes; batch made in {batch_s:.2f} s; two "
        f"forwards bit-identical"
        + (f"; first step loss rel {first['loss_rel_err']:.2e}, grad_norm rel "
           f"{first['grad_norm_rel_err']:.2e} against the CPU" if first else ""))


def gnn_path(torch, np, seed, report, *, device="cuda", shapes=None, fanouts=None,
             ckpt_parent=None, cells=GNN_ORDER):
    """gat-cora's four training cells at their published shapes
    (``shapes``: ``GNN_SHAPES``), each through the cell's step
    (:func:`gnn_cell`) and freed before the next; ``minibatch_lg`` samples
    its batches from ``CSRGraph.random`` over its node slots with the
    fanouts 15-10 (``minibatch_stream``), then restarts from that stream
    (:func:`restart_check`).  ``cells`` picks some of them.  Small shapes
    and ``device="cpu"`` rehearse it on the CPU."""
    from repro_torch.configs import gat_cora
    from repro_torch.configs.common import GNN_FANOUTS, GNN_SHAPES, gnn_cfg
    from repro_torch.data.graphs import CSRGraph, minibatch_stream
    from repro_torch.models import gnn

    shapes = shapes or GNN_SHAPES
    fanouts = fanouts or GNN_FANOUTS
    card = device != "cpu"
    ogb, full = shapes["ogb_products"], GNN_SHAPES["ogb_products"]
    report["reduced"] = ({"ogb_products": f"{ogb['n_edges']} edges of {full['n_edges']}"}
                         if ogb["n_nodes"] == full["n_nodes"] and ogb["n_edges"] < full["n_edges"]
                         else {})
    samples: dict = {}
    for shape in cells:
        sh = shapes[shape]
        cfg = gnn_cfg(gat_cora.CONFIG, sh)
        t0 = time.perf_counter()
        report[shape] = {}
        stream = None
        if shape == "minibatch_lg":
            graph, graph_s = timed(torch, lambda: CSRGraph.random(
                max(64, sh["n_nodes"]), avg_degree=8, d_feat=sh["d_feat"],
                n_classes=sh["n_classes"], seed=seed))
            draw = minibatch_stream(graph, sh["n_targets"], fanouts, seed=seed)

            def stream(t, draw=draw):
                if t not in samples:                  # each step's batch sampled once
                    samples[t] = {k: v for k, v in draw(t).items() if k != "node_ids"}
                return samples[t]
            report[shape]["graph_s"] = graph_s
            report[shape]["fanouts"] = list(fanouts)
        gnn_cell(torch, np, seed, report[shape], shape, sh, cfg, device=device, stream=stream)
        report[shape]["make_s"] = report[shape].get("graph_s", 0.0) + report[shape]["batch_s"]
        if shape == "minibatch_lg":
            report["restart"] = {}
            restart_check(torch, report["restart"], f"[gnn] {GNN_ARCH}/minibatch_lg restart",
                          restart_trainer(
                              torch, lambda p, b, cfg=cfg: gnn.loss_fn(p, b, cfg),
                              lambda cfg=cfg: gnn.init_params(
                                  torch.Generator(device=device).manual_seed(seed), cfg,
                                  device=device),
                              stream, device), GNN_RESTART, ckpt_parent or ROOT / "build")
            del graph, draw, stream
            samples.clear()
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        report[shape]["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# the index cells: spfresh-1b's five and retrieval_cand_ann, on the paths'
# states, and their dry-run records
# ---------------------------------------------------------------------------

# the path whose state each index cell's step runs on
INDEX_CELLS = {
    ("spfresh-1b", "serve_search"): "fp32",
    ("spfresh-1b", "serve_search_paged"): "fp32",
    ("spfresh-1b", "serve_update"): "fp32",
    ("spfresh-1b", "maintain"): "update",
    ("spfresh-1b", "serve_search_grouped"): "grouped",
    ("two-tower-retrieval", "retrieval_cand_ann"): "retrieval",
}
# the kernels each index cell must launch on its path's state (the round
# may find no job on the drained update state, and then launches none)
INDEX_CELL_KERNELS = {
    "serve_search": ("l2_topk_tiles", "scan_batched_topk_pairs"),
    "serve_search_paged": ("l2_topk_tiles", "scan_batched_topk_pairs"),
    "serve_update": ("l2_topk_tiles",),
    "maintain": (),
    "serve_search_grouped": ("scan_batched_topk_pairs",),
    "retrieval_cand_ann": ("l2_topk_tiles", "scan_per_query_topk"),
}
ALLOC_BLOCK = 512       # the CUDA caching allocator rounds each tensor up to this


def launch_counts() -> dict:
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    return {**LK.LAUNCHES, **SK.LAUNCHES}


def output_tensors(out, name="out"):
    """``[(name, tensor)]`` of a step's outputs: tensors, tuples and lists
    of them, index states by leaf."""
    import torch

    from repro_torch.utils.tree import tensor_leaves

    if isinstance(out, torch.Tensor):
        return [(name, out)]
    if isinstance(out, (list, tuple)):
        return [e for i, x in enumerate(out) for e in output_tensors(x, f"{name}[{i}]")]
    return [(f"{name}.{k}", t) for k, t in tensor_leaves(out).items()]


def check_index_cell(torch, out, arch, shape, args, direct, *, device="cuda", kwargs=None,
                     deterministic=False):
    """Run the cell's ``step_fn`` once on ``args`` (through ``get_cell``)
    and hold every output tensor bit for bit against ``direct()``, the call
    it wraps; count the kernels the step launched and require the cell's
    ``INDEX_CELL_KERNELS``.  ``deterministic`` runs both under
    ``torch.use_deterministic_algorithms``."""
    from repro_torch.configs import get_cell

    t0 = time.perf_counter()
    step = get_cell(arch, shape).step_fn
    with deterministic_algorithms(torch) if deterministic else contextlib.nullcontext():
        before = launch_counts()
        got, s = timed(torch, lambda: step(*args, **(kwargs or {})))
        launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        want = direct()
    got_t, want_t = output_tensors(got), output_tensors(want)
    check([n for n, _ in got_t] == [n for n, _ in want_t],
          f"[{shape}] outputs {[n for n, _ in got_t]} against {[n for n, _ in want_t]}")
    for (name, a), (_, b) in zip(got_t, want_t):
        check(a.dtype == b.dtype and bool(torch.equal(a, b)),
              f"[{shape}] {name} differs from the call the step wraps")
    if device == "cuda":
        for name in INDEX_CELL_KERNELS[shape]:
            check(launches.get(name, 0) > 0, f"[{shape}] the step launched no {name}: {launches}")
    out[shape] = dict(path=INDEX_CELLS[(arch, shape)], step_ms=s * 1e3, launches=launches,
                      outputs=len(got_t), seconds=time.perf_counter() - t0)
    log(f"[index cells] {arch}/{shape} on the {INDEX_CELLS[(arch, shape)]} path's state: "
        f"{len(got_t)} output tensors bit for bit against the call it wraps; step "
        f"{s * 1e3:.2f} ms; launches {launches}")
    return got


def insert_one_shard(torch, st, vecs, valid):
    """What ``serve_update`` wraps on one shard: every valid row is the
    shard's, its slot ``next_vid`` + its rank, then ``lire.insert_batch``;
    a landed row's handle is its slot (shard 0's handles are its vids)."""
    from repro_torch.core import lire

    order = torch.cumsum(valid.to(torch.int32), 0) - 1
    slots = torch.where(valid, st.next_vid + order, -1).to(torch.int32)
    mine = valid & (slots < st.cfg.num_vectors_cap)
    st = st.replace(next_vid=st.next_vid + mine.sum().to(torch.int32))
    st, landed = lire.insert_batch(st, vecs, torch.clamp(slots, min=0), mine)
    return [st], torch.where(mine & landed, slots, -1).to(torch.int32)


def fp32_index_cells(torch, out, state, q_t, vecs, *, device="cuda"):
    """``serve_search``, ``serve_search_paged`` and ``serve_update`` on the
    fp32 path's final state (one shard, alive)."""
    from repro_torch.core import lire

    alive = torch.ones(1, dtype=torch.bool, device=device)
    k, nprobe = 10, state.cfg.nprobe
    check_index_cell(torch, out, "spfresh-1b", "serve_search", ([state], q_t, alive),
                     lambda: lire.search(state, q_t, k=k, nprobe=nprobe), device=device)
    check_index_cell(torch, out, "spfresh-1b", "serve_search_paged", ([state], q_t, alive),
                     lambda: lire.search(state, q_t, k=k, nprobe=nprobe, use_pallas_scan=True,
                                         scan_schedule="batched"), device=device)
    valid = torch.ones(vecs.shape[0], dtype=torch.bool, device=device)
    check_index_cell(torch, out, "spfresh-1b", "serve_update", ([state], vecs, valid),
                     lambda: insert_one_shard(torch, state, vecs, valid), device=device)


def maintain_index_cell(torch, out, state, *, device="cuda"):
    """``maintain`` on the update path's state against ``lire.maintenance_round``
    at ``jobs_per_round``, both under deterministic algorithms."""
    from repro_torch.core import lire

    def direct():
        st, did = lire.maintenance_round(state, state.cfg.jobs_per_round)
        return [st], did.to(torch.int32)

    got = check_index_cell(torch, out, "spfresh-1b", "maintain", ([state],), direct,
                           device=device, deterministic=True)
    out["maintain"]["jobs"] = int(got[1])


def ann_index_cell(torch, np, out, retr, params, user, *, device="cuda"):
    """``retrieval_cand_ann`` on one user against the retriever's index (one
    shard), held against ``lire.search`` at nprobe 16 on the retriever's own
    user tower; its handles mapped through the retriever's id map must be
    ``retrieve``'s ids, and ``1 - d / 2`` its scores."""
    from repro_torch.configs.two_tower_retrieval import ANN_NPROBE
    from repro_torch.core import lire

    state = retr.index.state
    alive = torch.ones(1, dtype=torch.bool, device=device)
    got = check_index_cell(
        torch, out, "two-tower-retrieval", "retrieval_cand_ann",
        (params, torch.as_tensor(user, device=device), [state], alive),
        lambda: lire.search(state, retr._users(user), k=10, nprobe=ANN_NPROBE), device=device)
    scores, ids = retr.retrieve(user, k=10, nprobe=ANN_NPROBE)
    d, v = (x.cpu().numpy() for x in got)
    check(bool(np.array_equal(np.where(v >= 0, retr._id_map[np.maximum(v, 0)], -1), ids)),
          "[retrieval_cand_ann] the step's items are not IndexedRetriever.retrieve's")
    check(bool(np.array_equal(np.where(v >= 0, 1.0 - d / 2.0, -np.inf), scores)),
          "[retrieval_cand_ann] the step's scores are not IndexedRetriever.retrieve's")
    log("[index cells] retrieval_cand_ann: items and scores equal IndexedRetriever.retrieve's")


def index_cells_records(torch, out, *, device="cuda"):
    """The dry run's ``card`` records of the six index cells, and an empty
    ``CONFIG`` state allocated on the card: its ``memory_allocated`` delta
    must be the dry run's ``meta`` count of one shard's state, each leaf
    rounded up to the allocator's 512-byte blocks."""
    from repro_torch.configs.spfresh import CONFIG
    from repro_torch.core.types import make_empty_state
    from repro_torch.launch import dryrun
    from repro_torch.utils.tree import tensor_leaves

    recs = {f"{a}/{s}": dryrun.run_cell(a, s, "card") for a, s in INDEX_CELLS}
    for name, r in recs.items():
        check(r["status"] == "ok", f"[index cells] dry run of {name}: {r['status']}")
    leaves = list(tensor_leaves(make_empty_state(CONFIG, device="meta")).values())
    raw = sum(t.numel() * t.element_size() for t in leaves)
    blocks = sum(-(-t.numel() * t.element_size() // ALLOC_BLOCK) * ALLOC_BLOCK for t in leaves)
    counted = recs["spfresh-1b/serve_update"]["memory_analysis"]["argument_bytes_each"][0]
    check(raw == counted, f"[index cells] meta state {raw} bytes, the dry run counts {counted}")
    delta = None
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        st = make_empty_state(CONFIG, device=device)
        torch.cuda.synchronize()
        delta = torch.cuda.memory_allocated() - m0
        del st
        check(delta == blocks, f"[index cells] an empty CONFIG state took {delta} bytes on the "
              f"card; the dry run's meta count is {raw} ({blocks} in 512-byte blocks)")
    out["empty_config_state"] = dict(meta_bytes=raw, meta_bytes_in_blocks=blocks,
                                     card_delta=delta, leaves=len(leaves))
    log(f"[index cells] empty CONFIG state: dry-run meta count {raw} bytes over {len(leaves)} "
        f"leaves, {blocks} in 512-byte allocator blocks; memory_allocated delta on the card "
        f"{delta}")
    keep = ("arch", "shape", "status", "card_run", "count_s", "fits_80gb")
    return {name: {**{k: r[k] for k in keep},
                   "argument_bytes": r["memory_analysis"]["argument_bytes"],
                   "output_bytes": r["memory_analysis"]["output_bytes"],
                   "flops": r["cost_analysis"]["flops"],
                   "bytes_accessed": r["cost_analysis"]["bytes_accessed"],
                   "kernel_work": r["cost_analysis"]["kernel_work"],
                   "compute_s": r["roofline"]["compute_s"], "memory_s": r["roofline"]["memory_s"],
                   "dominant": r["roofline"]["dominant"]} for name, r in recs.items()}


def smoke_time_cuts() -> dict:
    """The earlier paths' depth and steps cut for the smoke's time budget
    (PERF.md section 4); a path's cuts by memory stand in its own report."""
    return {"fp32, int8": f"N={N_BASE} of 1,000,000",
            "serve": f"async phase {ASYNC_THREADS} x {ASYNC_OPS} operations of 4 x 200",
            "durable": f"N={DURABLE_N} of the update path's {UPDATE_N}",
            "sharded": f"{SHARDED_STEPS} request steps of 16, {SHARDED_THREADS} x {SHARDED_OPS} "
                       "async operations of 4 x 40",
            "retrieval": f"{RETRIEVAL_N} of retrieval_cand's 1,000,000 candidates; churn "
                         f"+{RETRIEVAL_ADD} / -{RETRIEVAL_REMOVE} items of +16,384 / -4,096"}


def main() -> int:
    ap = argparse.ArgumentParser(description="chip smoke for the PyTorch/CUDA port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace, read when CUDA starts (the update path's
    # replayed round runs in that mode)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.spfresh import SEARCH_Q
    from repro_torch.kernels import build
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    ptxas = {}
    for name, text in logs.items():
        entries = ptxas_entries(text)
        for fn, regs, spill in entries:
            log(f"  {name}: {fn}: {regs} registers, {spill} bytes of spill stores and loads")
        ptxas[name] = dict(entries=len(entries),
                           max_registers=max((e[1] for e in entries), default=None),
                           spill_bytes=sum(e[2] for e in entries))
        log(f"  {name}: {len(entries)} entry functions, at most "
            f"{ptxas[name]['max_registers']} registers, {ptxas[name]['spill_bytes']} "
            "bytes of spill stores and loads in all")

    report = {"card": card, "kernel_build_s": build_s, "n": N_BASE, "seed": args.seed,
              "ptxas": ptxas, "reduced": smoke_time_cuts()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    phase_resources(torch, gen, report)
    results: dict = {}
    phase_l2_topk(torch, gen, results)
    blocks = phase_scan_per_query(torch, gen, results)
    phase_scan_batched(torch, gen, results, blocks)
    phase_scan_unreduced(torch, gen, results, blocks)
    phase_scan_q8(torch, gen, results, blocks)
    del blocks
    torch.cuda.empty_cache()
    phase_d256(torch, gen, results)
    torch.cuda.empty_cache()

    counters = (LK.LAUNCHES, SK.LAUNCHES)
    launches = {name: 0 for c in counters for name in c}

    def reset():
        for c in counters:
            for key in c:
                c[key] = 0

    def launched(path):
        got = {**LK.LAUNCHES, **SK.LAUNCHES}
        for name in PATH_KERNELS[path]:
            check(got[name] > 0, f"kernel {name} was not launched on the {path} main path")
        if not PATH_KERNELS[path]:
            check(not any(got.values()), f"the {path} path launched kernels: {got}")
        for name, n in got.items():
            launches[name] += n
        report[path]["launches"] = got
        return got

    cells_rep = report["index_cells"] = {}
    for cell in CELLS:
        reset()
        report[cell] = {}
        t0 = time.perf_counter()
        p50, ins_rate, del_rate = main_path(torch, np, args.seed, report[cell], cell=cell,
                                            index_cells=cells_rep if cell == "fp32" else None)
        report[cell]["seconds"] = time.perf_counter() - t0
        got = launched(cell)
        log(f"[{cell}] search p50 ms at Q={SEARCH_Q}: {p50}; insert rows/s {ins_rate:.0f}; "
            f"delete rows/s {del_rate:.0f} ({card})")
        log(f"[{cell}] launches on the main path: {got}; {report[cell]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    reset()
    report["update"] = {}
    carry = {}
    t0 = time.perf_counter()
    drains, ms_round = update_path(torch, np, args.seed, report["update"], carry=carry)
    maintain_index_cell(torch, cells_rep, carry["idx"].state)
    report["update"]["seconds"] = time.perf_counter() - t0
    got = launched("update")
    log(f"[update] {drains['rounds']} drain rounds at {ms_round:.2f} ms; launches on the "
        f"main path: {got}, #1 in the drains {drains['l2_topk_launches']}; "
        f"{report['update']['seconds']:.1f} s ({card})")

    reset()
    report["serve"] = {}
    t0 = time.perf_counter()
    ids, rows = serve_path(torch, np, args.seed, report["serve"], carry)
    report["serve"]["seconds"] = time.perf_counter() - t0
    got = launched("serve")
    for phase in ("cooperative", "async_phase"):
        r = report["serve"][phase]["report"]
        m = r["maintenance"]
        log(f"[serve] {phase}: search ticket p50/p99 {r['search'].get('p50_ms')}/"
            f"{r['search'].get('p99_ms')} ms, insert ticket p50/p99 {r['insert'].get('p50_ms')}/"
            f"{r['insert'].get('p99_ms')} ms; maintenance slots {m['slots']} (idle "
            f"{m['idle_slots']}, deferred {m['deferred']}, forced {m['forced']}) in "
            f"{m['time_s']:.3f} s; insert_stall_s {r['insert_stall_s']:.3f}; queue padding "
            f"waste {r['queue']['padding_waste_frac']:.4f} ({card})")
    coop = report["serve"]["cooperative"]
    log(f"[serve] cooperative {coop['queries_per_s']:.0f} queries/s and "
        f"{coop['insert_rows_per_s']:.0f} insert rows/s; card busy "
        f"{report['serve']['async_phase']['device_busy_share']} of the async phase; launches "
        f"on the path: {got}; {report['serve']['seconds']:.1f} s ({card})")

    reset()
    report["grouped"] = {}
    t0 = time.perf_counter()
    grouped_path(torch, np, args.seed, report["grouped"], carry, ids, rows,
                 index_cells=cells_rep)
    report["grouped"]["seconds"] = time.perf_counter() - t0
    got = launched("grouped")
    log(f"[grouped] launches on the path: {got}; {report['grouped']['seconds']:.1f} s ({card})")
    del carry, ids, rows
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["durable"] = {}
    t0 = time.perf_counter()
    durable_path(torch, np, args.seed, report["durable"])
    report["durable"]["seconds"] = time.perf_counter() - t0
    got = launched("durable")
    dur = report["durable"]
    coop, rec = dur["cooperative"], dur["cooperative"]["recovery"]
    log(f"[durable] base {coop['base_bytes']} bytes in {coop['base_write_s']:.2f} s, delta "
        f"{coop['delta_bytes']} bytes in {coop['delta_write_s']:.2f} s (delta/full "
        f"{coop['delta_over_full']:.4f}); WAL tail {coop['wal_tail_records']} records, "
        f"{coop['wal_tail_bytes']} bytes, {coop['wal_fsyncs_per_dispatch']:.3f} fsyncs a "
        f"dispatch (async {dur['async_phase']['fsyncs_per_dispatch']:.3f}); recovery load "
        f"{rec['load_s']:.2f} s, upload {rec['upload_s']:.2f} s, replay {rec['replay_s']:.2f} s "
        f"({coop['replayed_records_per_s']} records/s); root on {dur['fs']} ({card})")
    log(f"[durable] launches on the path: {got}; {dur['seconds']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["sharded"] = {}
    t0 = time.perf_counter()
    sharded_path(torch, np, args.seed, report["sharded"])
    report["sharded"]["seconds"] = time.perf_counter() - t0
    got = launched("sharded")
    sh = report["sharded"]
    log(f"[sharded] {sh['shards']} shards x {sh['replicas']} copies, "
        f"{sh['state_bytes_total']} bytes of state; search p50 {sh['search_p50_ms']} ms; "
        f"{sh['cooperative']['ms_per_round']} ms a sharded round; recovery load "
        f"{sh['recovery']['load_s']:.2f} s, upload {sh['recovery']['upload_s']:.2f} s, replay "
        f"{sh['recovery']['replay_s']:.2f} s; launches on the path: {got}; "
        f"{sh['seconds']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["retrieval"] = {}
    t0 = time.perf_counter()
    retrieval_path(torch, np, args.seed, report["retrieval"], index_cells=cells_rep)
    report["retrieval"]["seconds"] = time.perf_counter() - t0
    got = launched("retrieval")
    rt = report["retrieval"]
    fc = rt["floor_corpus"]
    log(f"[retrieval] ANN p50 {rt['ann_p50_ms']} ms, brute force p50 {rt['bruteforce_p50_ms']} "
        f"ms, recall@10 {rt['recall_at_10']} (N={rt['n']}), {fc['recall_at_10']} (N={fc['n']}, "
        f"floor {fc['recall_floor']}); launches on the path: {got}; {rt['seconds']:.1f} s "
        f"({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["train"] = {}
    t0 = time.perf_counter()
    train_path(torch, np, args.seed, report["train"])
    report["train"]["seconds"] = time.perf_counter() - t0
    got = launched("train")
    tn = report["train"]
    log("[train] step p50 ms " + ", ".join(f"{a} {tn[a]['p50_ms']:.2f} (B={tn[a]['batch']}, "
                                           f"peak {tn[a]['peak_bytes']})" for a in TRAIN_ARCHS)
        + f"; launches on the path: {got}; {tn['seconds']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["lm"] = {}
    t0 = time.perf_counter()
    lm_path(torch, np, args.seed, report["lm"])
    report["lm"]["seconds"] = time.perf_counter() - t0
    got = launched("lm")
    lm, dense = report["lm"][LM_MOE], report["lm"][LM_DENSE]
    log(f"[lm] {LM_MOE}: prefill {lm['prefill']['ms']:.1f} ms ({lm['prefill']['tokens_per_s']:.0f} "
        f"tokens/s), decode {lm['decode']['ms_per_step']:.2f} ms a step "
        f"({lm['decode']['tokens_per_s']:.0f} tokens/s), peak {lm['peak_bytes']}; {LM_DENSE}: "
        f"decode against prefill {dense['decode_vs_prefill_rel_err']:.3e}, peak "
        f"{dense['peak_bytes']}; launches on the path: {got}; {report['lm']['seconds']:.1f} s "
        f"({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["gnn"] = {}
    t0 = time.perf_counter()
    gnn_path(torch, np, args.seed, report["gnn"])
    report["gnn"]["seconds"] = time.perf_counter() - t0
    got = launched("gnn")
    gn = report["gnn"]
    log("[gnn] step p50 ms " + ", ".join(f"{s} {gn[s]['p50_ms']:.2f} (peak {gn[s]['peak_bytes']})"
                                         for s in GNN_ORDER)
        + f"; launches on the path: {got}; {gn['seconds']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    reset()
    report["lm_train"] = {}
    t0 = time.perf_counter()
    lm_train_path(torch, np, args.seed, report["lm_train"])
    report["lm_train"]["seconds"] = time.perf_counter() - t0
    got = launched("lm_train")
    lt = report["lm_train"]
    log(f"[lm_train] {LM_MOE} train_4k: step p50 {lt['train_4k']['p50_ms']:.1f} ms "
        f"({lt['train_4k']['tokens_per_s']:.0f} tokens/s), peak {lt['train_4k']['peak_bytes']}; "
        f"remat peak {lt['remat']['remat_on']['peak_bytes']} against "
        f"{lt['remat']['remat_off']['peak_bytes']}; launches on the path: {got}; "
        f"{lt['seconds']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    records = index_cells_records(torch, cells_rep)
    done = {shape for _, shape in INDEX_CELLS}
    check(done <= set(cells_rep), f"index cells not run: {sorted(done - set(cells_rep))}")
    cells_rep["records_s"] = time.perf_counter() - t0
    cells_rep["seconds"] = cells_rep["records_s"] + sum(cells_rep[c]["seconds"] for c in done)
    log(f"[index cells] six cells held bit for bit; serve_search_paged launched "
        f"{cells_rep['serve_search_paged']['launches']}; the checks and records took "
        f"{cells_rep['seconds']:.1f} s ({card})")
    print("dryrun: " + json.dumps(records))
    for name, n in launches.items():
        if name.endswith("_pairs"):            # #6 and #7's pairs form
            results[name.removesuffix("_pairs")]["pairs_launches"] = n
        else:
            results[name]["launches"] = n
    for name in ("scan_batched_topk", "scan_batched_topk_q8"):
        report[f"{name}_pairs"] = results[name]["pairs"]
    for name in ("l2_topk_tiles", "scan_batched", "scan_batched_topk", "scan_batched_topk_q8"):
        report[f"{name}_tensor_core_bound_ms"] = results[name]["tensor_core_bound_ms"]
    for name in ("scan_batched", "scan_per_query_topk", "scan_per_query_topk_q8",
                 "scan_batched_topk", "scan_batched_topk_q8"):
        report[f"{name}_main_mix"] = results[name]["main_mix"]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("tensor_core_bound_ms", "f32_bound_ms", "store_floor_ms", "per_probe_bound_ms",
             "main_mix", "d256", "pairs", "pairs_launches")  # where a kernel has them
    kernels = [{**{k: results[n][k] for k in keys},
                **{k: results[n][k] for k in extra if k in results[n]}} for n in KERNEL_ORDER]
    report["smoke_s"] = time.perf_counter() - t_start
    log(f"smoke: {report['smoke_s']:.1f} s from start to the report, the kernels' build "
        f"included ({card})")
    print("report: " + json.dumps(report, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
