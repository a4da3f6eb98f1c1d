"""Dry run: count every (architecture × input shape × mesh) cell on the
``meta`` device and record memory, cost and a roofline, as the
reference's dry run records what XLA's compiler reports for its TPU
meshes.  Nothing is allocated and no card is needed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm \\
        --shape serve_p99 --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --driver --mesh all
        (driver: one subprocess per cell over the meshes it lacks; resumable)
    PYTHONPATH=src python -m repro_torch.launch.roofline_report

Meshes (``launch/mesh.py``): ``single`` (16×16 = 256 chips), ``multi``
(2×16×16 = 512) and ``card`` (one H100); ``--mesh`` takes one, a
comma-separated list or ``all``, and the meshes of one cell share one run
of its step (the count does not depend on the mesh).  Each (cell, mesh)
writes one JSON
under ``--out`` (default ``build/dryrun_torch``) with the reference's
record keys wherever the port has an analogue:

* ``status`` (``ok``, ``skipped`` with the reference's ``skip_reason``,
  ``error``, ``timeout``);
* ``memory_analysis``: ``argument_bytes`` a device — the params, the AdamW
  state, the batch and the cache as ``meta`` tensors, each leaf's bytes
  divided by the mesh sizes of the axes its spec names (nothing is divided
  on ``card``); ``output_bytes``, the step's new outputs (those that are
  not its inputs, written in place), under ``out_shardings`` where the
  cell has them; ``temp_bytes`` ``None``: no compiler plans the
  temporaries.  ``bytes_per_device`` is the argument bytes, and
  ``fits_80gb`` holds them against 80e9: a lower bound, temporaries
  uncounted;
* ``cost_analysis``: ``flops`` — ``FlopCounterMode`` over the cell's step
  on ``meta`` (matmuls, convolutions, attention) plus the hand-written
  kernels' own work (``kernels/work.py``) — and ``bytes_accessed`` — every
  op's tensor input and output bytes summed by a ``TorchDispatchMode``
  over the same run, views and metadata-only ops skipped, plus the
  kernels' bytes: the analogue of XLA's "bytes accessed".  Both are a
  device's: a cell with a per-device program (``make_mesh_step``: the
  index, one shard a device) counts that program; any other counts the
  whole step and splits it evenly over the mesh's devices (no partitioner
  says otherwise: redundant work and collectives are not counted);
* ``roofline`` (``launch/roofline.py``), ``model_flops_global`` and
  ``model_to_hlo_flops`` (the model FLOPs over the counted FLOPs of the
  mesh) for the LM cells;
* ``card_run``: where the card runs the cell today, ``published shape``,
  ``cut: <which>`` (``PERF.md`` §4) or ``none``, with the measured peak
  beside the cells whose peak ``PERF.md`` §5 gives.

The reference counts a ``lax.scan`` body once and corrects its LM counts
from two unrolled probes (L=2, L=4); the port has no layer scan and counts
every layer, so no LM record carries a correction.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

DEFAULT_OUT = os.path.join("build", "dryrun_torch")
CARD_BYTES = 80e9

# Where the card runs each cell today (chip_smoke.py's paths; PERF.md §4);
# a cell absent here runs on no card path.
CARD_RUN = {
    ("granite-moe-1b-a400m", "train_4k"): "cut: batch 8 of 256 (lm_train)",
    ("granite-moe-1b-a400m", "prefill_32k"): "cut: batch 2 of 32 (lm)",
    ("granite-moe-1b-a400m", "decode_32k"): "cut: batch 32 of 128 (lm)",
    ("deepseek-7b", "prefill_32k"): "cut: batch 2 x 1,024 tokens of 32 x 32,768 (lm)",
    ("deepseek-7b", "decode_32k"): "cut: one step at batch 2 on a 1,024-token cache of "
                                   "128 on 32,768 (lm)",
    ("gat-cora", "full_graph_sm"): "published shape (gnn)",
    ("gat-cora", "minibatch_lg"): "published shape (gnn)",
    ("gat-cora", "ogb_products"): "published shape (gnn)",
    ("gat-cora", "molecule"): "published shape (gnn)",
    ("two-tower-retrieval", "retrieval_cand_ann"): "cut: one shard holding 262,144 items, at "
                                                   "8x ann_index_cfg()'s capacities (retrieval)",
    ("two-tower-retrieval", "train_batch"): "cut: batch 32,768 of 65,536 (train)",
    ("two-tower-retrieval", "retrieval_cand"): "cut: brute force over 262,144 candidates of "
                                               "1,000,000 (retrieval)",
    ("deepfm", "train_batch"): "published shape (train)",
    ("bert4rec", "train_batch"): "cut: batch 512 of 65,536 (train)",
    ("mind", "train_batch"): "cut: batch 32,768 of 65,536 (train)",
    ("spfresh-1b", "serve_search"): "cut: one shard, 500,000 vectors of ~2M, on the fp32 "
                                    "path's CONFIG_PAGED state (index cells)",
    ("spfresh-1b", "serve_search_paged"): "cut: one shard, 500,000 vectors of ~2M (index cells)",
    ("spfresh-1b", "serve_search_grouped"): "cut: one shard, 250,000 vectors of ~2M "
                                            "(index cells)",
    ("spfresh-1b", "serve_update"): "cut: one shard, 500,000 vectors of ~2M (index cells)",
    ("spfresh-1b", "maintain"): "cut: one shard, 250,000 vectors of ~2M (index cells)",
}

# The peaks chip_smoke.py measured on an NVIDIA H100 80GB HBM3
# (max_memory_allocated; PERF.md section 5).
CARD_PEAK = {
    ("granite-moe-1b-a400m", "train_4k"): "48.53 GB at batch 8 (lm_train)",
    ("granite-moe-1b-a400m", "decode_32k"): "67.2 GB at batch 32 (lm)",
    ("gat-cora", "ogb_products"): "52.7 GB (gnn)",
}

# ops that move no bytes: allocation, aliasing and shape metadata
_NO_TRAFFIC = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "resize_", "set_", "_has_compatible_shallow_copy_type",
})

_META_LIB = None


def _register_meta_rules() -> None:
    """A ``meta`` rule for ``bincount``, which has none: ``minlength``
    counts, as the GNN's edge index asks for (every id is below its node
    count ``n = minlength``)."""
    global _META_LIB
    if _META_LIB is not None:
        return
    import torch

    def bincount(self, weights=None, minlength=0):
        dtype = torch.long if weights is None else torch.double
        return self.new_empty((minlength,), dtype=dtype)

    lib = torch.library.Library("aten", "IMPL")
    lib.impl("bincount", bincount, "Meta")
    _META_LIB = lib


def _cell_key(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}".replace("/", "_")


def list_cells():
    from repro_torch.configs import all_cells

    return [(c.arch, c.shape, c.family, c.kind, c.skip_reason) for c in all_cells()]


# ---------------------------------------------------------------------------
# Leaves, specs and bytes
# ---------------------------------------------------------------------------

def leaf_specs(arg, spec) -> list:
    """``[(tensor, spec)]`` of an argument and its specs in the same
    structure: a model's by its leaves' paths, a dict's by key, a list's by
    position, an index state's by leaf name.  A ``None`` spec replicates
    everything below it."""
    import torch
    from torch import nn

    from repro_torch.convert import param_leaves
    from repro_torch.utils.tree import tensor_leaves

    if arg is None:
        return []
    if isinstance(arg, torch.Tensor):
        return [(arg, spec)]
    if isinstance(arg, nn.Module):
        return [(t, None if spec is None else spec[path]) for path, t, _ in param_leaves(arg)]
    if isinstance(arg, dict):
        return [e for k, v in arg.items() for e in leaf_specs(v, None if spec is None else spec[k])]
    if isinstance(arg, (list, tuple)):
        return [e for i, v in enumerate(arg)
                for e in leaf_specs(v, None if spec is None else spec[i])]
    if dataclasses.is_dataclass(arg):
        return [(t, None if spec is None else spec[name])
                for name, t in tensor_leaves(arg).items()]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def device_bytes(pairs, mesh_shape: dict) -> int:
    """Bytes a device holds of ``[(tensor, spec)]``: each leaf's divided
    (rounded up) by the devices its spec splits it over."""
    from repro_torch.distributed.sharding import spec_divisor

    return sum(math.ceil(_nbytes(t) / spec_divisor(mesh_shape, s)) for t, s in pairs)


def _counting_modes():
    """A ``TorchDispatchMode`` summing every op's tensor input and output
    bytes (views and metadata-only ops skipped)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (func.is_view or func.overloadpacket.__name__ in _NO_TRAFFIC):
                self.ops += 1
                self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    return BytesMode()


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Count:
    """One run of a cell's step on ``meta``: its arguments and outputs, and
    what the three counters saw.  The same for every mesh, so one count
    serves the records of all three."""

    args: tuple
    out: object
    flops: float
    bytes: float
    ops: int
    kernel_work: object
    seconds: float


def count_step(step, args) -> Count:
    """Run ``step(*args)`` on ``meta`` under ``FlopCounterMode``, the bytes
    mode and the kernels' work count."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import work

    _register_meta_rules()
    t0 = time.time()
    bytes_mode = _counting_modes()
    with FlopCounterMode(display=False) as flop_mode, work.counting() as kw, bytes_mode:
        out = step(*args)
    return Count(args=args, out=out, flops=float(flop_mode.get_total_flops()),
                 bytes=float(bytes_mode.bytes), ops=bytes_mode.ops, kernel_work=kw,
                 seconds=round(time.time() - t0, 2))


def run_cell(arch: str, shape: str, mesh_kind: str, *, counts: dict | None = None) -> dict:
    """The record of one (cell, mesh).  ``counts`` (a dict the caller keeps)
    holds each cell's :class:`Count` across calls, so the meshes of one cell
    share one run of its step."""
    from repro_torch.configs import get_cell
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.launch.roofline import compute_dtype, model_flops, roofline_terms

    mesh = mesh_for(mesh_kind)
    multi_pod = mesh_kind == "multi"
    cell = get_cell(arch, shape)
    rec: dict = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "family": cell.family,
        "kind": cell.kind, "n_devices": mesh.size, "mesh_shape": mesh.shape,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "card_run": CARD_RUN.get((arch, shape), "none"),
    }
    if (arch, shape) in CARD_PEAK:
        rec["card_peak_measured"] = CARD_PEAK[(arch, shape)]
    if cell.skip_reason is not None:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip_reason
        return rec

    counts = {} if counts is None else counts
    c = counts.get((arch, shape))
    if cell.make_mesh_step is not None:
        step, args, specs = cell.make_mesh_step(mesh, multi_pod)
        out_specs, per_device = None, True
    else:
        step, specs = cell.step_fn, cell.in_shardings(multi_pod)
        args = c.args if c is not None else cell.input_specs()
        out_specs = cell.out_shardings(multi_pod) if cell.out_shardings else None
        per_device = False
    if c is None:
        c = counts[(arch, shape)] = count_step(step, args)
    args, kw = c.args, c.kernel_work
    rec["count_s"] = c.seconds
    each = [device_bytes(leaf_specs(a, s), mesh.shape) for a, s in zip(args, specs)]
    inputs = {id(t) for t, _ in leaf_specs(args, None)}
    out_pairs = [(t, s) for t, s in leaf_specs(c.out, out_specs) if id(t) not in inputs]
    split = 1 if per_device else mesh.size
    flops = (c.flops + kw.flops) / split
    bytes_accessed = (c.bytes + kw.bytes) / split
    arg_bytes = sum(each)
    rec["memory_analysis"] = {
        "argument_bytes": arg_bytes,
        "argument_bytes_each": each,
        "output_bytes": device_bytes(out_pairs, mesh.shape),
        "temp_bytes": None,
        "temp_bytes_reason": "no compiler plans the temporaries on the meta device",
    }
    rec["bytes_per_device"] = arg_bytes
    rec["fits_80gb"] = arg_bytes <= CARD_BYTES
    rec["fits_80gb_note"] = "argument bytes against 80e9: a lower bound, temporaries uncounted"
    rec["cost_analysis"] = {
        "flops": flops, "bytes_accessed": bytes_accessed,
        "flops_counted": c.flops, "bytes_counted": c.bytes, "ops_counted": c.ops,
        "kernel_work": kw.by_kernel,
        "per_device": ("the per-device program (one shard a device)" if per_device else
                       f"the whole step split evenly over {mesh.size} device(s)"),
        "bytes_accessed_is": "every op's tensor input and output bytes (views and "
                             "metadata-only ops skipped) plus the kernels' own bytes: the "
                             "analogue of XLA's 'bytes accessed'",
    }
    if mesh_kind == "card":
        coll, rec["collective_bytes"] = 0, {"total": 0, "reason": "one card: no collective"}
    else:
        coll, rec["collective_bytes"] = None, {
            "total": None, "reason": "no partitioning compiler to count the collectives"}
    rec["roofline"] = roofline_terms(flops_per_device=flops, bytes_per_device=bytes_accessed,
                                     collective_bytes_per_device=coll, dtype=compute_dtype(cell))
    mf = model_flops(cell)
    if mf is not None:
        rec["model_flops_global"] = mf
        counted = flops * mesh.size
        rec["model_to_hlo_flops"] = mf / counted if counted else None
        rec["analysis_correction"] = ("none: the port has no layer scan, so every layer is "
                                      "counted (the reference's L=2/L=4 probe corrects XLA's "
                                      "count of a scan body)")
    rec["status"] = "ok"
    return rec


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)


def _meshes(kind: str) -> list[str]:
    """``all``, or a comma-separated list of mesh kinds."""
    from repro_torch.launch.mesh import MESH_KINDS

    kinds = list(MESH_KINDS) if kind == "all" else kind.split(",")
    bad = [k for k in kinds if k not in MESH_KINDS]
    if bad:
        raise SystemExit(f"unknown mesh {bad}: one of {MESH_KINDS}, a list of them, or all")
    return kinds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run of every cell on the meta device")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="card",
                    help="single, multi, card, a comma-separated list of them, or all")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--driver", action="store_true",
                    help="subprocess per remaining cell and mesh (resumable)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, family, kind, skip in list_cells():
            flag = f"SKIP({skip})" if skip else ""
            print(f"{arch:28s} {shape:20s} {family:8s} {kind:8s} {flag}")
        return

    os.makedirs(args.out, exist_ok=True)
    if args.driver:
        # one subprocess a cell, over the meshes it still lacks
        todo = []
        for arch, shape, *_ in list_cells():
            left = [mk for mk in _meshes(args.mesh) if args.force or not os.path.exists(
                os.path.join(args.out, _cell_key(arch, shape, mk) + ".json"))]
            if left:
                todo.append((arch, shape, left))
        print(f"driver: {sum(len(m) for *_, m in todo)} records of {len(todo)} cells to make")
        for i, (arch, shape, left) in enumerate(todo):
            print(f"[{i + 1}/{len(todo)}] {arch}/{shape} mesh={','.join(left)}", flush=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", ",".join(left), "--out", args.out, "--force"]
            try:
                proc = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
                bad = None if proc.returncode == 0 else {"status": "error",
                                                         "stderr": proc.stderr[-4000:]}
            except subprocess.TimeoutExpired:
                bad = {"status": "timeout"}
            if bad is None:
                print("   ok")
                continue
            for mk in left:
                _write(os.path.join(args.out, _cell_key(arch, shape, mk) + ".json"),
                       {"arch": arch, "shape": shape, "mesh": mk, **bad})
            print(f"   {bad['status'].upper()} (recorded): {bad.get('stderr', '')[-400:]}")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --list, --driver)")
    counts: dict = {}
    for mk in _meshes(args.mesh):
        path = os.path.join(args.out, _cell_key(args.arch, args.shape, mk) + ".json")
        if os.path.exists(path) and not args.force:
            print(f"skip existing {path}")
            continue
        try:
            rec = run_cell(args.arch, args.shape, mk, counts=counts)
        except Exception:
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mk, "status": "error",
                   "traceback": traceback.format_exc()}
        _write(path, rec)
        print(f"{_cell_key(args.arch, args.shape, mk)}: {rec['status']}")
        if rec["status"] == "ok":
            r = rec["roofline"]
            coll = "n/a" if r["collective_s"] is None else f"{r['collective_s']:.3e}s"
            print(f"  compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"collective={coll} dominant={r['dominant']}")
        elif rec["status"] == "error":
            print(rec["traceback"][-2000:])
            sys.exit(1)


if __name__ == "__main__":
    main()
