"""Cell registry, the LM, GNN and recsys parts: every (architecture × input
shape) combination becomes a ``Cell`` with a step function, its inputs'
shapes on the ``meta`` device, its spec rules on a mesh and smoke-scale
inputs — consumed by the smoke tests, the training launcher and the dry
run (``launch/dryrun.py``).

A ``Cell`` keeps the reference's field names.  ``input_specs()`` gives the
step's arguments as ``meta`` tensors (the reference's
``ShapeDtypeStruct``s): the parameters, the AdamW state, the batch, the
cache.  ``in_shardings(multi_pod)`` and ``out_shardings(multi_pod)`` give
their specs under ``distributed/sharding.py``'s rules, in the arguments'
structure: a model's specs keyed by its leaves' paths, the AdamW state's
as lists in the leaves' order.  A mesh-coupled cell (the index: one LIRE
shard a device) has ``make_mesh_step(mesh, multi_pod) -> (step, args,
specs)``: the program one device runs and its ``meta`` arguments, as the
reference's ``shard_map`` body sees them.  The reference's
``make_for_cfg`` serves its dry run's L=2 / L=4 correction for a
``lax.scan`` body that XLA counts once; the port has no layer scan and
counts every layer, so it has none.

``make_smoke_inputs(scfg, rng, device=...)`` makes the parameters from a
generator seeded 0 on ``device`` (the card unless the caller asks for the
CPU) and draws the batch from ``rng`` as the reference's batch maker
draws it: a seed gives both packages the same batch.  A train cell's
inputs are ``(params, opt_state, batch)``; its step updates the first two
in place and returns them with the metrics.  An LM prefill cell's inputs
are ``(params, tokens)``; a decode cell's ``(params, cache, tokens, pos)``,
its step writing the cache in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.distributed import sharding as shard_rules
from repro_torch.models import gnn
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import AdamWConfig, adamw_init, make_train_step

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    family: str
    kind: str                        # train | prefill | decode | serve
    model_cfg: Any
    step_fn: Callable                # fn(*inputs)
    input_specs: Callable[[], tuple] | None = None        # () -> meta args
    in_shardings: Callable[[bool], tuple] | None = None   # multi_pod -> specs
    make_smoke_inputs: Callable[..., tuple] | None = None
    smoke_cfg: Any = None
    skip_reason: str | None = None
    donate_argnums: tuple = ()
    out_shardings: Callable[[bool], tuple] | None = None  # multi_pod -> specs
    smoke_step_fn: Callable | None = None   # step built against smoke_cfg
    # mesh-coupled cells: (mesh, multi_pod) -> (step, meta args, specs)
    make_mesh_step: Callable | None = None

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


OPT = AdamWConfig()


def _sds(shape, dtype) -> torch.Tensor:
    """An input's shape and dtype, allocating nothing (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _ids(arr: np.ndarray, device) -> torch.Tensor:
    """A drawn id array as an int32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr, np.int32)).to(device)


# ===========================================================================
# LM family
# ===========================================================================

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

LM_SMOKE_SHAPES = {
    "train_4k": dict(kind="train", seq=32, batch=2),
    "prefill_32k": dict(kind="prefill", seq=64, batch=2),
    "decode_32k": dict(kind="decode", seq=64, batch=4),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}

LONG_500K_SKIP = ("pure full-attention arch: long_500k requires sub-quadratic "
                  "attention (assignment rule; see DESIGN.md §5)")


def lm_step(kind: str, cfg: tf.LMConfig):
    """The step of an LM cell of ``kind`` built for ``cfg`` (the reference
    builds the same for a variant config through ``make_for_cfg``)."""
    if kind == "train":
        return make_train_step(lambda p, b, _cfg=cfg: tf.loss_fn(p, b, _cfg), OPT)
    if kind == "prefill":
        return lambda params, tokens, _cfg=cfg: tf.prefill(params, tokens, _cfg)
    return lambda params, cache, tokens, pos, _cfg=cfg: tf.decode_step(params, cache, tokens,
                                                                       pos, _cfg)


def _lm_smoke_inputs(kind: str, ssh: dict):
    """The reference's smoke inputs of an LM cell: params from a generator
    seeded 0; tokens drawn from ``rng`` in ``[0, vocab)``; a decode cell's
    cache zeros at ``pos = seq // 2``."""
    def smoke_inputs(scfg, rng, *, device="cuda"):
        dev = resolve_device(device)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), scfg, device=dev)
        if kind == "decode":
            cache = tf.init_cache(scfg, ssh["batch"], ssh["seq"], device=dev)
            toks = _ids(rng.integers(0, scfg.vocab, size=(ssh["batch"],)), dev)
            return (params, cache, toks, torch.tensor(ssh["seq"] // 2, dtype=torch.int32,
                                                      device=dev))
        toks = _ids(rng.integers(0, scfg.vocab, size=(ssh["batch"], ssh["seq"])), dev)
        if kind == "train":
            return (params, adamw_init(params), {"tokens": toks, "labels": toks})
        return (params, toks)
    return smoke_inputs


def _lm_input_specs(kind: str, cfg: tf.LMConfig, sh: dict):
    """The step's arguments on ``meta``: ``(params, opt_state, batch)``,
    ``(params, tokens)`` or ``(params, cache, tokens, pos)``."""
    def specs():
        p = tf.param_specs(cfg)
        b, s = sh["batch"], sh["seq"]
        if kind == "train":
            return (p, adamw_init(p), {"tokens": _sds((b, s), I32), "labels": _sds((b, s), I32)})
        if kind == "prefill":
            return (p, _sds((b, s), I32))
        return (p, tf.init_cache(cfg, b, s, device="meta"), _sds((b,), I32), _sds((), I32))
    return specs


def _lm_shardings(kind: str, cfg: tf.LMConfig):
    def shardings(multi_pod):
        ps = shard_rules.lm_param_specs(cfg, multi_pod=multi_pod)
        da = shard_rules.data_entry(multi_pod)
        if kind == "train":
            return (ps, shard_rules.opt_state_specs(ps),
                    shard_rules.lm_batch_specs("train", multi_pod=multi_pod))
        if kind == "prefill":
            return (ps, (da, None))
        return (ps, shard_rules.lm_cache_specs(multi_pod), (da,), ())
    return shardings


def _lm_outs(multi_pod):
    """A prefill's or a decode's ``(logits (B, Vp), cache)``."""
    da = shard_rules.data_entry(multi_pod)
    return ((da, "model"), shard_rules.lm_cache_specs(multi_pod))


def lm_cells(arch: str, cfg: tf.LMConfig, smoke: tf.LMConfig) -> list[Cell]:
    cells = []
    for shape_name, sh in LM_SHAPES.items():
        kind = sh["kind"]
        cells.append(Cell(
            arch=arch, shape=shape_name, family="lm", kind=kind, model_cfg=cfg,
            smoke_cfg=smoke, step_fn=lm_step(kind, cfg),
            input_specs=_lm_input_specs(kind, cfg, sh), in_shardings=_lm_shardings(kind, cfg),
            make_smoke_inputs=_lm_smoke_inputs(kind, LM_SMOKE_SHAPES[shape_name]),
            skip_reason=LONG_500K_SKIP if shape_name == "long_500k" else None,
            donate_argnums={"train": (0, 1), "prefill": (), "decode": (1,)}[kind],
            out_shardings=None if kind == "train" else _lm_outs,
            smoke_step_fn=lm_step(kind, smoke),
        ))
    return cells


# ===========================================================================
# GNN family (gat-cora)
# ===========================================================================

GNN_SHAPES = {
    # shape -> (kind, n_nodes, n_edges, d_feat, n_classes, extras)
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
    "minibatch_lg": dict(
        n_nodes=1024 + 1024 * 15 + 1024 * 150,
        n_edges=1024 * 15 + 1024 * 150 * 10 // 10 * 10,  # 15360 + 153600
        d_feat=602, n_classes=41, n_targets=1024,
    ),
    "ogb_products": dict(
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47
    ),
    "molecule": dict(
        n_nodes=30 * 128, n_edges=64 * 128, d_feat=32, n_classes=2,
        n_graphs=128, readout="mean",
    ),
}

GNN_SMOKE_SHAPES = {
    "full_graph_sm": dict(n_nodes=64, n_edges=256, d_feat=24, n_classes=7),
    "minibatch_lg": dict(
        n_nodes=8 + 8 * 3 + 8 * 6, n_edges=8 * 3 + 8 * 6, d_feat=16,
        n_classes=5, n_targets=8,
    ),
    "ogb_products": dict(n_nodes=128, n_edges=512, d_feat=12, n_classes=7),
    "molecule": dict(
        n_nodes=5 * 8, n_edges=8 * 8, d_feat=8, n_classes=2, n_graphs=8,
        readout="mean",
    ),
}

# the sampler's fanouts for minibatch_lg: the cell's 15-10, and the smoke
# shape's (3, 6), chosen by the reference to reproduce its geometry
GNN_FANOUTS = (15, 10)
GNN_SMOKE_FANOUTS = (3, 6)


def gnn_cfg(base: gnn.GATConfig, sh: dict) -> gnn.GATConfig:
    """``base`` at a shape's dataset geometry: features, classes, readout."""
    return dataclasses.replace(base, d_in=sh["d_feat"], n_classes=sh["n_classes"],
                               readout=sh.get("readout", "none"),
                               n_graphs=sh.get("n_graphs", 0))


def gnn_graph_batch(raw: dict, device) -> dict:
    """A sampled subgraph (``data.graphs.sample_subgraph``'s arrays) as the
    GAT's batch on ``device``; ``node_ids`` stays behind."""
    return {"features": torch.as_tensor(raw["features"]).to(device),
            "edge_src": _ids(raw["edge_src"], device), "edge_dst": _ids(raw["edge_dst"], device),
            "labels": _ids(raw["labels"], device)}


def gnn_batch(shape_name: str, sh: dict, rng: np.random.Generator, *, device) -> dict:
    """A GNN cell's batch at shape ``sh``, drawn from ``rng`` as the
    reference's smoke inputs draw it.  ``minibatch_lg`` is the real fanout
    sampler: ``CSRGraph.random(max(64, n), avg_degree=8, seed=0)``,
    ``n_targets`` targets drawn from ``rng``, ``GNN_SMOKE_FANOUTS`` sampled
    from ``default_rng(1)``.  The others: normal features, uniform edges, and
    labels on every node (or one a graph, node ``i`` in graph
    ``i // (n / G)``)."""
    from repro_torch.data.graphs import CSRGraph, sample_subgraph

    n, e = sh["n_nodes"], sh["n_edges"]
    if shape_name == "minibatch_lg":
        g = CSRGraph.random(max(64, n), avg_degree=8, d_feat=sh["d_feat"],
                            n_classes=sh["n_classes"], seed=0)
        targets = rng.choice(g.n_nodes, size=sh["n_targets"], replace=False)
        raw = sample_subgraph(g, targets, GNN_SMOKE_FANOUTS, np.random.default_rng(1))
        return gnn_graph_batch(raw, device)
    b = {"features": torch.as_tensor(rng.normal(size=(n, sh["d_feat"])).astype(np.float32)
                                     ).to(device),
         "edge_src": _ids(rng.integers(0, n, size=e), device),
         "edge_dst": _ids(rng.integers(0, n, size=e), device)}
    if "n_graphs" in sh:
        g = sh["n_graphs"]
        b["graph_ids"] = _ids(np.repeat(np.arange(g), n // g), device)
        b["labels"] = _ids(rng.integers(0, sh["n_classes"], size=g), device)
    else:
        labels = rng.integers(0, sh["n_classes"], size=n).astype(np.int32)
        if "n_targets" in sh:
            labels[sh["n_targets"]:] = -1
        b["labels"] = _ids(labels, device)
    return b


def gnn_step(cfg: gnn.GATConfig):
    """The train step of a GNN cell built for ``cfg``."""
    return make_train_step(lambda p, b, _cfg=cfg: gnn.loss_fn(p, b, _cfg), OPT)


def gnn_batch_struct(sh: dict) -> dict:
    """A GNN cell's batch on ``meta``, the edge list padded to a multiple
    of 512 so that it shards over the full multi-pod mesh (padded edges
    carry ``-1`` ends and are ignored)."""
    n, e = sh["n_nodes"], ((sh["n_edges"] + 511) // 512) * 512
    b = {"features": _sds((n, sh["d_feat"]), F32), "edge_src": _sds((e,), I32),
         "edge_dst": _sds((e,), I32)}
    if "n_graphs" in sh:
        b["graph_ids"] = _sds((n,), I32)
        b["labels"] = _sds((sh["n_graphs"],), I32)
    else:
        b["labels"] = _sds((n,), I32)
    return b


def _gnn_input_specs(cfg: gnn.GATConfig, sh: dict):
    def specs():
        p = gnn.param_specs(cfg)
        return (p, adamw_init(p), gnn_batch_struct(sh))
    return specs


def _gnn_shardings(cfg: gnn.GATConfig, sh: dict):
    def shardings(multi_pod):
        ps = shard_rules.gnn_param_specs(gnn.param_specs(cfg))
        return (ps, shard_rules.opt_state_specs(ps),
                shard_rules.gnn_batch_specs(gnn_batch_struct(sh), multi_pod=multi_pod))
    return shardings


def gnn_cells(arch: str, base: gnn.GATConfig) -> list[Cell]:
    cells = []
    for shape_name, sh in GNN_SHAPES.items():
        ssh = GNN_SMOKE_SHAPES[shape_name]

        def smoke_inputs(scfg, rng, *, device="cuda", ssh=ssh, shape_name=shape_name):
            dev = resolve_device(device)
            params = gnn.init_params(torch.Generator(device=dev).manual_seed(0), scfg,
                                     device=dev)
            return (params, adamw_init(params), gnn_batch(shape_name, ssh, rng, device=dev))

        cfg, smoke = gnn_cfg(base, sh), gnn_cfg(base, ssh)
        cells.append(Cell(
            arch=arch, shape=shape_name, family="gnn", kind="train", model_cfg=cfg,
            smoke_cfg=smoke, step_fn=gnn_step(cfg), input_specs=_gnn_input_specs(cfg, sh),
            in_shardings=_gnn_shardings(cfg, sh), make_smoke_inputs=smoke_inputs,
            donate_argnums=(0, 1), smoke_step_fn=gnn_step(smoke),
        ))
    return cells


# ===========================================================================
# Recsys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_000),
}

RECSYS_SMOKE_SHAPES = {
    "train_batch": dict(kind="train", batch=32),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=64),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=256),
}


def _recsys_cell(
    arch: str,
    shape_name: str,
    cfg,
    smoke_cfg,
    kind: str,
    make_step,          # cfg -> step_fn
    init_fn,            # (gen, cfg, device=) -> params
    batch_struct_fn,    # (cfg, shape) -> batch on meta
    make_batch_fn,      # (cfg, shape, rng, device) -> batch
    donate=(),
) -> Cell:
    def params_meta():
        return init_fn(None, cfg, device="meta")

    def specs():
        p = params_meta()
        b = batch_struct_fn(cfg, RECSYS_SHAPES[shape_name])
        return (p, adamw_init(p), b) if kind == "train" else (p, b)

    def shardings(multi_pod):
        ps = shard_rules.recsys_param_specs(params_meta(), multi_pod=multi_pod)
        bs = shard_rules.recsys_batch_specs(batch_struct_fn(cfg, RECSYS_SHAPES[shape_name]),
                                            multi_pod=multi_pod)
        return (ps, shard_rules.opt_state_specs(ps), bs) if kind == "train" else (ps, bs)

    def smoke_inputs(scfg, rng, *, device="cuda"):
        dev = resolve_device(device)
        params = init_fn(torch.Generator(device=dev).manual_seed(0), scfg, device=dev)
        b = make_batch_fn(scfg, RECSYS_SMOKE_SHAPES[shape_name], rng, dev)
        if kind == "train":
            return (params, adamw_init(params), b)
        return (params, b)

    return Cell(
        arch=arch, shape=shape_name, family="recsys", kind=kind,
        model_cfg=cfg, smoke_cfg=smoke_cfg, step_fn=make_step(cfg), input_specs=specs,
        in_shardings=shardings, make_smoke_inputs=smoke_inputs, donate_argnums=donate,
        smoke_step_fn=make_step(smoke_cfg),
    )


def _serve_step(fn):
    """A serving step: ``fn(params, batch, cfg)`` with no graph."""
    def make_step(cfg):
        @torch.no_grad()
        def step(params, batch, _cfg=cfg):
            return fn(params, batch, _cfg)
        return step
    return make_step
