"""Where the shards and replicas of a sharded index live, and the spec
rules that place every model family's leaves on a device mesh.

The JAX package lays a replicated sharded service out on a 2-axis
``(data, model)`` mesh — the model axis shards postings, the data axis
holds ``n_replicas`` full copies — and splits it into one row submesh per
copy (row 0 the primary).  Here the layout is ``n_replicas`` rows of
``n_shards`` devices, row 0 the primary's (:func:`replica_layout`).  Every
shard of every copy lives on the one device given (the card, or the CPU
when the caller asks for it); placing the shards across several cards is
not done yet.

The spec rules are the reference's ``PartitionSpec`` rules
(``distributed/sharding.py``) as plain tuples: a spec holds one entry a
dimension, ``None`` (replicated), an axis name or a tuple of names; a spec
shorter than its leaf replicates the dimensions past its end, as a
``PartitionSpec`` does.  Axis semantics on the production mesh
(``launch/mesh.py``): ``pod`` the outer data-parallel axis (multi-pod
only), ``data`` the data-parallel / FSDP axis, ``model`` the tensor, expert,
vocab and index-shard axis.  Parameter specs are keyed by the paths of
``convert.param_leaves`` and given in the port's orientation: a rule sees
each leaf as the reference holds it, and the two entries of an
``nn.Linear`` weight (``(out, in)``, the reference's ``w`` transposed) are
then swapped.  The dry run (``launch/dryrun.py``) divides each leaf's
bytes by the mesh sizes of the axes its spec names.  The reference's
activation constraints (``act_constraint`` and its variants) are the
identity on one card and have no counterpart.
"""
from __future__ import annotations

import math

import torch

from repro_torch.convert import param_leaves
from repro_torch.core.types import resolve_device


def replica_layout(n_replicas: int, n_shards: int, device="cuda") -> list[list[torch.device]]:
    """``n_replicas`` rows of ``n_shards`` devices; row 0 is the primary's."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"need n_replicas, n_shards >= 1: {n_replicas}, {n_shards}")
    dev = resolve_device(device)
    return [[dev] * n_shards for _ in range(n_replicas)]


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def data_entry(multi_pod: bool):
    """The data axes as one spec entry: a single name stands alone, as a
    ``PartitionSpec`` normalises it."""
    da = data_axes(multi_pod)
    return da[0] if len(da) == 1 else da


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def _by_path(params, rule) -> dict[tuple, tuple]:
    """``{path: spec}`` for every leaf of ``params``: ``rule(shape)`` on the
    leaf in the reference's orientation, the entries of a transposed leaf
    swapped back."""
    out = {}
    for path, t, transposed in param_leaves(params):
        shape = tuple(t.shape)
        if transposed:
            out[path] = tuple(reversed(rule(shape[::-1])))
        else:
            out[path] = rule(shape)
    return out


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_param_specs(cfg, *, model_size: int = 16, multi_pod: bool = False) -> dict[tuple, tuple]:
    """``{path: spec}`` of ``transformer.init_params``' tree: FSDP over
    ``data`` on the d_model-ish dimension, ``model`` on heads, ffn, vocab
    and experts (KV heads and experts only where their width divides
    ``model_size``); the stacked layers' leading ``L`` replicated."""
    fs = data_axes(multi_pod)[-1]
    kv_model = "model" if (cfg.n_kv_heads * cfg.hd) % model_size == 0 else None
    layer = {
        ("ln1",): (None, None),
        ("ln2",): (None, None),
        ("wq",): (None, fs, "model"),
        ("wk",): (None, fs, kv_model),
        ("wv",): (None, fs, kv_model),
        ("wo",): (None, "model", fs),
    }
    if cfg.qkv_bias:
        layer.update({("bq",): (None, "model"), ("bk",): (None, kv_model),
                      ("bv",): (None, kv_model)})
    if cfg.moe:
        e_model = "model" if cfg.n_experts % model_size == 0 else None
        layer.update({("moe", "router"): (None, fs, None),
                      ("moe", "wi_gate"): (None, e_model, fs, None),
                      ("moe", "wi_up"): (None, e_model, fs, None),
                      ("moe", "wo"): (None, e_model, None, fs)})
    else:
        layer.update({("mlp", "wi_gate"): (None, fs, "model"),
                      ("mlp", "wi_up"): (None, fs, "model"),
                      ("mlp", "wo"): (None, "model", fs)})
    return {("embed",): ("model", fs), **{("layers", *p): s for p, s in layer.items()},
            ("final_norm",): (None,), ("lm_head",): (fs, "model")}


def lm_batch_specs(kind: str, *, multi_pod: bool = False) -> dict:
    da = data_entry(multi_pod)
    if kind == "train":
        return {"tokens": (da, None), "labels": (da, None)}
    if kind == "prefill":
        return {"tokens": (da, None)}
    if kind == "decode":
        return {"cache": {"k": (None, da, None, None, None), "v": (None, da, None, None, None)},
                "tokens": (da,), "pos": ()}
    raise ValueError(kind)


def lm_cache_specs(multi_pod: bool = False) -> dict:
    """``(L, B, S, KH, hd)``: the batch over the data axes and the
    sequence over ``model`` (KV-head counts of 1-8 do not divide its 16)."""
    da = data_entry(multi_pod)
    return {"k": (None, da, "model", None, None), "v": (None, da, "model", None, None)}


# ---------------------------------------------------------------------------
# GNN family — edge-parallel: edges sharded over every axis, nodes replicated
# ---------------------------------------------------------------------------

def gnn_param_specs(params) -> dict[tuple, tuple]:
    return {path: () for path, _, _ in param_leaves(params)}


def gnn_batch_specs(batch: dict, *, multi_pod: bool = False) -> dict:
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    specs = {}
    for k, v in batch.items():
        if k in ("edge_src", "edge_dst"):
            specs[k] = (axes,)
        elif k == "n_graphs":
            specs[k] = None
        else:
            specs[k] = _replicated(getattr(v, "ndim", 0))
    return specs


# ---------------------------------------------------------------------------
# Recsys family — tables row-sharded over model, batch over (pod, data)
# ---------------------------------------------------------------------------

def recsys_param_specs(params, *, model_size: int = 16,
                       multi_pod: bool = False) -> dict[tuple, tuple]:
    """A 2-D leaf of at least 2**16 rows that divide ``model_size`` is an
    embedding table, row-sharded over ``model``; a leaf of at least 2**22
    values whose first dimension (at least 256) divides ``model_size`` is
    FSDP over ``data`` on it (a tiny tower sharded over ``data`` forces the
    per-candidate activations through all-reduces); the rest replicated."""
    fs = data_axes(multi_pod)[-1]

    def rule(shape):
        if len(shape) == 2 and shape[0] >= (1 << 16) and shape[0] % model_size == 0:
            return ("model", None)
        if (len(shape) >= 1 and shape[0] % model_size == 0 and shape[0] >= 256
                and math.prod(shape) >= (1 << 22)):
            return (fs, *_replicated(len(shape) - 1))
        return _replicated(len(shape))

    return _by_path(params, rule)


def recsys_batch_specs(batch: dict, *, multi_pod: bool = False) -> dict:
    da = data_entry(multi_pod)
    da_size = 32 if multi_pod else 16
    specs = {}
    for k, v in batch.items():
        ndim = getattr(v, "ndim", 0)
        if k == "candidate_ids":
            # 1M candidates divide the 16-way model axis, not data × model
            specs[k] = ("model",)
        elif ndim == 0:
            specs[k] = ()
        elif v.shape[0] % da_size != 0:
            specs[k] = _replicated(ndim)      # retrieval_cand's batch of 1
        else:
            specs[k] = (da, *_replicated(ndim - 1))
    return specs


# ---------------------------------------------------------------------------
# Optimizer state: mirror the param specs
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs: dict[tuple, tuple]) -> dict:
    """The specs of ``optimizer.adamw_init``'s state: each moment list in
    the parameters' leaf order (their sorted paths), ``count`` replicated."""
    order = [param_specs[p] for p in sorted(param_specs)]
    return {"m": list(order), "v": list(order), "count": ()}


# ---------------------------------------------------------------------------
# Bytes a device holds under a spec
# ---------------------------------------------------------------------------

def axes_size(mesh_shape: dict[str, int], entry) -> int:
    """Devices one spec entry splits a dimension over."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh_shape[n] for n in names)


def spec_divisor(mesh_shape: dict[str, int], spec) -> int:
    """Devices a leaf under ``spec`` is split over (``None``: replicated)."""
    if spec is None:
        return 1
    return math.prod(axes_size(mesh_shape, e) for e in spec)
