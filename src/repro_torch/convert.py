"""Carry index state between the JAX package and the port.

Both packages hold the same leaves under the same names.  The exchange
format is a flat ``{"pool.blocks": ndarray, "centroids": ndarray, ...}``
map of numpy arrays, named by attribute path; ``rng`` is the reference's
raw ``(2,)`` uint32 PRNG key.  bfloat16 leaves travel as their uint16 bit
patterns (numpy has no bfloat16 of its own).

A sharded index is the reference's ONE stacked state (every leaf with a
leading ``(n_shards,)`` axis) and the port's list of per-shard states:
:func:`sharded_state_from_numpy` and :func:`sharded_state_to_numpy` carry
it across in both directions.

The recsys and LM models' params travel as the reference's nested tree
of numpy arrays (``twotower_params_{from,to}_numpy``, the DeepFM, BERT4Rec
and MIND pairs, ``lm_params_{from,to}_numpy``, ``gnn_params_{from,to}_numpy``),
and AdamW's state as the
reference's ``{"count", "m", "v"}`` (:func:`adamw_state_from_numpy`,
:func:`adamw_state_to_numpy`).

A parameter tree is flattened in the reference's leaf order, which is
``jax.tree_util``'s: dict keys sorted, lists in order
(:func:`param_leaves`, :func:`tree_paths`, :func:`tree_from_paths`).  An
``nn.Linear``'s weight is the transpose of the reference's ``w`` and its
leaf is marked so; its ``weight`` and ``bias`` take the reference's names
``w`` and ``b``.  A training checkpoint stores ``(params, opt_state)``
as the reference's store does (:func:`train_state_leaves`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import IndexState, LireConfig, make_empty_state, resolve_device
from repro_torch.utils.tree import tensor_leaves


def _to_tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    arr = np.array(arr, order="C")        # a copy; keeps 0-d leaves 0-d
    if like.dtype == torch.bfloat16:
        # the uint16 bit pattern, or the 2-byte void np.save writes
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if arr.dtype.name == "bfloat16":
        raise TypeError("bfloat16 leaf given for a non-bfloat16 tensor")
    return torch.from_numpy(arr).to(device=device, dtype=like.dtype)


def fill_state(template, leaves: dict, *, device):
    """A copy of ``template`` whose tensor leaves are ``leaves``'s arrays
    on ``device``.  ``template`` gives only names, shapes and dtypes, so it
    may live on the meta device: no state is allocated besides the one
    filled.  Every tensor leaf must be present with the template's shape."""
    dev = torch.device(device)
    want = tensor_leaves(template)
    missing = sorted(set(want) - set(leaves))
    if missing:
        raise KeyError(f"leaves missing from the exchange map: {missing}")
    got = {}
    for name, like in want.items():
        arr = np.asarray(leaves[name])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(like.shape)}")
        got[name] = _to_tensor(arr, like, dev)
    return _rebuild(template, got)


def state_from_numpy(cfg: LireConfig, leaves: dict, *, device="cuda") -> IndexState:
    """The port's ``IndexState`` holding ``leaves`` on ``device``.

    Every tensor leaf of the port's state must be present with the same
    shape; dtypes are the port's own (which are the reference's)."""
    dev = resolve_device(device)
    return fill_state(make_empty_state(cfg, device="meta"), leaves, device=dev)


def sharded_state_from_numpy(cfg: LireConfig, leaves: dict, n_shards: int, *,
                             device="cuda") -> list[IndexState]:
    """The port's per-shard states from the reference's stacked leaves
    (each ``(n_shards, ...)``, the layout of ``stack_states``): shard ``s``
    holds every leaf's ``[s]`` slice on ``device``."""
    dev = resolve_device(device)
    template = make_empty_state(cfg, device="meta")
    for name, arr in leaves.items():
        if np.shape(arr)[:1] != (n_shards,):
            raise ValueError(f"{name}: leading axis {np.shape(arr)[:1]} != ({n_shards},)")
    return [fill_state(template, {name: np.asarray(arr)[s] for name, arr in leaves.items()},
                       device=dev)
            for s in range(n_shards)]


def sharded_state_to_numpy(states: list[IndexState]) -> dict[str, np.ndarray]:
    """Inverse of :func:`sharded_state_from_numpy`: each leaf stacked over
    the shards on the host (the reference's ``stack_states`` layout)."""
    per = [state_to_numpy(st) for st in states]
    return {name: np.stack([p[name] for p in per]) for name in per[0]}


def _rebuild(template, got: dict, prefix: str = ""):
    updates = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        name = f"{prefix}{f.name}"
        if isinstance(v, torch.Tensor):
            updates[f.name] = got[name]
        elif dataclasses.is_dataclass(v):
            updates[f.name] = _rebuild(v, got, name + ".")
    return dataclasses.replace(template, **updates)


def state_to_numpy(state: IndexState) -> dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy` (bfloat16 → uint16 bits)."""
    return {name: _host(t) for name, t in tensor_leaves(state).items()}


_GROUP_LEAVES = ("group_centroids", "group_sqn", "members", "member_valid")


def group_index_from_numpy(leaves: dict, *, device="cuda"):
    """The port's ``GroupIndex`` holding the reference's group index leaves
    (``{"group_centroids": ..., "members": ..., ...}``) on ``device``."""
    from repro_torch.core.grouping import GroupIndex

    dev = resolve_device(device)
    return GroupIndex(**{name: torch.from_numpy(np.array(leaves[name], order="C")).to(dev)
                         for name in _GROUP_LEAVES})


def group_index_to_numpy(gidx) -> dict[str, np.ndarray]:
    """Inverse of :func:`group_index_from_numpy`."""
    return {name: getattr(gidx, name).detach().cpu().numpy() for name in _GROUP_LEAVES}


def twotower_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``TwoTower`` holding the reference's two-tower params
    ``tree`` (``{"user_embed", "item_embed", "user_mlp": [{"w", "b"}, ...],
    "item_mlp": [...]}`` as numpy arrays, bfloat16 as uint16 bits or numpy's
    bfloat16) on ``device``, each ``w (in, out)`` held as ``nn.Linear``'s
    ``(out, in)``.  Leaves must be in ``cfg.dtype``."""
    from repro_torch.models.recsys import TwoTower, _linear, torch_dtype

    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def mlp(layers):
        return torch.nn.ModuleList(_linear(_leaf_tensor(lp["w"], dt, dev).T.contiguous(),
                                           _leaf_tensor(lp["b"], dt, dev)) for lp in layers)

    return TwoTower(cfg, _leaf_tensor(tree["user_embed"], dt, dev),
                    _leaf_tensor(tree["item_embed"], dt, dev),
                    mlp(tree["user_mlp"]), mlp(tree["item_mlp"]))


# ---------------------------------------------------------------------------
# Parameter trees in the reference's leaf order
# ---------------------------------------------------------------------------

def _key(part: str):
    return int(part) if part.isdigit() else part


def tree_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``[(path, leaf)]`` of a tree of dicts, lists and tuples in
    ``jax.tree_util``'s order: a dict's keys sorted, a list's items in
    order.  A ``None`` leaf is dropped, as JAX drops it."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [e for i, x in enumerate(tree) for e in tree_paths(x, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def tree_from_paths(items) -> dict:
    """Inverse of :func:`tree_paths` over dicts and lists: a level whose
    keys are ints is a list."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def param_leaves(params) -> list[tuple[tuple, torch.Tensor, bool]]:
    """``[(path, tensor, transposed)]`` for every parameter of ``params``
    (an ``nn.Module`` or a tree of tensors) in the reference's leaf order.
    ``transposed`` marks an ``nn.Linear`` weight, which the reference holds
    as ``w (in, out)``."""
    if not isinstance(params, nn.Module):
        return [(path, t, False) for path, t in tree_paths(params)]
    out = []
    for mname, mod in params.named_modules():
        lin = isinstance(mod, nn.Linear)
        for pname, p in mod.named_parameters(recurse=False):
            path = tuple(_key(x) for x in mname.split(".") if mname)
            out.append((path + ({"weight": "w", "bias": "b"}[pname] if lin else pname,),
                        p, lin and pname == "weight"))
    return sorted(out, key=lambda e: e[0])


def _host(t: torch.Tensor, transposed: bool = False) -> np.ndarray:
    """A leaf in the reference's layout on the host, bfloat16 as uint16
    bits: a copy, never a view of ``t``'s memory (which a later in-place
    step would change under the caller)."""
    t = t.detach()
    t = t.T if transposed else t
    if t.device.type == "cpu":
        t = t.clone(memory_format=torch.contiguous_format)
    else:
        t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(params) -> dict:
    """The reference's parameter tree of ``params`` (any recsys model or a
    tree of tensors) on the host: each ``w`` ``(in, out)``, bfloat16 as
    uint16 bits."""
    return tree_from_paths((path, _host(t, tr)) for path, t, tr in param_leaves(params))


def _leaf_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """``arr`` as a ``dtype`` tensor on ``device``, refusing a leaf of
    another dtype (bfloat16 given as uint16 bits or numpy's bfloat16)."""
    arr = np.asarray(arr)
    like = torch.empty((), dtype=dtype)
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"a {arr.dtype} leaf for a bfloat16 tensor")
    elif arr.dtype != np.dtype(str(dtype).removeprefix("torch.")):
        raise TypeError(f"a {arr.dtype} leaf for a {dtype} tensor")
    return _to_tensor(arr, like, device)


def _tensor_tree(tree, dtype: torch.dtype, device):
    return tree_from_paths((path, _leaf_tensor(a, dtype, device)) for path, a in tree_paths(tree))


def deepfm_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``DeepFM`` holding the reference's DeepFM params ``tree``
    (numpy, in ``cfg.dtype``) on ``device``."""
    from repro_torch.models.recsys import DeepFM, torch_dtype

    return DeepFM(cfg, _tensor_tree(tree, torch_dtype(cfg.dtype), resolve_device(device)))


def bert4rec_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``Bert4Rec`` holding the reference's BERT4Rec params."""
    from repro_torch.models.recsys import Bert4Rec, torch_dtype

    return Bert4Rec(cfg, _tensor_tree(tree, torch_dtype(cfg.dtype), resolve_device(device)))


def mind_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``MIND`` holding the reference's MIND params
    (``routing_init`` is f32 in every dtype, as there)."""
    from repro_torch.models.recsys import MIND, torch_dtype

    dev = resolve_device(device)
    t = _tensor_tree({k: v for k, v in tree.items() if k != "routing_init"},
                     torch_dtype(cfg.dtype), dev)
    t["routing_init"] = _leaf_tensor(tree["routing_init"], torch.float32, dev)
    return MIND(cfg, t)


def lm_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``LM`` holding the reference's LM params ``tree`` (numpy,
    ``layers`` stacked ``(L, …)``, in ``cfg.dtype``; a MoE router f32 in
    every dtype, as there) on ``device``."""
    from repro_torch.models.recsys import torch_dtype
    from repro_torch.models.transformer import LM

    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return LM(cfg, tree_from_paths(
        (path, _leaf_tensor(a, torch.float32 if path[-2:] == ("moe", "router") else dt, dev))
        for path, a in tree_paths(tree)))


def gnn_params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The port's ``GAT`` holding the reference's GAT params ``tree``
    (``{"layers": [{"w", "a_src", "a_dst"}, …], "head"?}``, numpy, in
    ``cfg.dtype``) on ``device``."""
    from repro_torch.models.gnn import GAT
    from repro_torch.models.recsys import torch_dtype

    return GAT(cfg, _tensor_tree(tree, torch_dtype(cfg.dtype), resolve_device(device)))


# the inverse of each ``*_params_from_numpy``
twotower_params_to_numpy = params_to_numpy
deepfm_params_to_numpy = bert4rec_params_to_numpy = mind_params_to_numpy = params_to_numpy
lm_params_to_numpy = gnn_params_to_numpy = params_to_numpy


# ---------------------------------------------------------------------------
# AdamW's state and training checkpoints
# ---------------------------------------------------------------------------

def adamw_state_to_numpy(opt_state: dict, params) -> dict:
    """The reference's ``{"count", "m", "v"}`` of the port's AdamW state
    (``m`` and ``v`` lists in ``params``' leaf order), each moment a tree
    shaped like the reference's params."""
    leaves = param_leaves(params)

    def tree(ms):
        return tree_from_paths((path, _host(m, tr)) for (path, _, tr), m in zip(leaves, ms))

    return {"count": _host(opt_state["count"]), "m": tree(opt_state["m"]),
            "v": tree(opt_state["v"])}


def adamw_state_from_numpy(tree: dict, params, *, device="cuda") -> dict:
    """Inverse of :func:`adamw_state_to_numpy`: the port's AdamW state for
    ``params`` on ``device``."""
    dev = resolve_device(device)
    leaves = param_leaves(params)

    def moments(t):
        arrs = dict(tree_paths(t))
        return [_oriented(_leaf_tensor(arrs[path], torch.float32, dev), tr, p.shape)
                for path, p, tr in leaves]

    return {"count": _leaf_tensor(tree["count"], torch.int32, dev),
            "m": moments(tree["m"]), "v": moments(tree["v"])}


def _oriented(t: torch.Tensor, transposed: bool, shape) -> torch.Tensor:
    """A leaf in the reference's layout turned into the port's."""
    t = t.T.contiguous() if transposed else t
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"a leaf of shape {tuple(t.shape)} for a tensor of {tuple(shape)}")
    return t


def train_state_leaves(params, opt_state: dict) -> list[tuple[torch.Tensor, bool]]:
    """``[(tensor, transposed)]`` of ``(params, opt_state)`` in the order
    the reference's ``CheckpointStore`` stores the pair: the parameters,
    then ``count``, then ``m`` and ``v`` in the parameters' order."""
    leaves = param_leaves(params)
    flags = [tr for _, _, tr in leaves]
    return ([(t, tr) for _, t, tr in leaves] + [(opt_state["count"], False)]
            + list(zip(opt_state["m"], flags)) + list(zip(opt_state["v"], flags)))


@torch.no_grad()
def fill_train_state_(params, opt_state: dict, arrays: list) -> None:
    """Copy ``arrays`` (numpy, in :func:`train_state_leaves` order and the
    reference's layout) into ``(params, opt_state)``'s tensors in place."""
    leaves = train_state_leaves(params, opt_state)
    if len(arrays) != len(leaves):
        raise ValueError(f"{len(arrays)} leaves for a state of {len(leaves)}")
    for (t, tr), arr in zip(leaves, arrays):
        t.copy_(_oriented(_to_tensor(np.asarray(arr), t, t.device), tr, t.shape))
