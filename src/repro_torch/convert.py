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

The two-tower model's params travel as the reference's nested tree
(:func:`twotower_params_from_numpy`, :func:`twotower_params_to_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    out = {}
    for name, t in tensor_leaves(state).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[name] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[name] = t.numpy()
    return out


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
    like = torch.empty((), dtype=torch_dtype(cfg.dtype))

    def leaf(arr):
        arr = np.asarray(arr)
        if like.dtype == torch.float32 and arr.dtype != np.float32:
            raise TypeError(f"a {arr.dtype} leaf for a float32 config")
        if like.dtype == torch.bfloat16 and arr.dtype.itemsize != 2:
            raise TypeError(f"a {arr.dtype} leaf for a bfloat16 config")
        return _to_tensor(arr, like, dev)

    def mlp(layers):
        return torch.nn.ModuleList(_linear(leaf(lp["w"]).T.contiguous(), leaf(lp["b"]))
                                   for lp in layers)

    return TwoTower(cfg, leaf(tree["user_embed"]), leaf(tree["item_embed"]),
                    mlp(tree["user_mlp"]), mlp(tree["item_mlp"]))


def twotower_params_to_numpy(model) -> dict:
    """Inverse of :func:`twotower_params_from_numpy`: the reference's tree
    on the host (each ``w`` back to ``(in, out)``; bfloat16 → uint16 bits)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def mlp(layers):
        return [{"w": leaf(lin.weight.T.contiguous()), "b": leaf(lin.bias)} for lin in layers]

    return {"user_embed": leaf(model.user_embed), "item_embed": leaf(model.item_embed),
            "user_mlp": mlp(model.user_mlp), "item_mlp": mlp(model.item_mlp)}
