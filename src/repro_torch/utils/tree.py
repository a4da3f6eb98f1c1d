"""State container: frozen dataclasses of tensors with a ``replace`` method.

The JAX package registers its state classes as pytrees; here a state is a
plain frozen dataclass whose tensor fields are the leaves.  Non-tensor
fields (a config, a block size, a codec name) are static data carried
along unchanged.  State transitions return new objects via ``replace``;
the tensors of the old object are never written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch

_T = TypeVar("_T")


def state_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: make ``cls`` a frozen dataclass with ``replace(**updates)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def is_state(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def tensor_leaves(obj: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{"pool.blocks": tensor, ...}`` for every tensor leaf, in field order.

    ``None`` leaves (an absent cold tier) are skipped."""
    out: dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = f"{prefix}{f.name}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif is_state(v):
            out.update(tensor_leaves(v, name + "."))
    return out


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj: _T) -> _T:
    """A copy of ``obj`` with ``fn`` applied to every tensor leaf."""
    updates = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            updates[f.name] = fn(v)
        elif is_state(v):
            updates[f.name] = map_tensors(fn, v)
    return dataclasses.replace(obj, **updates)


def clone_state(obj: _T) -> _T:
    """Deep copy of every tensor leaf (an independent state)."""
    return map_tensors(torch.clone, obj)
