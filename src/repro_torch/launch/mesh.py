"""Production mesh definitions, as data.

The JAX package's dry run compiles every cell on a TPU device mesh: 16 ×
16 = 256 chips a pod, 2 pods = 512 chips.  On one H100 there is no device
mesh to build; the dry run (``launch/dryrun.py``) counts on the ``meta``
device and needs only the mesh's shape and axis names, which this module
gives: ``single`` and ``multi`` as the reference's, and ``card``, the one
device the port runs on.  The reference's ``make_local_mesh`` (a small mesh
over the local devices, for its tests) has no use on one card and is not
here.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's ``kind``, axis names and sizes; no devices."""

    kind: str
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips/pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return Mesh("multi", ("pod", "data", "model"), (2, 16, 16))
    return Mesh("single", ("data", "model"), (16, 16))


def make_card_mesh() -> Mesh:
    """One card: the production axis names at size 1, so every spec rule
    applies and divides nothing."""
    return Mesh("card", ("data", "model"), (1, 1))


MESH_KINDS = ("single", "multi", "card")


def mesh_for(kind: str) -> Mesh:
    """The mesh of ``kind`` (one of :data:`MESH_KINDS`)."""
    if kind == "card":
        return make_card_mesh()
    if kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh kind {kind!r}: one of {MESH_KINDS}")
    return make_production_mesh(multi_pod=kind == "multi")
