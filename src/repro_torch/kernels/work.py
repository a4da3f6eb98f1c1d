"""What a kernel launch does, counted from its shapes alone.

A kernel wrapper given tensors on the ``meta`` device launches nothing: it
returns outputs of the kernel's shapes and dtypes and adds the kernel's
own work to every count that :func:`counting` has opened.  That work is
the bound's (``chip_smoke.py``'s ``bound`` column of the kernel table):
each input read once, each output written once, and the products of the
distances.  ``meta`` carries no data, so a page that would be dead or
absent counts as live: a per-query scan reads every probe's page once, a
batched scan every row of its budget.  The plain versions' ``(Q, NB, BS)``
distance tensors, which a kernel never writes, are not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses

# the counts open now, innermost last
_OPEN: list["KernelWork"] = []


@dataclasses.dataclass
class KernelWork:
    """FLOPs and bytes of the kernel launches made on ``meta`` while it was
    open, in all and by kernel name."""

    flops: float = 0.0
    bytes: float = 0.0
    by_kernel: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        k = self.by_kernel.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


@contextlib.contextmanager
def counting():
    """Count the kernel work of the ``meta`` launches made inside."""
    work = KernelWork()
    _OPEN.append(work)
    try:
        yield work
    finally:
        _OPEN.remove(work)


def add(name: str, flops: float, nbytes: float) -> None:
    """Add one ``meta`` launch of kernel ``name`` to every open count."""
    for work in _OPEN:
        work.add(name, flops, nbytes)


def l2_topk_tiles(q_n: int, p_n: int, d: int, k: int, block_p: int) -> tuple[float, float]:
    """#1: ``(flops, bytes)``: the f32 queries, centroids and ``c_sqn`` read,
    ``(Q, T·k)`` distances and indices written; ``2·Q·P·d`` for the
    products."""
    t = p_n // block_p
    return 2.0 * q_n * p_n * d, 4.0 * (q_n * d + p_n * d + p_n) + 8.0 * q_n * t * k


def scan_per_query(q_n: int, nb: int, bs: int, d: int, item: int, *, k: int | None = None,
                   q8: bool = False) -> tuple[float, float]:
    """#2, #4, #5: every probe's page read once (``item`` bytes a value),
    the table, the queries and (with ``k``) the slot bias read, the
    distances (``k`` candidates, or every slot) written; with ``q8`` the
    ``(scale, zero)`` pairs read and each page dequantised."""
    pairs = q_n * nb
    flops = 2.0 * pairs * bs * d
    nbytes = pairs * bs * d * item + 4.0 * (pairs + q_n * d)
    if k is None:
        nbytes += 4.0 * pairs * bs
    else:
        nbytes += 4.0 * pairs * bs + 8.0 * pairs * k
    if q8:
        flops += 2.0 * pairs * bs * d
        nbytes += 8.0 * pairs
    return flops, nbytes


def scan_batched(nb: int, q_n: int, bs: int, d: int, item: int, *, k: int | None = None,
                 q8: bool = False, pairs: int | None = None) -> tuple[float, float]:
    """#3, #6, #7: each of the ``nb`` pages read once against every query,
    the ids, the queries and (with ``k``) the slot bias read, the distances
    written; with ``q8`` the per-page ``(scale, zero)`` read and each page
    dequantised once.  With ``pairs`` (#6, #7's pairs form) the int16
    ``(NB, Q)`` probe rows are read and ``pairs`` rows of ``k`` candidates
    written, not ``NB x Q``."""
    flops = 2.0 * nb * q_n * bs * d
    nbytes = nb * bs * d * item + 4.0 * (nb + q_n * d)
    if k is None:
        nbytes += 4.0 * nb * q_n * bs
    elif pairs is None:
        nbytes += 4.0 * nb * bs + 8.0 * nb * q_n * k
    else:
        nbytes += 4.0 * nb * bs + 2.0 * nb * q_n + 8.0 * pairs * k
    if q8:
        flops += 2.0 * nb * bs * d
        nbytes += 8.0 * nb
    return flops, nbytes
