"""The kernels' work and the card's peaks: the benchmark's own frozen
arithmetic, counted from the dispatched batches' real shapes and their
live pages (the program's ``kernels/work.py`` counts every page of a budget
as live).

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the fastest rate at which the card can do them at
the inputs' precision: the TF32 tensor cores for float32 inputs (#1, #6),
the int8 tensor cores for int8 codes (#7).  The count is of what the
inputs need, whatever implements the kernel: each input read once, the
``k`` nearest of each query written once.  So no implementation can take
less than the least time, and a share of it never passes 100%.

Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
700 W power limit; the card's limit is printed beside each run.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
INT8_OP_PER_S = 1979e12


def least_s(ops: float, nbytes: float, op_rate: float) -> float:
    return max(ops / op_rate, nbytes / HBM_BYTES_PER_S)


def l2_topk(q_n: int, p_live: int, d: int, k: int) -> tuple[float, float]:
    """#1, navigation: ``(operations, bytes)`` of ``q_n`` f32 queries
    against ``p_live`` live f32 centroids and their norms, the ``k`` nearest
    of each query (distance and id) written."""
    return 2.0 * q_n * p_live * d, 4.0 * (q_n * d + p_live * d + p_live) + 8.0 * q_n * k


def scan_batched(pages: int, q_n: int, bs: int, d: int, item: int, k: int,
                 q8: bool = False) -> tuple[float, float]:
    """#6 (``item`` bytes a stored value) and #7 (``q8``: int8 codes with a
    ``(scale, zero)`` pair a page): every one of ``pages`` live pages of
    ``bs`` slots against each of ``q_n`` f32 queries, each page and query
    read once, the ``k`` nearest of each query written."""
    ops = 2.0 * pages * q_n * bs * d
    nbytes = pages * bs * d * item + 4.0 * q_n * d + 8.0 * q_n * k
    if q8:
        nbytes += 8.0 * pages
    return ops, nbytes
