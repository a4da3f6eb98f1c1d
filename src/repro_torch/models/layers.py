"""Layers shared by the models (the reference's ``models/layers.py``):
the initialisers, ``ParamTree`` (parameters under the reference's tree
names), the norms and the SwiGLU MLP.  Rotary embeddings, attention and
MoE wait for the LM models.

``dense_init`` and ``embed_init`` draw from an explicit ``torch.Generator``
on an explicit device, as the reference's draw from an explicit PRNG key:
one generator state gives one set of parameters.  ``counter_normal`` is a
draw that the CPU and the card give bit for bit: every value is a hash of
``(seed, stream, row, column)``, so any rows of a table can be made
anywhere, in any order, without the rest of it.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_M32 = 0xFFFFFFFF
# standard deviation of the sum of four uniform 16-bit integers
_SUM4_STD = math.sqrt((65536.0 ** 2 - 1.0) / 3.0)
_SUM4_MEAN = 2 * 65535
_ROWS_PER_CHUNK = 1 << 16


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *, device) -> torch.Tensor:
    """``(d_in, d_out)`` normal values of standard deviation
    ``1 / sqrt(d_in)``, drawn in f32, then cast to ``dtype``."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, *, device) -> torch.Tensor:
    """``(vocab, dim)`` normal values of standard deviation 0.02."""
    t = torch.randn((vocab, dim), generator=gen, device=device, dtype=torch.float32)
    return (t * 0.02).to(dtype)


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` and ``c`` in ``[0, 2^32)``,
    in 16-bit halves so that no product passes 2^48."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32, a bijection of the 32-bit integers (tensors or ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_normal(seed: int, stream: int, n_rows: int, dim: int, *, scale: float,
                   dtype, device) -> torch.Tensor:
    """The first ``n_rows`` rows of a ``(·, dim)`` table of approximately
    normal values of standard deviation ``scale``: each the sum of four
    uniform 16-bit integers of two hashes of its ``(seed, stream, row,
    column)``, centred, scaled in f32 and cast to ``dtype``.  Integer and
    correctly rounded float arithmetic only, so every device gives the same
    bits.  Made ``_ROWS_PER_CHUNK`` rows at a time."""
    if n_rows * dim > 1 << 32:
        raise ValueError(f"a counter table holds at most 2^32 values, not {n_rows} x {dim}")
    out = torch.empty((n_rows, dim), dtype=dtype, device=device)
    salt = _mix32((seed * 0x10001 + stream) & _M32)
    salt_a, salt_b = _mix32(salt ^ 0x68E31DA4), _mix32(salt ^ 0xB5297A4D)
    c = torch.tensor(scale / _SUM4_STD, dtype=torch.float32, device=device)
    cols = torch.arange(dim, dtype=torch.int64, device=device)
    for r0 in range(0, n_rows, _ROWS_PER_CHUNK):
        rows = torch.arange(r0, min(r0 + _ROWS_PER_CHUNK, n_rows), dtype=torch.int64,
                            device=device)
        k = _mix32(rows[:, None] * dim + cols[None, :])
        h1, h2 = _mix32(k ^ salt_a), _mix32(k ^ salt_b)
        s = (h1 & 0xFFFF) + (h1 >> 16) + (h2 & 0xFFFF) + (h2 >> 16) - _SUM4_MEAN
        out[r0:r0 + rows.shape[0]] = (s.to(torch.float32) * c).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

NEG_INF = -1.0e30


class ParamTree(nn.Module):
    """Parameters held under the reference's tree names: a dict's tensors
    become parameters, its dicts sub-modules and its lists
    ``nn.ModuleList``s, so ``named_parameters`` gives the reference's
    paths (``"mlp.0.w"``).  ``tree["name"]`` reads an entry as the
    reference reads its dict, so one function body serves this module and
    a plain dict of tensors."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, *, device) -> dict:
    """``{"wi_gate", "wi_up", "wo"}``, each from ``dense_init``."""
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]
