"""Posting payload codecs: pluggable hot-tier dtype for the block pool.

The pool's vector payload (``pool.blocks``) is stored at full precision
(``fp32``: the configured ``vector_dtype`` verbatim), half precision
(``bf16``), or as asymmetric per-posting int8 (``int8``).  The codec is a
static property of the pool; the quantization parameters (one scale and
one zero-point per posting) are ordinary state tensors.

Quantization scheme (``int8``), per posting over its live rows::

    zero  = (min + max) / 2
    scale = (max - min) / 254        (1.0 when the range collapses)
    q     = clip(round((x - zero) / scale), -127, 127)  -> int8
    x'    = q * scale + zero

``torch.round`` rounds half to even, as the reference does.  A float to
int8 cast (the ``fp32`` codec over an int8 ``vector_dtype``) truncates
toward zero; values outside [-128, 127] are undefined, so callers feed
such configs integer-valued vectors in range.
"""
from __future__ import annotations

import numpy as np
import torch

CODECS = ("fp32", "bf16", "int8")

_QMAX = 127.0
_QLEVELS = 254.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """``"int8"`` / ``"bfloat16"`` / ... → the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def payload_dtype(codec: str, vector_dtype) -> torch.dtype:
    """Storage dtype of ``pool.blocks`` for a codec (``fp32`` passes the
    configured vector dtype through unchanged)."""
    if codec == "fp32":
        return torch_dtype(vector_dtype)
    if codec == "bf16":
        return torch.bfloat16
    if codec == "int8":
        return torch.int8
    raise ValueError(f"unknown codec {codec!r} (choose from {CODECS})")


def is_quantized(codec: str) -> bool:
    """True when the codec needs per-posting scale/zero to decode."""
    return codec == "int8"


def has_exact_tier(codec: str) -> bool:
    """True when the pool keeps a cold exact-fp32 copy alongside."""
    return codec in ("bf16", "int8")


# ---------------------------------------------------------------------------
# torch helpers
# ---------------------------------------------------------------------------

def train_scale_zero(vecs: torch.Tensor, valid: torch.Tensor):
    """Per-posting ``(scale, zero)`` from the valid rows of ``vecs``.

    vecs ``(..., n, d)``, valid ``(..., n)`` → two ``(...,)`` f32 tensors.
    Postings with no valid row (or a collapsed range) get scale 1."""
    v = vecs.float()
    m = valid[..., None]
    hi = torch.where(m, v, -torch.inf).amax(dim=(-2, -1))
    lo = torch.where(m, v, torch.inf).amin(dim=(-2, -1))
    any_valid = valid.any(dim=-1)
    hi = torch.where(any_valid, hi, 0.0)
    lo = torch.where(any_valid, lo, 0.0)
    zero = (hi + lo) * 0.5
    rng = hi - lo
    scale = torch.where(rng > 0, rng / _QLEVELS, 1.0).float()
    return scale, zero.float()


def encode(vecs, scale, zero) -> torch.Tensor:
    """fp32 rows → int8 codes under a posting's (scale, zero)."""
    q = torch.round((vecs.float() - zero) / scale)
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8)


def decode(codes, scale, zero) -> torch.Tensor:
    """int8 codes → fp32 under (scale, zero)."""
    return codes.float() * scale + zero


def encode_payload(codec: str, vecs, scale, zero, out_dtype) -> torch.Tensor:
    """fp32 rows → hot-tier payload (a plain cast unless ``int8``)."""
    if codec == "int8":
        return encode(vecs, scale, zero)
    return vecs.to(out_dtype)


def decode_payload(codec: str, payload, scale, zero) -> torch.Tensor:
    """Hot-tier payload → fp32 rows (inverse of ``encode_payload``)."""
    if codec == "int8":
        return decode(payload, scale, zero)
    return payload.float()


# ---------------------------------------------------------------------------
# numpy helpers (host-side build path)
# ---------------------------------------------------------------------------

def np_train_scale_zero(rows: np.ndarray) -> tuple[np.float32, np.float32]:
    """(scale, zero) for one posting's rows (n, d) on host."""
    if rows.size == 0:
        return np.float32(1.0), np.float32(0.0)
    hi = float(rows.max())
    lo = float(rows.min())
    zero = (hi + lo) * 0.5
    rng = hi - lo
    scale = rng / _QLEVELS if rng > 0 else 1.0
    return np.float32(scale), np.float32(zero)


def np_encode(rows: np.ndarray, scale, zero) -> np.ndarray:
    q = np.round((rows.astype(np.float32) - zero) / scale)
    return np.clip(q, -_QMAX, _QMAX).astype(np.int8)


def np_decode(codes: np.ndarray, scale, zero) -> np.ndarray:
    return codes.astype(np.float32) * scale + zero
