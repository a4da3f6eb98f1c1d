"""Deterministic masked scatter for the state transitions.

``index_put_`` with repeated indices has no defined winner on CUDA, and a
boolean-mask filter (``t[idx[mask]] = v[mask]``) waits for the device to
learn how many rows survive, as does any host value copied to the card.
:func:`masked_set_` needs neither: disabled rows repeat the write of the
first enabled row (or, with none enabled, write back the current value
at their own target), so every location written receives one value,
whatever the order of the writes.
"""
from __future__ import annotations

import torch


def writable(t: torch.Tensor, inplace: bool) -> torch.Tensor:
    """``t`` itself where the caller owns it (``inplace``), else a copy."""
    return t if inplace else t.clone()


def masked_set_(t: torch.Tensor, idx, vals, mask: torch.Tensor) -> torch.Tensor:
    """``t[idx[r]] = vals[r]`` for every row ``r`` where ``mask[r]``; in place.

    ``idx`` is one index tensor ``(n,)`` or a tuple of them (one per
    leading dim of ``t``), in range for every row, enabled or not.  Two
    enabled rows may share a target only if they write equal values.
    ``vals`` broadcasts to ``(n,) + t.shape[len(idx):]``.  Returns ``t``."""
    idx = tuple(i.long() for i in (idx if isinstance(idx, tuple) else (idx,)))
    n = mask.shape[0]
    if n == 0:
        return t
    if isinstance(vals, torch.Tensor):
        vals = vals.to(t.dtype)
    else:       # made on the device: a host scalar copied there would sync
        vals = torch.full((), vals, dtype=t.dtype, device=t.device)
    vals = vals.broadcast_to((n,) + t.shape[len(idx):])
    # the first enabled row (else row 0), as a (1,) index: a 0-d tensor
    # index would be read back to the host
    j = torch.argmax(mask.to(torch.uint8)).reshape(1)
    lead = (1,) * (vals.dim() - 1)
    fill = torch.where(mask[j].reshape((1,) + lead), vals[j], t[tuple(i[j] for i in idx)])
    m = mask.reshape((n,) + lead)
    t[tuple(torch.where(mask, i, i[j]) for i in idx)] = torch.where(m, vals, fill)
    return t
