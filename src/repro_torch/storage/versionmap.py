"""Version map — paper §4.2.1.

One byte per vector id: low 7 bits = reassign version (wraps mod 128), high
bit = deletion label.  A stored replica is *stale* when its written version
differs from the map's current version, or the vector is deleted.

The version tensor reserves its LAST slot as a scratch target: disabled
rows of a batched update scatter there.  Routing a disabled row to a live
index (e.g. clamp-to-0) would be a correctness hazard — ``index_put_`` with
duplicate indices has no defined order on CUDA, so a disabled row's stale
write could clobber a real update to vid 0.
"""
from __future__ import annotations

import torch

VERSION_MASK = 0x7F
DELETED_BIT = 0x80


def scratch_index(versions: torch.Tensor) -> int:
    return versions.shape[0] - 1


def _targets(versions, vids, enable=None) -> torch.Tensor:
    scratch = scratch_index(versions)
    safe = torch.clamp(vids.long(), 0, scratch - 1)
    ok = vids >= 0 if enable is None else enable & (vids >= 0)
    return torch.where(ok, safe, scratch)


def _scatter(versions, idx, values) -> torch.Tensor:
    out = versions.clone()
    out[idx] = values
    return out


def current_version(versions, vids) -> torch.Tensor:
    """Low-7-bit current version for each vid."""
    safe = torch.clamp(vids.long(), 0, scratch_index(versions) - 1)
    return versions[safe] & VERSION_MASK


def bump_version(versions, vids, enable=None) -> torch.Tensor:
    """Increment the 7-bit version (mod 128), keeping the deletion bit."""
    idx = _targets(versions, vids, enable)
    cur = versions[idx]
    new = (cur & DELETED_BIT) | ((cur + 1) & VERSION_MASK)
    return _scatter(versions, idx, new)


def mark_deleted(versions, vids, enable=None) -> torch.Tensor:
    idx = _targets(versions, vids, enable)
    return _scatter(versions, idx, versions[idx] | DELETED_BIT)


def clear(versions, vids, enable=None) -> torch.Tensor:
    """Reset a vid's byte (used when a deleted id slot is recycled)."""
    idx = _targets(versions, vids, enable)
    return _scatter(versions, idx, torch.zeros_like(versions[idx]))


def is_deleted(versions, vids) -> torch.Tensor:
    return (versions[vids.long()] & DELETED_BIT) != 0


def is_stale(versions, vids, stored_ver) -> torch.Tensor:
    """True when a stored replica must be ignored (filtered at search)."""
    cur = versions[torch.clamp(vids.long(), min=0)]
    stale = ((cur & VERSION_MASK) != (stored_ver & VERSION_MASK)) | (
        (cur & DELETED_BIT) != 0
    )
    return stale | (vids < 0)
