"""Where the shards and replicas of a sharded index live.

The JAX package lays a replicated sharded service out on a 2-axis
``(data, model)`` mesh — the model axis shards postings, the data axis
holds ``n_replicas`` full copies — and splits it into one row submesh per
copy (row 0 the primary).  Here the layout is ``n_replicas`` rows of
``n_shards`` devices, row 0 the primary's.  Every shard of every copy
lives on the one device given (the card, or the CPU when the caller asks
for it); placing the shards across several cards is not done yet.

The JAX package's PartitionSpec rules for its model families belong with
those models and are not here.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import resolve_device


def replica_layout(n_replicas: int, n_shards: int, device="cuda") -> list[list[torch.device]]:
    """``n_replicas`` rows of ``n_shards`` devices; row 0 is the primary's."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"need n_replicas, n_shards >= 1: {n_replicas}, {n_shards}")
    dev = resolve_device(device)
    return [[dev] * n_shards for _ in range(n_replicas)]
