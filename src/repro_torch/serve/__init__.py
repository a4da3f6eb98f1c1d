"""Serving layer: the batched async pipeline over the SPFresh index.

``RequestQueue`` micro-batches requests into padded fixed-shape buckets,
``ServeEngine`` dispatches them into the index's fixed-shape steps, and
``MaintenancePolicy`` schedules the background Local Rebuilder.
"""
from repro_torch.serve.engine import (  # noqa: F401
    EngineConfig, IndexBackend, LocalBackend, ServeEngine,
)
from repro_torch.serve.policy import (  # noqa: F401
    BacklogPolicy, MaintenancePolicy, RatioPolicy,
)
from repro_torch.serve.queue import RequestQueue, Ticket, default_buckets  # noqa: F401
