"""Service API: ``repro_torch.api.open(ServiceSpec) -> Service``.

One frozen spec describes the whole service (index geometry, scan data
path, micro-batching, maintenance, durability); ``open`` compiles it into
a durable serving handle over the index on the card.  The same nine names
as the JAX package's ``spfresh`` namespace:

    from repro_torch import api

    spec = api.ServiceSpec(
        index=api.IndexSpec(config=my_lire_config),
        durability=api.DurabilitySpec(root="/data/svc"),
    )
    svc = api.open(spec, vectors=base)          # build (+ open-time snapshot)
    svc.insert(new_vecs, new_ids)
    svc.checkpoint()
    svc.close()

    svc = api.open(spec)                        # crash recovery: snapshot +
                                                # WAL replay
"""
from repro_torch.api.service import Service, open  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    DurabilitySpec,
    IndexSpec,
    MaintenanceSpec,
    ScanSpec,
    ServeSpec,
    ServiceSpec,
    ShardSpec,
)

__all__ = [
    "DurabilitySpec", "IndexSpec", "MaintenanceSpec", "ScanSpec",
    "ServeSpec", "Service", "ServiceSpec", "ShardSpec", "open",
]
