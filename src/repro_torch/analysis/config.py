"""spflint analysis spec: what the passes check, declared as data.

The passes themselves are generic machinery (replay.py / locks.py /
smem.py); everything repo-specific — which step builders are replay
roots, where the stamp tuples live, which CUDA launch entries exist and
the geometries they run at — is pinned HERE so the fixture tests can aim
the same passes at seeded violation trees with a different spec.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """Replay-determinism pass inputs.

    ``roots`` are the functions whose transitive callees constitute the
    WAL-replayed dispatch surface: every config field read reachable from
    them must be classified (stamped replay-critical, or explicitly
    exempt with a reason) and no wall-clock / unseeded-RNG / set-order /
    CUDA-nondeterministic accumulation may be reachable.
    """

    roots: tuple[str, ...]        # "module:qualname" entries
    config_class: str             # "module:Class" (the frozen config)
    critical_stamp: str           # "module:NAME" tuple of stamped fields
    exempt_stamp: str             # "module:NAME" tuple of exempt fields


@dataclasses.dataclass(frozen=True)
class LockSpec:
    """Lock-discipline pass inputs: modules scanned for classes that
    declare a ``FIELD_OWNERSHIP`` map (the pass is opt-in per class)."""

    module_prefixes: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SmemSpec:
    """CUDA launcher resource pass inputs.

    ``csrc`` is the directory of the ``.cu`` sources, relative to the tree
    root; every ``extern "C"`` launch entry there needs a row of
    ``entries``: ``entry -> (mirror form, payloads it takes)``, the form
    naming the stdlib mirror of its launcher's shared-memory arithmetic
    (smem.py).  ``bindings`` are the geometries every entry is evaluated
    at, one per configuration: its symbols (``dim``, ``bs``, ``k`` the
    scans' per-page k, ``nav_k`` and ``block_p`` the navigation's) and the
    ``payloads`` its pool stores.  ``kernel_prefixes`` name the packages
    whose ``*.kernel`` modules hold the wrappers the fallback rule reads.
    """

    csrc: str
    kernel_prefixes: tuple[str, ...]
    limit_bytes: int              # dynamic shared memory a block may take
    sm_bytes: int                 # shared memory of one SM
    reserved_bytes: int           # shared memory the runtime keeps a block
    entries: dict
    bindings: tuple


@dataclasses.dataclass(frozen=True)
class AnalysisSpec:
    replay: ReplaySpec
    locks: LockSpec
    smem: SmemSpec


# ---------------------------------------------------------------------------
# The repo's own spec
# ---------------------------------------------------------------------------

PAYLOADS = ("float32", "bfloat16", "int8")

# The seven launch entries of kernels/csrc (the kernel table's #1 .. #7).
SMEM_ENTRIES = {
    "l2_topk_tiles_f32": ("l2", ("float32",)),
    "scan_per_query": ("per_query", PAYLOADS),
    "scan_batched": ("batched", PAYLOADS),
    "scan_per_query_topk": ("per_query_topk", PAYLOADS),
    "scan_per_query_topk_q8": ("per_query_topk", ("int8",)),
    "scan_batched_topk": ("batched_topk", PAYLOADS),
    "scan_batched_topk_q8": ("batched_topk", ("int8",)),
}

# One geometry per configuration the repo runs the kernels at.  ``k`` is
# min(search k x rerank_factor, BS) at the serving k of 10; ``nav_k`` is
# min(nprobe, block_p) and ``block_p`` min(512, P_cap rounded up to 128),
# as kernels/l2_topk/ops.py tiles the centroids; ``payloads`` is the
# pool's storage dtype (storage/codec.py ``payload_dtype``).
SMEM_BINDINGS = (
    {"name": "spfresh-paged",
     "source": "repro_torch/configs/spfresh.py CONFIG_PAGED (fp32 codec: "
               "int8 bytes as they are), serving k 10",
     "dim": 100, "bs": 32, "k": 10, "nav_k": 64, "block_p": 512,
     "payloads": ("int8",)},
    {"name": "spfresh-int8",
     "source": "CONFIG_PAGED with codec int8, rerank_factor 4 (chip_smoke.py "
               "CELLS, the reference's CODEC_CELLS int8 cell)",
     "dim": 100, "bs": 32, "k": 32, "nav_k": 64, "block_p": 512,
     "payloads": ("int8",)},
    {"name": "smoke",
     "source": "repro_torch/configs/spfresh.py SMOKE, serving k 10",
     "dim": 16, "bs": 8, "k": 8, "nav_k": 8, "block_p": 128,
     "payloads": ("float32",)},
    {"name": "two-tower",
     "source": "repro_torch/configs/two_tower_retrieval.py ann_index_cfg(), "
               "retrieval k 10",
     "dim": 256, "bs": 32, "k": 10, "nav_k": 16, "block_p": 512,
     "payloads": ("bfloat16",)},
    {"name": "reference-vmem",
     "source": "the reference's VMEM_BINDINGS (repro/analysis/config.py), "
               "float32 LireConfig defaults",
     "dim": 128, "bs": 16, "k": 8, "nav_k": 8, "block_p": 512,
     "payloads": ("float32",)},
)

DEFAULT_SPEC = AnalysisSpec(
    replay=ReplaySpec(
        roots=(
            # single-device step builders (the WAL dispatch surface)
            "repro_torch.core.index:insert_step",
            "repro_torch.core.index:delete_step",
            "repro_torch.core.index:fused_maintenance_step",
            "repro_torch.core.index:fused_maintenance_round",
            # the sharded twins of the same dispatches
            "repro_torch.distributed.sharded_index:sharded_insert",
            "repro_torch.distributed.sharded_index:sharded_delete",
            "repro_torch.distributed.sharded_index:sharded_maintenance_step",
            "repro_torch.distributed.sharded_index:sharded_maintenance_round",
            # template + codec selection: recovery rebuilds the state from
            # the config before replaying the WAL onto it
            "repro_torch.core.types:make_empty_state",
        ),
        config_class="repro_torch.core.types:LireConfig",
        critical_stamp="repro_torch.storage.durability:REPLAY_CRITICAL_FIELDS",
        exempt_stamp="repro_torch.storage.durability:REPLAY_EXEMPT_FIELDS",
    ),
    locks=LockSpec(module_prefixes=("repro_torch.serve",)),
    smem=SmemSpec(
        csrc="repro_torch/kernels/csrc",
        kernel_prefixes=("repro_torch.kernels",),
        limit_bytes=232448,        # sm_90: 227 KB a block (opt-in)
        sm_bytes=233472,           # 228 KB an SM
        reserved_bytes=1024,       # kept by the runtime for each block
        entries=SMEM_ENTRIES,
        bindings=SMEM_BINDINGS,
    ),
)
