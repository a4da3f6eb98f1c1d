"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 (YouTube)].

The flagship of the reference: ``retrieval_cand`` is the ANN query the
SPFresh index serves (``repro_torch.serve.retrieval``).  ``SERVE_CONFIG``
is the bf16 checkpoint the serving cells read; ``ann_index_cfg`` the
index over the item tower's embeddings.
"""
import dataclasses

from repro_torch.core.types import LireConfig
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(
    name="two-tower-retrieval",
    n_items=10_000_000,
    n_user_fields=8,
    user_vocab_per_field=100_000,
    embed_dim=256,
    tower_dims=(1024, 512, 256),
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", n_items=512, n_user_fields=4,
    user_vocab_per_field=64, embed_dim=16, tower_dims=(32, 16),
)

# the serving cells read a bf16-cast checkpoint
SERVE_CONFIG = dataclasses.replace(CONFIG, dtype="bfloat16")


def ann_index_cfg() -> LireConfig:
    """The item corpus's index: dim 256, bf16 payload, BS 32 × MB 4,
    sized per shard of a 256-way document-sharded 10M-item corpus
    (~40k items and replica headroom)."""
    return LireConfig(
        dim=256, block_size=32, max_blocks_per_posting=4,   # cap 128
        num_blocks=4096, num_postings_cap=2048,
        num_vectors_cap=131072, vector_dtype="bfloat16",
        split_limit=96, merge_limit=12, reassign_range=16,
        reassign_budget=128, replica_count=2, nprobe=16,
    )
