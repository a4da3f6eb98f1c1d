"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.common import lm_cells
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    vocab=49155,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    moe=True,
    n_experts=32,
    moe_top_k=8,
    dtype="bfloat16",
    scan_unroll=1,    # the reference dry run's unroll factor
)

SMOKE = LMConfig(
    name="granite-moe-smoke",
    vocab=256, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    moe=True, n_experts=8, moe_top_k=2, dtype="float32", kv_chunk=16,
)


def cells():
    return lm_cells("granite-moe-1b-a400m", CONFIG, SMOKE)
