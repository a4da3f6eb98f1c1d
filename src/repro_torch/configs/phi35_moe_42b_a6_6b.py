"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.common import lm_cells
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    vocab=32064,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    moe=True,
    n_experts=16,
    moe_top_k=2,
    dtype="bfloat16",
    scan_unroll=1,    # the reference dry run's unroll factor
)

SMOKE = LMConfig(
    name="phi35-moe-smoke",
    vocab=256, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    moe=True, n_experts=4, moe_top_k=2, dtype="float32", kv_chunk=16,
)


def cells():
    return lm_cells("phi3.5-moe-42b-a6.6b", CONFIG, SMOKE)
