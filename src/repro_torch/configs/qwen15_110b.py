"""qwen1.5-110b [dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.common import lm_cells
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-110b",
    vocab=152064,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    qkv_bias=True,
    dtype="bfloat16",
    scan_unroll=1,    # the reference dry run's unroll factor
)

SMOKE = LMConfig(
    name="qwen1.5-110b-smoke",
    vocab=256, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    qkv_bias=True, dtype="float32", kv_chunk=16,
)


def cells():
    return lm_cells("qwen1.5-110b", CONFIG, SMOKE)
