"""deepseek-7b [dense] 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.common import lm_cells
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-7b",
    vocab=102400,
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,    # full MHA (kv=32)
    d_ff=11008,
    dtype="bfloat16",
    scan_unroll=1,    # the reference dry run's unroll factor
)

SMOKE = LMConfig(
    name="deepseek-7b-smoke",
    vocab=256, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    dtype="float32", kv_chunk=16,
)


def cells():
    return lm_cells("deepseek-7b", CONFIG, SMOKE)
