"""granite-20b [dense] 52L d_model=6144 48H (GQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""
from repro_torch.configs.common import lm_cells
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-20b",
    vocab=49152,
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,     # MQA (GQA kv=1)
    d_ff=24576,
    dtype="bfloat16",
    scan_unroll=1,    # the reference dry run's unroll factor
)

SMOKE = LMConfig(
    name="granite-20b-smoke",
    vocab=256, n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_ff=128,
    dtype="float32", kv_chunk=16,
)


def cells():
    return lm_cells("granite-20b", CONFIG, SMOKE)
