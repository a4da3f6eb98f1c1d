"""Roofline accounting of the dry run's counts on one NVIDIA H100.

Three terms per (arch × shape × mesh), in seconds a device:

    compute    = FLOPs / peak FLOP/s of the cell's compute dtype
    memory     = bytes accessed / HBM bytes/s
    collective = collective bytes / link bytes/s

The peaks are NVIDIA's H100 SXM data sheet's, dense, at the 700 W power
limit: 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s of HBM.  The port runs f32 with TF32 off (as
``chip_smoke.py`` sets it), so an f32 cell's compute peak is 67 TFLOP/s
and a bf16 cell's 989.  One card has no collective: the term is 0.  On
the 256- and 512-chip meshes there is no partitioning compiler to say
which collectives a step would run, so collective bytes are unknown and
the term is left out (``None``); no link bandwidth is assumed.  The
reference's ``collective_bytes(hlo_text)`` reads partitioned HLO text and
has no counterpart here.
"""
from __future__ import annotations

HBM_BW = 3.35e12           # bytes/s
PEAK_FLOPS = {             # FLOP/s, dense; TF32 (495e12) is off in the port
    "bfloat16": 989e12,
    "float32": 67e12,
}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"


def compute_dtype(cell) -> str:
    """The dtype a cell computes in: its model config's, f32 where it
    names none (the index, the GAT)."""
    return getattr(cell.model_cfg, "dtype", "float32")


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float | None, dtype: str = "float32") -> dict:
    """The three terms, the dominant one (among those known) and the
    compute term's share of the bound; ``collective_bytes_per_device`` is
    ``None`` where it is unknown."""
    if collective_bytes_per_device not in (None, 0):
        raise ValueError("no link bandwidth is assumed: collective bytes are 0 (one card) "
                         "or unknown (None)")
    peak = PEAK_FLOPS[dtype]
    terms = {"compute_s": flops_per_device / peak, "memory_s": bytes_per_device / HBM_BW,
             "collective_s": None if collective_bytes_per_device is None else 0.0}
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    bound = known[dominant]
    return {**terms, "dominant": dominant,
            "roofline_fraction_compute": terms["compute_s"] / bound if bound > 0 else 0.0,
            "peak_flops": peak, "peak_dtype": dtype, "hbm_bw": HBM_BW, "peaks": PEAK_SOURCE}


def model_flops(cell) -> float | None:
    """6·N·D (dense) / 6·N_active·D (MoE) model FLOPs of a train step,
    2·N·D of a prefill and 2·N·B of a decode step, for LM cells; ``None``
    for families without a standard counting rule."""
    if cell.family != "lm":
        return None
    from repro_torch.configs.common import LM_SHAPES

    sh = LM_SHAPES[cell.shape]
    cfg = cell.model_cfg
    n = cfg.n_active_params if cfg.moe else cfg.n_params
    if cell.kind == "train":
        return 6.0 * n * sh["seq"] * sh["batch"]
    if cell.kind == "prefill":
        return 2.0 * n * sh["seq"] * sh["batch"]
    return 2.0 * n * sh["batch"]          # decode: one token a sequence
