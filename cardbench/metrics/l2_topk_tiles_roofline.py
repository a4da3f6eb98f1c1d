"""#1 ``l2_topk_tiles``: the least time of the window's navigation (each
dispatched batch's rows against the live centroids) over the kernel's
device time, in percent."""
from cardbench import roofline
from cardbench.readers import roofline_share


def _work(batch, cfg, ctx):
    return roofline.l2_topk(batch["q"], ctx["p_live"], cfg["dim"], batch["nprobe"])


def read(ctx):
    return roofline_share(ctx, lambda n: "l2_topk_tiles" in n, _work, roofline.TF32_FLOP_PER_S)
