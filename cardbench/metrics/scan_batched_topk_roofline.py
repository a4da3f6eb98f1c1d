"""#6 ``scan_batched_topk``: the least time of the window's batched scans
(each batch's unique live pages against its rows, float32 queries) over
the kernel's device time, in percent."""
from cardbench import roofline
from cardbench.readers import roofline_share, template_args

ITEM = {"int8": 1, "bfloat16": 2, "float32": 4}


def _is_scan(name):
    args = template_args(name)
    return "scan_batched_topk" in name and len(args) == 4 and args[1] != "0" and args[2] == "false"


def _work(batch, cfg, ctx):
    k = ctx["config"]["serve"]["search_k"] * max(1, cfg["rerank_factor"])
    return roofline.scan_batched(batch["n_kept"], batch["q"], cfg["block_size"], cfg["dim"],
                                 ITEM[cfg["vector_dtype"]], k)


def read(ctx):
    return roofline_share(ctx, _is_scan, _work, roofline.TF32_FLOP_PER_S)
