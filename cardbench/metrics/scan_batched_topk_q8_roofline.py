"""#7 ``scan_batched_topk_q8``: the least time of the window's batched
scans over int8 codes (each batch's unique live pages against its rows,
``rerank_factor`` x k candidates a query) over the kernel's device time,
in percent."""
from cardbench import roofline
from cardbench.readers import roofline_share, template_args


def _is_scan(name):
    args = template_args(name)
    return "scan_batched_topk" in name and len(args) == 4 and args[2] == "true"


def _work(batch, cfg, ctx):
    k = ctx["config"]["serve"]["search_k"] * max(1, cfg["rerank_factor"])
    return roofline.scan_batched(batch["n_kept"], batch["q"], cfg["block_size"], cfg["dim"],
                                 1, k, q8=True)


def read(ctx):
    return roofline_share(ctx, _is_scan, _work, roofline.INT8_OP_PER_S)
