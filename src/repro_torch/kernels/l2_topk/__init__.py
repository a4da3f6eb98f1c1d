from repro_torch.kernels.l2_topk.ops import l2_topk  # noqa: F401
from repro_torch.kernels.l2_topk.ref import l2_topk_ref  # noqa: F401
