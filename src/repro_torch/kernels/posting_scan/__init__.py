from repro_torch.kernels.posting_scan.ops import (  # noqa: F401
    dedup_pages,
    scan_posting_blocks_topk,
    scan_unique_blocks_topk,
)
from repro_torch.kernels.posting_scan.ref import (  # noqa: F401
    scan_batched_topk_ref,
    scan_per_query_topk_ref,
)
