from repro_torch.kernels.posting_scan.ops import (  # noqa: F401
    dedup_pages,
    page_positions,
    scan_posting_blocks,
    scan_posting_blocks_topk,
    scan_posting_blocks_topk_q8,
    scan_unique_blocks,
    scan_unique_blocks_topk,
    scan_unique_blocks_topk_pairs,
    scan_unique_blocks_topk_q8,
    scan_unique_blocks_topk_q8_pairs,
)
from repro_torch.kernels.posting_scan.ref import (  # noqa: F401
    scan_batched_topk_pairs_ref,
    scan_batched_topk_q8_pairs_ref,
    scan_batched_topk_q8_ref,
    scan_batched_topk_ref,
    scan_per_query_topk_q8_ref,
    scan_per_query_topk_ref,
    scan_posting_blocks_ref,
    scan_unique_blocks_ref,
)
