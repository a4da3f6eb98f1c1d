"""Paged block pool — the analogue of SPFresh's Block Controller (§4.3).

Postings live in fixed-size blocks of a device array ``blocks[B_cap, BS,
d]``; the block mapping is ``posting_blocks[P_cap, MB]`` (int32 block ids,
-1 unused).  GET is a block-table gather; APPEND writes one (block, slot)
of a posting's tail block; the free pool is an int32 stack.  Every op
returns a new pool; the tensors of the input pool are not written.

``dirty[B_cap]`` marks every block whose payload or slot metadata changed
since the last checkpoint cleared it.  Lossy codecs (``storage.codec``)
carry a cold exact-fp32 tier ``blocks_exact`` beside the hot payload.
"""
from __future__ import annotations

import torch

from repro_torch.storage import codec as pc
from repro_torch.utils.tree import state_dataclass


@state_dataclass
class BlockPool:
    # --- static geometry ---
    block_size: int                # BS vectors per block
    max_blocks_per_posting: int    # MB
    codec: str                     # fp32 | bf16 | int8
    # --- device state ---
    blocks: torch.Tensor           # (B_cap, BS, d) hot-tier payload
    block_vid: torch.Tensor        # (B_cap, BS) i32 vector ids, -1 empty
    block_ver: torch.Tensor        # (B_cap, BS) u8 version written with the data
    posting_blocks: torch.Tensor   # (P_cap, MB) i32 block ids, -1 unused
    posting_len: torch.Tensor      # (P_cap,) i32 vectors in posting
    free_stack: torch.Tensor       # (B_cap,) i32 free block ids (top at free_top-1)
    free_top: torch.Tensor         # () i32 number of free blocks
    dirty: torch.Tensor            # (B_cap,) bool
    post_scale: torch.Tensor       # (P_cap,) f32 per-posting quant scale
    post_zero: torch.Tensor        # (P_cap,) f32 per-posting quant zero-point
    blocks_exact: torch.Tensor | None  # (B_cap, BS, d) f32 cold tier

    @property
    def posting_capacity(self) -> int:
        return self.block_size * self.max_blocks_per_posting

    @property
    def num_postings_cap(self) -> int:
        return self.posting_blocks.shape[0]

    @property
    def num_blocks_cap(self) -> int:
        return self.blocks.shape[0]

    @property
    def dim(self) -> int:
        return self.blocks.shape[-1]


def make_block_pool(
    *,
    num_blocks: int,
    block_size: int,
    dim: int,
    num_postings_cap: int,
    max_blocks_per_posting: int,
    dtype="float32",
    codec: str = "fp32",
    device="cuda",
) -> BlockPool:
    """Fresh, empty pool: every block free, every posting empty."""
    pay = pc.payload_dtype(codec, dtype)
    i32 = dict(dtype=torch.int32, device=device)
    return BlockPool(
        block_size=block_size,
        max_blocks_per_posting=max_blocks_per_posting,
        codec=codec,
        blocks=torch.zeros((num_blocks, block_size, dim), dtype=pay, device=device),
        block_vid=torch.full((num_blocks, block_size), -1, **i32),
        block_ver=torch.zeros((num_blocks, block_size), dtype=torch.uint8, device=device),
        posting_blocks=torch.full((num_postings_cap, max_blocks_per_posting), -1, **i32),
        posting_len=torch.zeros((num_postings_cap,), **i32),
        free_stack=torch.arange(num_blocks, **i32),
        free_top=torch.tensor(num_blocks, **i32),
        dirty=torch.zeros((num_blocks,), dtype=torch.bool, device=device),
        post_scale=torch.ones((num_postings_cap,), dtype=torch.float32, device=device),
        post_zero=torch.zeros((num_postings_cap,), dtype=torch.float32, device=device),
        blocks_exact=(
            torch.zeros((num_blocks, block_size, dim), dtype=torch.float32, device=device)
            if pc.has_exact_tier(codec) else None
        ),
    )


def clear_dirty(pool: BlockPool) -> BlockPool:
    """All blocks clean — called after a checkpoint serializes the pool."""
    return pool.replace(dirty=torch.zeros_like(pool.dirty))


def group_rank(keys: torch.Tensor, n_groups: int, enable: torch.Tensor) -> torch.Tensor:
    """Rank of each enabled row among the enabled rows with the same key,
    in row order (stable group-by sort, position minus group start).
    Disabled rows get ranks in a trailing dummy group."""
    n = keys.shape[0]
    key = torch.where(enable, keys.long(), n_groups)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    pos = torch.arange(n, device=keys.device)
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.long, device=keys.device)
    rank[order] = pos - start
    return rank


# ---------------------------------------------------------------------------
# APPEND — tail-block writes (paper §4.3)
# ---------------------------------------------------------------------------

def append_batch(
    pool: BlockPool,
    pids: torch.Tensor,
    vecs: torch.Tensor,
    vids: torch.Tensor,
    vers: torch.Tensor,
    enable: torch.Tensor,
) -> tuple[BlockPool, torch.Tensor]:
    """Batched APPEND with the outcome of appending the rows one by one in
    row order (the reference's n-step ``append_batch`` scan), computed in
    one vectorised pass.  Returns ``(pool, ok (n,) bool)``.

    Sequential semantics, restated so they vectorise: a row's global slot
    is its posting's length plus its rank among the batch's enabled rows
    of that posting.  A row at a block boundary (slot 0) pops a fresh
    block; pops go to such leader rows in row order, so the first
    ``free_top`` leaders get ``stack[top-1], stack[top-2], ...`` and every
    later leader fails.  A posting lands a rank prefix: rows fail from its
    first failed leader on, and from its capacity on.  The first row that
    lands in an empty posting trains the posting's ``(scale, zero)``.
    """
    n = pids.shape[0]
    bs = pool.block_size
    cap = pool.posting_capacity
    mb = pool.max_blocks_per_posting
    p_cap = pool.num_postings_cap
    dev = pids.device
    en = enable & (pids >= 0)
    safe = torch.clamp(pids.long(), min=0)

    rank = group_rank(safe, p_cap, en)
    length = pool.posting_len.long()[safe]
    slot_g = length + rank
    blk = slot_g // bs
    slot = slot_g % bs
    safe_blk = torch.clamp(blk, max=mb - 1)
    in_cap = en & (slot_g < cap)

    # leaders pop in row order; the first free_top of them succeed
    leader = in_cap & (slot == 0)
    lrank = torch.cumsum(leader.long(), 0) - 1
    free_top = pool.free_top.long()
    lead_ok = leader & (lrank < free_top)
    lead_fail = leader & ~lead_ok
    # first failed leader's rank per posting: later ranks of it fail too
    big = torch.full((p_cap,), cap, dtype=torch.long, device=dev)
    first_fail = big.scatter_reduce(
        0, safe, torch.where(lead_fail, rank, cap), reduce="amin"
    )
    ok = in_cap & (rank < first_fail[safe])

    new_bid = pool.free_stack.long()[torch.clamp(free_top - 1 - lrank, min=0)]
    posting_blocks = pool.posting_blocks.clone()
    posting_blocks[safe[lead_ok], safe_blk[lead_ok]] = new_bid[lead_ok].int()
    bid = posting_blocks.long()[safe, safe_blk]

    # quant params: the row landing at global slot 0 trains them
    fresh = ok & (slot_g == 0)
    rs, rz = pc.train_scale_zero(vecs[:, None, :], torch.ones((n, 1), dtype=torch.bool, device=dev))
    post_scale = pool.post_scale.clone()
    post_zero = pool.post_zero.clone()
    post_scale[safe[fresh]] = rs[fresh]
    post_zero[safe[fresh]] = rz[fresh]

    tb, ts = bid[ok], slot[ok]
    rows = vecs[ok]
    enc = pc.encode_payload(
        pool.codec, rows, post_scale[safe[ok]][:, None],
        post_zero[safe[ok]][:, None], pool.blocks.dtype,
    )
    blocks = pool.blocks.clone()
    blocks[tb, ts] = enc
    blocks_exact = pool.blocks_exact
    if blocks_exact is not None:
        blocks_exact = blocks_exact.clone()
        blocks_exact[tb, ts] = rows.float()
    block_vid = pool.block_vid.clone()
    block_vid[tb, ts] = vids[ok].int()
    block_ver = pool.block_ver.clone()
    block_ver[tb, ts] = vers[ok].to(torch.uint8)
    posting_len = pool.posting_len.clone()
    posting_len.index_add_(0, safe[ok], torch.ones_like(tb, dtype=torch.int32))
    dirty = pool.dirty.clone()
    dirty[tb] = True
    n_pop = lead_ok.sum().to(torch.int32)
    return (
        pool.replace(
            blocks=blocks,
            blocks_exact=blocks_exact,
            block_vid=block_vid,
            block_ver=block_ver,
            posting_blocks=posting_blocks,
            posting_len=posting_len,
            free_top=pool.free_top - n_pop,
            dirty=dirty,
            post_scale=post_scale,
            post_zero=post_zero,
        ),
        ok,
    )


# ---------------------------------------------------------------------------
# GET — block-table gather (ParallelGET is a batch of these)
# ---------------------------------------------------------------------------

def parallel_get_hot(pool: BlockPool, pids: torch.Tensor):
    """Batched hot-tier posting read: ``pids (m,)`` → ``(vecs (m, cap, d)
    f32 decoded, vids (m, cap), vers (m, cap), valid (m, cap))``.

    Slots past ``posting_len`` are masked invalid.  The oracle search path
    reads this so its distances see the same decoded values as the scan
    kernels."""
    pids = pids.long()
    bids = pool.posting_blocks[pids]                   # (m, MB)
    safe = torch.clamp(bids.long(), min=0)
    m = pids.shape[0]
    scale = pool.post_scale[pids][:, None, None, None]
    zero = pool.post_zero[pids][:, None, None, None]
    vecs = pc.decode_payload(pool.codec, pool.blocks[safe], scale, zero)
    cap = pool.posting_capacity
    vecs = vecs.reshape(m, cap, pool.dim)
    vids = pool.block_vid[safe].reshape(m, cap)
    vers = pool.block_ver[safe].reshape(m, cap)
    idx = torch.arange(cap, device=pids.device)
    valid = (idx[None, :] < pool.posting_len[pids][:, None]) & (vids >= 0)
    return vecs, vids, vers, valid


def gather_posting_hot(pool: BlockPool, pid: torch.Tensor):
    """One posting's hot-tier read: ``(vecs (cap, d), vids, vers, valid)``."""
    out = parallel_get_hot(pool, pid.reshape(1))
    return tuple(x[0] for x in out)


def used_blocks(pool: BlockPool) -> torch.Tensor:
    """Number of allocated blocks (resource accounting, paper Fig. 7d)."""
    return pool.num_blocks_cap - pool.free_top
