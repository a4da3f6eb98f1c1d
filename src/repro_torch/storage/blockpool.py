"""Paged block pool — the analogue of SPFresh's Block Controller (§4.3).

Postings live in fixed-size blocks of a device array ``blocks[B_cap, BS,
d]``; the block mapping is ``posting_blocks[P_cap, MB]`` (int32 block ids,
-1 unused).  GET is a block-table gather; APPEND writes one (block, slot)
of a posting's tail block; the free pool is an int32 stack.  Every write op
returns a new pool and leaves the input pool's tensors as they were,
unless the caller passes ``inplace=True``: then the op writes the input
pool's tensors and returns a pool holding the same tensors.  Only an
owner of the pool (``SPFreshIndex``) asks for that; both forms give
bit-identical leaves, because both run the same writes, one on copies.
Every scatter gives each location one value (``masked_set_``, no host
sync) or adds integers, so a transition is deterministic on the card.

``dirty[B_cap]`` marks every block whose payload or slot metadata changed
since the last checkpoint cleared it.  Lossy codecs (``storage.codec``)
carry a cold exact-fp32 tier ``blocks_exact`` beside the hot payload.
"""
from __future__ import annotations

import torch

from repro_torch.storage import codec as pc
from repro_torch.utils.scatter import masked_set_, writable
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

def append_batch(pool: BlockPool, pids, vecs, vids, vers, enable, *,
                 inplace: bool = False) -> tuple[BlockPool, torch.Tensor]:
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
    slot_g = pool.posting_len.long()[safe] + rank
    slot = slot_g % bs
    safe_blk = torch.clamp(slot_g // bs, max=mb - 1)
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

    # rows that pop nothing read a clamped slot: with every block free
    # (an empty pool) free_top - 1 - lrank reaches B_cap for them
    new_bid = pool.free_stack.long()[
        torch.clamp(free_top - 1 - lrank, 0, pool.num_blocks_cap - 1)]
    posting_blocks = writable(pool.posting_blocks, inplace)
    masked_set_(posting_blocks, (safe, safe_blk), new_bid, lead_ok)
    bid = torch.clamp(posting_blocks.long()[safe, safe_blk], min=0)
    pool = _append_rows(pool, safe, bid, slot, slot_g, vecs, vids, vers, ok, inplace)
    n_pop = lead_ok.sum().to(torch.int32)
    return pool.replace(posting_blocks=posting_blocks,
                        free_top=pool.free_top - n_pop), ok


def _append_rows(pool: BlockPool, safe, bid, slot, slot_g, vecs, vids, vers,
                 ok, inplace) -> BlockPool:
    """Write the landed rows ``ok`` of an APPEND at ``(bid, slot)``: payload
    (the row landing at global slot 0 trains its posting's quant params,
    later rows of that posting read them), metadata, lengths, dirty."""
    n = safe.shape[0]
    fresh = ok & (slot_g == 0)
    rs, rz = pc.train_scale_zero(
        vecs[:, None, :], torch.ones((n, 1), dtype=torch.bool, device=vecs.device)
    )
    post_scale = masked_set_(writable(pool.post_scale, inplace), safe, rs, fresh)
    post_zero = masked_set_(writable(pool.post_zero, inplace), safe, rz, fresh)
    enc = pc.encode_payload(pool.codec, vecs, post_scale[safe][:, None],
                            post_zero[safe][:, None], pool.blocks.dtype)
    at = (bid, slot)
    blocks = masked_set_(writable(pool.blocks, inplace), at, enc, ok)
    blocks_exact = pool.blocks_exact
    if blocks_exact is not None:
        blocks_exact = masked_set_(writable(blocks_exact, inplace), at, vecs.float(), ok)
    block_vid = masked_set_(writable(pool.block_vid, inplace), at, vids, ok)
    block_ver = masked_set_(writable(pool.block_ver, inplace), at, vers, ok)
    posting_len = writable(pool.posting_len, inplace)
    posting_len.index_add_(0, safe, ok.to(torch.int32))    # integer adds: exact
    dirty = masked_set_(writable(pool.dirty, inplace), bid, True, ok)
    return pool.replace(
        blocks=blocks, blocks_exact=blocks_exact, block_vid=block_vid,
        block_ver=block_ver, posting_len=posting_len, dirty=dirty,
        post_scale=post_scale, post_zero=post_zero,
    )


def append_one(pool: BlockPool, pid, vec, vid, ver, enable, *,
               inplace: bool = False) -> tuple[BlockPool, torch.Tensor]:
    """Append one vector to posting ``pid``: ``(pool, ok)``, ok False when
    the posting is at capacity or the pool is out of blocks."""
    dev = pool.posting_len.device
    pool, ok = append_batch(
        pool, _one(pid, dev), vec.reshape(1, -1), _one(vid, dev), _one(ver, dev),
        _one(enable, dev), inplace=inplace,
    )
    return pool, ok[0]


def _one(x, dev) -> torch.Tensor:
    """A scalar argument of a single-posting op as a ``(1,)`` tensor."""
    return torch.as_tensor(x, device=dev).reshape(1)


def append_scatter(pool: BlockPool, pids, vecs, vids, vers, enable, *,
                   inplace: bool = False) -> tuple[BlockPool, torch.Tensor]:
    """Vectorised APPEND with the reference's group failure under pool OOM:
    the maintenance round's reassign and merge moves.

    Rows of one posting are ranked in row order (earlier rows win tail
    slots); a row fails at its posting's capacity.  The fresh tail blocks
    of every posting that crosses a block boundary are popped in one
    cumsum-indexed gather; if the free pool cannot cover all of them,
    every row needing a fresh block fails, so each posting still lands a
    contiguous rank prefix.  Without OOM the outcome equals
    :func:`append_batch`.  Returns ``(pool, ok)``."""
    bs = pool.block_size
    cap = pool.posting_capacity
    mb = pool.max_blocks_per_posting
    nb_cap = pool.num_blocks_cap
    en = enable & (pids >= 0)
    safe = torch.clamp(pids.long(), min=0)

    rank = group_rank(safe, pool.num_postings_cap, en)
    slot_g = pool.posting_len.long()[safe] + rank
    ok_cap = en & (slot_g < cap)
    slot = slot_g % bs
    safe_blk = torch.clamp(slot_g // bs, max=mb - 1)
    existing = pool.posting_blocks.long()[safe, safe_blk]

    # one leader row per absent tail block (ranks are contiguous, so every
    # block boundary has a slot == 0 row); all leaders pop at once
    leader = ok_cap & (slot == 0) & (existing < 0)
    n_new = leader.sum()
    have = n_new <= pool.free_top
    lpos = pool.free_top.long() - torch.cumsum(leader.long(), 0)
    new_bid = pool.free_stack.long()[torch.clamp(lpos, 0, nb_cap - 1)]
    posting_blocks = writable(pool.posting_blocks, inplace)
    masked_set_(posting_blocks, (safe, safe_blk), new_bid, leader & have)

    bid = torch.where(existing >= 0, existing, posting_blocks.long()[safe, safe_blk])
    ok = ok_cap & (bid >= 0)
    pool = _append_rows(pool, safe, torch.clamp(bid, min=0), slot, slot_g, vecs,
                        vids, vers, ok, inplace)
    return pool.replace(
        posting_blocks=posting_blocks,
        free_top=pool.free_top - torch.where(have, n_new, 0).to(torch.int32),
    ), ok


# ---------------------------------------------------------------------------
# GET — block-table gather (ParallelGET is a batch of these)
# ---------------------------------------------------------------------------

def gather_posting_ids(pool: BlockPool, pid):
    """Metadata-only posting read ``(vids, vers, valid)`` for ``pid`` of
    any shape ``(...)`` → ``(..., cap)``: the reassign NPA re-check reads
    no payload.  Slots past ``posting_len`` are invalid."""
    pid = torch.as_tensor(pid, device=pool.posting_len.device).long()
    safe = torch.clamp(pool.posting_blocks[pid].long(), min=0)     # (..., MB)
    shape = pid.shape + (pool.posting_capacity,)
    vids = pool.block_vid[safe].reshape(shape)
    vers = pool.block_ver[safe].reshape(shape)
    idx = torch.arange(pool.posting_capacity, device=pid.device)
    valid = (idx < pool.posting_len[pid].unsqueeze(-1)) & (vids >= 0)
    return vids, vers, valid


def _payload_rows(pool: BlockPool, pids, payload):
    """``payload[(block, slot)]`` of every capacity slot of ``pids (m,)``:
    ``(m, cap, d)``."""
    safe = torch.clamp(pool.posting_blocks[pids].long(), min=0)    # (m, MB)
    return payload[safe].reshape(pids.shape[0], pool.posting_capacity, -1)


def parallel_get(pool: BlockPool, pids):
    """Paper's ParallelGET: ``pids (m,)`` → ``(vecs (m, cap, d), vids (m,
    cap), vers (m, cap), valid (m, cap))``.  Lossy codecs serve the cold
    exact tier, so maintenance rewrites never add quantisation error."""
    pids = pids.long()
    payload = pool.blocks_exact if pool.blocks_exact is not None else pool.blocks
    return (_payload_rows(pool, pids, payload), *gather_posting_ids(pool, pids))


def gather_posting(pool: BlockPool, pid):
    """One posting read into fixed-capacity buffers (see :func:`parallel_get`)."""
    return tuple(x[0] for x in parallel_get(pool, _one(pid, pool.posting_len.device)))


def gather_postings(pool: BlockPool, pids):
    """Multi-pid bulk GET for the maintenance round; negative pids read
    posting 0 (the caller's enable masks make those rows inert)."""
    return parallel_get(pool, torch.clamp(pids.long(), min=0))


def parallel_get_hot(pool: BlockPool, pids: torch.Tensor):
    """Batched hot-tier posting read: ``pids (m,)`` → ``(vecs (m, cap, d)
    f32 decoded, vids, vers, valid)``.  The oracle search path reads this
    so its distances see the same decoded values as the scan kernels."""
    pids = pids.long()
    scale = pool.post_scale[pids][:, None, None]
    zero = pool.post_zero[pids][:, None, None]
    vecs = pc.decode_payload(pool.codec, _payload_rows(pool, pids, pool.blocks), scale, zero)
    return (vecs, *gather_posting_ids(pool, pids))


def gather_posting_hot(pool: BlockPool, pid: torch.Tensor):
    """One posting's hot-tier read: ``(vecs (cap, d), vids, vers, valid)``."""
    out = parallel_get_hot(pool, pid.reshape(1))
    return tuple(x[0] for x in out)


# ---------------------------------------------------------------------------
# PUT / DELETE — bulk posting rewrite and free
# ---------------------------------------------------------------------------

def free_postings(pool: BlockPool, pids, enable, *, inplace: bool = False) -> BlockPool:
    """Release every block of ``k`` DISTINCT postings and empty them (the
    round's retire and GC path).  Freed block ids are pushed in row-major
    (posting, block) order; disabled rows and absent blocks are inert."""
    enable = enable & (pids >= 0)
    safe = torch.clamp(pids.long(), min=0)
    bids = pool.posting_blocks[safe].long()            # (k, MB)
    flat_do = (enable[:, None] & (bids >= 0)).reshape(-1)
    flat_bids = torch.clamp(bids.reshape(-1), min=0)
    nb_cap = pool.num_blocks_cap
    pos = pool.free_top.long() + torch.cumsum(flat_do.long(), 0) - 1
    free_stack = masked_set_(writable(pool.free_stack, inplace),
                             torch.clamp(pos, 0, nb_cap - 1), flat_bids, flat_do)
    block_vid = masked_set_(writable(pool.block_vid, inplace), flat_bids, -1, flat_do)
    dirty = masked_set_(writable(pool.dirty, inplace), flat_bids, True, flat_do)
    return pool.replace(
        free_stack=free_stack,
        free_top=pool.free_top + flat_do.sum().to(torch.int32),
        block_vid=block_vid,
        dirty=dirty,
        posting_blocks=masked_set_(writable(pool.posting_blocks, inplace), safe, -1, enable),
        posting_len=masked_set_(writable(pool.posting_len, inplace), safe, 0, enable),
        post_scale=masked_set_(writable(pool.post_scale, inplace), safe, 1.0, enable),
        post_zero=masked_set_(writable(pool.post_zero, inplace), safe, 0.0, enable),
    )


def free_posting(pool: BlockPool, pid, enable, *, inplace: bool = False) -> BlockPool:
    """Release all blocks of ``pid`` to the free pool and empty it."""
    dev = pool.posting_len.device
    return free_postings(pool, _one(pid, dev), _one(enable, dev), inplace=inplace)


def _put(pool: BlockPool, pids, vecs, vids, vers, ns, enable, *,
         whole_blocks: bool, inplace: bool) -> tuple[BlockPool, torch.Tensor]:
    """PUT of ``k`` DISTINCT postings: free their old blocks, pop
    ``ceil(n/BS)`` fresh ones each (LIFO, first come first served: once
    the cumulative demand exceeds the free pool, that row and every later
    enabled row fail and are left empty), write, set the lengths and
    retrain the quant params from the rows written.  ``whole_blocks``
    writes every payload slot of a fresh block from the buffer, as the
    batched reference does; otherwise slots past ``n`` keep what the block
    held, as its single-posting PUT does."""
    k, cap, d = vecs.shape
    if cap != pool.posting_capacity:
        raise ValueError(f"buffer capacity {cap} != posting capacity {pool.posting_capacity}")
    mb, bs = pool.max_blocks_per_posting, pool.block_size
    nb_cap = pool.num_blocks_cap
    dev = vecs.device
    enable = enable & (pids >= 0)
    safe = torch.clamp(pids.long(), min=0)
    pool = free_postings(pool, pids, enable, inplace=inplace)

    ns = ns.long()
    need = torch.where(enable, (ns + bs - 1) // bs, 0)
    ok = enable & (torch.cumsum(need, 0) <= pool.free_top)
    used = torch.where(ok, need, 0)
    off = torch.cumsum(used, 0) - used                  # exclusive
    i_idx = torch.arange(mb, device=dev)[None, :]
    in_use = ok[:, None] & (i_idx < need[:, None])      # (k, MB)
    pos = pool.free_top.long() - 1 - (off[:, None] + i_idx)
    bids = torch.where(in_use, pool.free_stack.long()[torch.clamp(pos, 0, nb_cap - 1)], -1)

    row_valid = torch.arange(cap, device=dev)[None, :] < ns[:, None]
    scale, zero = pc.train_scale_zero(vecs, row_valid)   # (k,)
    enc = pc.encode_payload(pool.codec, vecs, scale[:, None, None],
                            zero[:, None, None], pool.blocks.dtype)
    in_range = (i_idx[..., None] * bs + torch.arange(bs, device=dev)) < ns[:, None, None]
    flat_b = torch.clamp(bids, min=0).reshape(-1)       # (k*MB,)
    flat_use = in_use.reshape(-1)
    if whole_blocks:
        at, rows, m = flat_b, (k * mb, bs, d), flat_use
    else:
        at = (flat_b.repeat_interleave(bs), torch.arange(bs, device=dev).repeat(k * mb))
        rows, m = (k * mb * bs, d), (in_use[..., None] & in_range).reshape(-1)
    blocks = masked_set_(writable(pool.blocks, inplace), at, enc.reshape(rows), m)
    blocks_exact = pool.blocks_exact
    if blocks_exact is not None:
        blocks_exact = masked_set_(writable(blocks_exact, inplace), at,
                                   vecs.float().reshape(rows), m)
    vid_b = torch.where(in_range, vids.reshape(k, mb, bs), -1).reshape(k * mb, bs)
    ver_b = torch.where(in_range, vers.reshape(k, mb, bs), 0).reshape(k * mb, bs)
    block_vid = masked_set_(writable(pool.block_vid, inplace), flat_b, vid_b, flat_use)
    block_ver = masked_set_(writable(pool.block_ver, inplace), flat_b, ver_b, flat_use)
    posting_blocks = masked_set_(writable(pool.posting_blocks, inplace), safe, bids, ok)
    return pool.replace(
        blocks=blocks,
        blocks_exact=blocks_exact,
        block_vid=block_vid,
        block_ver=block_ver,
        posting_blocks=posting_blocks,
        posting_len=masked_set_(writable(pool.posting_len, inplace), safe, ns, ok),
        free_top=pool.free_top - used.sum().to(torch.int32),
        dirty=masked_set_(writable(pool.dirty, inplace), flat_b, True, flat_use),
        post_scale=masked_set_(writable(pool.post_scale, inplace), safe, scale, ok),
        post_zero=masked_set_(writable(pool.post_zero, inplace), safe, zero, ok),
    ), ok


def put_postings(pool: BlockPool, pids, vecs, vids, vers, ns, enable, *,
                 inplace: bool = False) -> tuple[BlockPool, torch.Tensor]:
    """Batched PUT: bulk-write ``k`` DISTINCT postings in one scatter (the
    round's half-writes and GC write-backs).  ``vecs (k, cap, d)``,
    ``vids`` / ``vers (k, cap)``; row ``j`` writes its first ``ns[j]``
    entries.  Returns ``(pool, ok (k,))``; a row that does not fit the
    free pool fails cleanly (posting left empty) and the drain retries."""
    return _put(pool, pids, vecs, vids, vers, ns, enable, whole_blocks=True,
                inplace=inplace)


def put_posting(pool: BlockPool, pid, vecs, vids, vers, n, enable, *,
                inplace: bool = False) -> tuple[BlockPool, torch.Tensor]:
    """Bulk-write one posting (paper PUT) from ``(cap, ...)`` buffers whose
    first ``n`` entries are meaningful.  Returns ``(pool, ok)``."""
    dev = pool.posting_len.device
    pool, ok = _put(pool, _one(pid, dev), vecs[None], vids[None], vers[None],
                    _one(n, dev), _one(enable, dev), whole_blocks=False, inplace=inplace)
    return pool, ok[0]


def used_blocks(pool: BlockPool) -> torch.Tensor:
    """Number of allocated blocks (resource accounting, paper Fig. 7d)."""
    return pool.num_blocks_cap - pool.free_top
