"""Port vs reference for the seven kernels and their ops.

On the CPU each kernel wrapper runs its plain PyTorch version; the
reference's Pallas kernels run in interpret mode, as the reference's own
kernel tests run them.  The CUDA kernels themselves are held against the
same plain versions on the card by ``tests/test_torch_cuda.py`` (skipped
where there is no card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_topk.kernel import l2_topk_tiles as r_tiles
from repro.kernels.l2_topk.ops import l2_topk as r_l2_topk
from repro.kernels.posting_scan import kernel as RK
from repro.kernels.posting_scan import ops as rops
from repro_torch.kernels.l2_topk import kernel as TLK
from repro_torch.kernels.l2_topk.ops import l2_topk
from repro_torch.kernels.l2_topk.ref import l2_topk_ref
from repro_torch.kernels.posting_scan import kernel as TK
from repro_torch.kernels.posting_scan import ops as tops
from repro.kernels.posting_scan import ref as rref
from repro_torch.kernels.posting_scan import ref as tref
from repro_torch.kernels.posting_scan.ref import (
    scan_batched_topk_ref,
    scan_per_query_topk_ref,
)

BIG = 3.0e38
# The f32 expansion ||q||^2 - 2q.x + ||x||^2 cancels to ~eps * ||q||^2 and
# the implementations sum in different orders: 1e-4 absolute on unit-scale
# data, plus 1e-5 relative for the byte-scale (int8) payloads.
TOL = 1e-4
RTOL = 1e-5


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def assert_tie_tolerant(d0, i0, d1, i1, tol=TOL, rtol=RTOL):
    """Distances close; index mismatches only where the two report a
    distance tie within the tolerance.  Dead candidates (>= BIG/2) must be
    dead in both and may carry any index."""
    d0, d1, i0, i1 = map(np.asarray, (d0, d1, i0, i1))
    live = d0 < BIG / 2
    assert ((d1 < BIG / 2) == live).all()
    np.testing.assert_allclose(d0[live], d1[live], rtol=rtol, atol=tol)
    bad = (i0 != i1) & live
    gap = tol + rtol * np.abs(d0)
    assert (np.abs(d0 - d1)[bad] <= gap[bad]).all(), (i0[bad], i1[bad])


# ---------------------------------------------------------------------------
# l2_topk (centroid navigation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_n,p_n,d,k", [
    (5, 300, 16, 8),       # ragged Q, ragged P (one padded tile)
    (33, 1100, 12, 4),     # several 512 tiles, last one ragged
    (1, 64, 8, 64),        # k == P
    (17, 700, 32, 20),
])
def test_l2_topk_matches_reference(rng, q_n, p_n, d, k):
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    c = rng.normal(size=(p_n, d)).astype(np.float32)
    c[1::7] = c[0]                          # exact duplicate centroids: ties
    valid = rng.random(size=p_n) < 0.8
    valid[0] = True
    rd, ri = r_l2_topk(jnp.asarray(q), jnp.asarray(c), jnp.asarray(valid),
                       k=k, interpret=True)
    td, ti = l2_topk(t(q), t(c), t(valid), k=k)
    assert ti.dtype == torch.int32
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    # the duplicates tie exactly in both: lowest index first, same ids
    ref_d, ref_i = l2_topk_ref(t(q), t(c), t(valid), k=k)
    assert_tie_tolerant(ref_d.numpy(), ref_i.numpy(), td.numpy(), ti.numpy())
    assert (ti.numpy()[td.numpy() >= BIG / 2] == -1).all()


def test_l2_topk_all_invalid_and_few_valid(rng):
    q = rng.normal(size=(3, 8)).astype(np.float32)
    c = rng.normal(size=(130, 8)).astype(np.float32)
    valid = np.zeros(130, bool)
    valid[[5, 77]] = True
    td, ti = l2_topk(t(q), t(c), t(valid), k=4)
    rd, ri = r_l2_topk(jnp.asarray(q), jnp.asarray(c), jnp.asarray(valid),
                       k=4, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert set(ti.numpy()[:, :2].reshape(-1).tolist()) <= {5, 77}
    assert (ti.numpy()[:, 2:] == -1).all()


@pytest.mark.parametrize("block_p,k", [(128, 5), (256, 16), (512, 64)])
def test_l2_topk_tiles_plain_matches_pallas(rng, block_p, k):
    q = rng.normal(size=(16, 24)).astype(np.float32)
    c = rng.normal(size=(2 * block_p, 24)).astype(np.float32)
    csq = np.sum(c * c, axis=1)
    csq[::3] = BIG
    rd, ri = r_tiles(jnp.asarray(q), jnp.asarray(c), jnp.asarray(csq[None]),
                     k=k, block_q=8, block_p=block_p, interpret=True)
    td, ti = TLK.l2_topk_tiles(t(q), t(c), t(csq[None]), k=k, block_p=block_p)
    assert td.shape == (16, 2 * k) and ti.dtype == torch.int32
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())


@pytest.mark.parametrize("block_p,k,distinct", [(128, 20, 8), (64, 10, 4), (512, 40, 16), (128, 1, 2)])
def test_l2_topk_tiles_plain_matches_pallas_on_ties(rng, block_p, k, distinct):
    """Centroids repeat a few distinct rows, so every tile holds each
    distance many times and the k-th value is shared by more columns than
    are kept: both keep the lowest indices.  Integer data keeps every sum
    exact, so the two agree index for index."""
    q = rng.integers(-3, 4, size=(9, 24)).astype(np.float32)
    c = rng.integers(-3, 4, size=(distinct, 24)).astype(np.float32)[np.arange(2 * block_p) % distinct]
    csq = np.sum(c * c, axis=1)
    rd, ri = r_tiles(jnp.asarray(q), jnp.asarray(c), jnp.asarray(csq[None]),
                     k=k, block_q=9, block_p=block_p, interpret=True)
    td, ti = TLK.l2_topk_tiles(t(q), t(c), t(csq[None]), k=k, block_p=block_p)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    d = td.numpy().reshape(9, 2, k)
    kth = d[..., -1:]                       # the k-th value of each tile
    n_at_kth = (np.sum(q * q, 1)[:, None, None] - 2 * (q @ c.T).reshape(9, 2, block_p)
                + csq.reshape(1, 2, block_p)) == kth
    assert (n_at_kth.sum(-1) > (d == kth).sum(-1)).any()   # ties straddle the k-th


def test_l2_topk_tiles_rejects_bad_tiling(rng):
    q = t(rng.normal(size=(4, 8)).astype(np.float32))
    c = t(rng.normal(size=(100, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        TLK.l2_topk_tiles(q, c, torch.zeros(1, 100), k=4, block_p=100)


# ---------------------------------------------------------------------------
# fused paged scans (both schedules)
# ---------------------------------------------------------------------------

def _payload(rng, shape, dtype):
    if dtype == "int8":
        x = rng.integers(-127, 128, size=shape).astype(np.int8)
        return jnp.asarray(x), t(x), 1.0 / 64     # scale the queries to match
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        r = jnp.asarray(x, jnp.bfloat16)
        return r, t(np.asarray(r.astype(jnp.float32))).to(torch.bfloat16), 1.0
    return jnp.asarray(x), t(x), 1.0


DTYPES = ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb,k", [
    (4, 32, 8, 16, 6, 4),
    (3, 16, 8, 32, 5, 8),
    (2, 24, 32, 100, 3, 10),   # the spfresh-1b page geometry
])
def test_scan_per_query_topk_matches(rng, dtype, q_n, n_blocks, bs, d, nb, k):
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    table = rng.integers(-1, n_blocks, size=(q_n, nb)).astype(np.int32)
    table[0, 0] = -1                                    # an absent page
    live = rng.random(size=(q_n, nb, bs)) < 0.7
    live[-1, -1] = False                                # an all-dead page
    rd, ri = rops.scan_posting_blocks_topk(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(live), rblk,
        k=k, interpret=True,
    )
    td, ti = tops.scan_posting_blocks_topk(t(q), t(table), t(live), tblk, k=k)
    assert td.shape == (q_n, nb, k) and ti.dtype == torch.int32
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    assert (td.numpy()[0, 0] >= BIG / 2).all()
    assert (td.numpy()[-1, -1] >= BIG / 2).all()
    # the plain version against the diff² oracle on the same candidates
    bias = np.where(live & (table >= 0)[..., None], 0.0, BIG).astype(np.float32)
    od, oi = scan_per_query_topk_ref(t(np.maximum(table, 0)), t(q), tblk, t(bias), k)
    assert_tie_tolerant(od.numpy(), oi.numpy(), td.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb,k", [
    (4, 32, 8, 16, 6, 4),
    (9, 64, 16, 32, 12, 10),
    (5, 24, 32, 100, 7, 10),
])
def test_scan_batched_topk_matches(rng, dtype, q_n, n_blocks, bs, d, nb, k):
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    uniq = np.sort(rng.choice(n_blocks, size=nb, replace=False)).astype(np.int32)
    uniq[-2:] = -1                                      # budget padding
    live = rng.random(size=(nb, bs)) < 0.7
    live[0] = False                                     # an all-dead page
    rd, ri = rops.scan_unique_blocks_topk(
        jnp.asarray(q), jnp.asarray(uniq), jnp.asarray(live), rblk,
        k=k, interpret=True,
    )
    td, ti = tops.scan_unique_blocks_topk(t(q), t(uniq), t(live), tblk, k=k)
    assert td.shape == (nb, q_n, k)
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    assert (td.numpy()[-2:] >= BIG / 2).all() and (td.numpy()[0] >= BIG / 2).all()
    bias = np.where(live & (uniq >= 0)[:, None], 0.0, BIG).astype(np.float32)
    od, oi = scan_batched_topk_ref(t(np.maximum(uniq, 0)), t(q), tblk, t(bias), k)
    assert_tie_tolerant(od.numpy(), oi.numpy(), td.numpy(), ti.numpy())


def test_scan_plain_versions_match_pallas_kernels(rng):
    """The kernel-level wrappers against the reference kernels directly."""
    blocks = rng.normal(size=(16, 8, 12)).astype(np.float32)
    q = rng.normal(size=(3, 12)).astype(np.float32)
    table = rng.integers(0, 16, size=(3, 4)).astype(np.int32)
    bias = np.where(rng.random(size=(3, 4, 8)) < 0.3, BIG, 0.0).astype(np.float32)
    rd, ri = RK.scan_per_query_topk(jnp.asarray(table), jnp.asarray(q),
                                    jnp.asarray(blocks), jnp.asarray(bias),
                                    k=5, interpret=True)
    td, ti = TK.scan_per_query_topk(t(table), t(q), t(blocks), t(bias), k=5)
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    ids = np.array([3, 0, 9], np.int32)
    ub = bias[0, :3]
    rd, ri = RK.scan_batched_topk(jnp.asarray(ids), jnp.asarray(q),
                                  jnp.asarray(blocks), jnp.asarray(ub),
                                  k=5, interpret=True)
    td, ti = TK.scan_batched_topk(t(ids), t(q), t(blocks), t(ub), k=5)
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", DTYPES + ["q8"])
@pytest.mark.parametrize("bs,k", [(32, 10), (32, 32), (8, 1)])
def test_scan_batched_topk_dead_page_is_big_and_slot_order(rng, dtype, bs, k):
    """A page whose every slot is dead gives exactly float32(3e38) for all
    k candidates in the plain version and in the reference kernel alike,
    and slots 0..k-1 in the plain version: the candidates the CUDA
    kernel's dead-page skip writes without scoring.  (The reference's
    min/mask loop masks a taken slot with the same BIG, so it names slot 0
    k times; no consumer reads the slot of a dead candidate.)  ``q8`` is
    ``scan_batched_topk_q8`` over int8 codes with per-page (scale, zero)."""
    rblk, tblk, s = _payload(rng, (12, bs, 100), "int8" if dtype == "q8" else dtype)
    q = (rng.normal(size=(5, 100)) / s).astype(np.float32)
    ids = rng.integers(0, 12, size=7).astype(np.int32)
    bias = np.where(rng.random(size=(7, bs)) < 0.3, BIG, 0.0).astype(np.float32)
    dead = [0, 3, 6]
    bias[dead] = BIG
    if dtype == "q8":
        sz = np.stack([rng.uniform(0.05, 0.5, size=7), 20 * rng.normal(size=7)],
                      axis=-1).astype(np.float32)
        rd, ri = RK.scan_batched_topk_q8(jnp.asarray(ids), jnp.asarray(q), rblk,
                                         jnp.asarray(bias), jnp.asarray(sz), k=k, interpret=True)
        td, ti = TK.scan_batched_topk_q8(t(ids), t(q), tblk, t(bias), t(sz), k=k)
    else:
        rd, ri = RK.scan_batched_topk(jnp.asarray(ids), jnp.asarray(q), rblk,
                                      jnp.asarray(bias), k=k, interpret=True)
        td, ti = TK.scan_batched_topk(t(ids), t(q), tblk, t(bias), k=k)
    want_d = np.full((len(dead), 5, k), np.float32(BIG), np.float32)
    want_i = np.broadcast_to(np.arange(k, dtype=np.int32), (len(dead), 5, k))
    np.testing.assert_array_equal(np.asarray(rd)[dead], want_d)
    np.testing.assert_array_equal(td.numpy()[dead], want_d)
    np.testing.assert_array_equal(ti.numpy()[dead], want_i)
    assert ((np.asarray(ri)[dead] >= 0) & (np.asarray(ri)[dead] < bs)).all()
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", DTYPES + ["q8"])
@pytest.mark.parametrize("bs,k", [(32, 10), (32, 32), (8, 1)])
def test_scan_per_query_topk_dead_pair_is_big_and_slot_order(rng, dtype, bs, k):
    """A (query, page) pair whose every slot is dead gives exactly
    float32(3e38) for all k candidates in the port's plain version and in
    the reference kernel alike, and slots 0..k-1 in the plain version: the
    candidates the CUDA kernel's dead-pair skip writes without loading the
    page.  (The reference's min/mask loop names slot 0 k times there; no
    consumer reads the slot of a dead candidate.)  ``q8`` is
    ``scan_per_query_topk_q8`` over int8 codes with per-pair (scale, zero)."""
    rblk, tblk, s = _payload(rng, (12, bs, 100), "int8" if dtype == "q8" else dtype)
    q = (rng.normal(size=(5, 100)) / s).astype(np.float32)
    table = rng.integers(0, 12, size=(5, 7)).astype(np.int32)
    bias = np.where(rng.random(size=(5, 7, bs)) < 0.3, BIG, 0.0).astype(np.float32)
    dead = (np.array([0, 2, 4]), np.array([0, 3, 6]))
    bias[dead] = BIG
    if dtype == "q8":
        sz = np.stack([rng.uniform(0.05, 0.5, size=(5, 7)), 20 * rng.normal(size=(5, 7))],
                      axis=-1).astype(np.float32)
        rd, ri = RK.scan_per_query_topk_q8(jnp.asarray(table), jnp.asarray(q), rblk,
                                           jnp.asarray(bias), jnp.asarray(sz), k=k,
                                           interpret=True)
        td, ti = TK.scan_per_query_topk_q8(t(table), t(q), tblk, t(bias), t(sz), k=k)
    else:
        rd, ri = RK.scan_per_query_topk(jnp.asarray(table), jnp.asarray(q), rblk,
                                        jnp.asarray(bias), k=k, interpret=True)
        td, ti = TK.scan_per_query_topk(t(table), t(q), tblk, t(bias), k=k)
    want_d = np.full((3, k), np.float32(BIG), np.float32)
    want_i = np.broadcast_to(np.arange(k, dtype=np.int32), (3, k))
    np.testing.assert_array_equal(np.asarray(rd)[dead], want_d)
    np.testing.assert_array_equal(td.numpy()[dead], want_d)
    np.testing.assert_array_equal(ti.numpy()[dead], want_i)
    assert ((np.asarray(ri)[dead] >= 0) & (np.asarray(ri)[dead] < bs)).all()
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())


@pytest.mark.parametrize("bad", ["bs", "k", "d", "dtype"])
def test_scan_wrappers_enforce_the_kernel_contract(rng, bad):
    bs, d, k, dt = 8, 12, 4, torch.float32
    if bad == "bs":
        bs = 40
    elif bad == "k":
        k = 9
    elif bad == "d":
        d = 10
    else:
        dt = torch.float16
    blocks = torch.zeros((4, bs, d), dtype=dt)
    with pytest.raises(ValueError):
        TK.scan_batched_topk(torch.zeros(2, dtype=torch.int32), torch.zeros(3, d),
                             blocks, torch.zeros(2, bs), k=k)


# ---------------------------------------------------------------------------
# the pairs form of #6 and #7: candidates of the probed (page, query) pairs
# only, in the (Q, nbq, k) layout of each query's probe list
# ---------------------------------------------------------------------------

def _probe_table(rng, q_n, nbq, n_blocks):
    """Each query's probed pages, distinct within a row: a shared hot set
    (so pages repeat across queries), absent pages and invalid probes
    (-1), and query 0 with none at all."""
    hot = rng.choice(n_blocks, size=min(n_blocks, 3 * nbq), replace=False)
    table = np.stack([rng.choice(hot, size=nbq, replace=False) for _ in range(q_n)])
    table[rng.random(size=table.shape) < 0.25] = -1
    table[0] = -1
    return table.astype(np.int32)


@pytest.mark.parametrize("budget", ["ample", "overflow"])
@pytest.mark.parametrize("k", [4, 10, 32])
@pytest.mark.parametrize("dtype", DTYPES + ["q8"])
def test_scan_batched_topk_pairs_equal_the_full_gathered(rng, dtype, k, budget):
    """The pairs form (on the CPU its plain version) equals the full
    ``(NB, Q, k)`` output gathered back through ``member_pos``, value for
    value and slot for slot, and ``(BIG, -1)`` where a probe kept no page:
    absent pages, invalid probes, pages past the budget.  Dead pages (every
    slot dead) and the budget's -1 padding rows included; the plain-torch
    oracle, gathered the same way, agrees within the tolerance."""
    q_n, nbq, n_blocks, bs, d = 9, 12, 64, 32, 16
    _, tblk, s = _payload(rng, (n_blocks, bs, d), "int8" if dtype == "q8" else dtype)
    q = t((rng.normal(size=(q_n, d)) / s).astype(np.float32))
    table = t(_probe_table(rng, q_n, nbq, n_blocks))
    n_unique = len(np.unique(table.numpy()[table.numpy() >= 0]))
    cap = n_unique + 3 if budget == "ample" else n_unique - 5
    uniq, member_pos, _, overflow = tops.dedup_pages(table.reshape(-1), budget=cap,
                                                     num_blocks=n_blocks)
    assert int(overflow) == (0 if budget == "ample" else 5)
    mp = member_pos.reshape(q_n, nbq)
    page_pos = tops.page_positions(mp, cap)
    live = t(rng.random(size=(cap, bs)) < 0.7)
    live[1] = False                                     # a dead page
    sz = t(np.stack([rng.uniform(0.05, 0.5, size=cap), 20 * rng.normal(size=cap)],
                    axis=-1).astype(np.float32))
    if dtype == "q8":
        got = tops.scan_unique_blocks_topk_q8_pairs(q, uniq, live, tblk, sz[:, 0], sz[:, 1],
                                                    page_pos, nbq=nbq, k=k)
        full = tops.scan_unique_blocks_topk_q8(q, uniq, live, tblk, sz[:, 0], sz[:, 1], k=k)
        bias = torch.where(live & (uniq >= 0)[:, None], 0.0, BIG)
        want = tref.scan_batched_topk_q8_pairs_ref(torch.clamp(uniq, min=0), q, tblk, bias, sz,
                                                   mp, k)
    else:
        got = tops.scan_unique_blocks_topk_pairs(q, uniq, live, tblk, page_pos, nbq=nbq, k=k)
        full = tops.scan_unique_blocks_topk(q, uniq, live, tblk, k=k)
        bias = torch.where(live & (uniq >= 0)[:, None], 0.0, BIG)
        want = tref.scan_batched_topk_pairs_ref(torch.clamp(uniq, min=0), q, tblk, bias, mp, k)
    assert got[0].shape == got[1].shape == (q_n, nbq, k) and got[1].dtype == torch.int32
    gathered = tref.gather_pairs(*full, mp)
    assert torch.equal(got[0], gathered[0]) and torch.equal(got[1], gathered[1])
    off = mp < 0
    assert bool(off[0].all()) and bool(off.any(dim=1)[1:].any())
    assert bool((got[0][off] == BIG).all()) and bool((got[1][off] == -1).all())
    assert torch.equal(want[1][off], got[1][off])
    dead = mp == 1                                      # probes of the dead page
    assert bool(dead.any()) and bool((got[0][dead] == BIG).all())
    assert torch.equal(got[1][dead], torch.arange(k, dtype=torch.int32).expand(int(dead.sum()), k))
    assert_tie_tolerant(want[0].numpy(), want[1].numpy(), got[0].numpy(), got[1].numpy())


def test_page_positions_invert_member_pos(rng):
    """``page_positions`` holds, for each kept page and query, the row of the
    query's probe list that holds the page, -1 elsewhere; a page twice in
    one row is refused on the CPU."""
    table = _probe_table(rng, 11, 16, 80)
    uniq, member_pos, n_unique, _ = tops.dedup_pages(t(table).reshape(-1), budget=40,
                                                     num_blocks=80)
    mp = member_pos.reshape(11, 16).numpy()
    pos = tops.page_positions(member_pos.reshape(11, 16), 40)
    assert pos.shape == (40, 11) and pos.dtype == torch.int16
    want = np.full((40, 11), -1, np.int16)
    for qi, j in zip(*np.nonzero(mp >= 0)):
        want[mp[qi, j], qi] = j
    np.testing.assert_array_equal(pos.numpy(), want)
    assert int((pos >= 0).sum()) == int((member_pos >= 0).sum())
    twice = torch.tensor([[0, 2, 0], [1, -1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="twice"):
        tops.page_positions(twice, 3)


@pytest.mark.parametrize("bad", ["dtype", "shape", "nbq"])
def test_scan_batched_topk_pairs_enforce_their_contract(bad):
    bs, d, nb, q_n = 8, 12, 3, 5
    page_pos = torch.full((nb, q_n), -1, dtype=torch.int16)
    nbq = 4
    if bad == "dtype":
        page_pos = page_pos.int()
    elif bad == "shape":
        page_pos = page_pos[:, :-1].contiguous()
    else:
        nbq = 40000
    with pytest.raises(ValueError):
        TK.scan_batched_topk_pairs(torch.zeros(nb, dtype=torch.int32), torch.zeros(q_n, d),
                                   torch.zeros(4, bs, d), torch.zeros(nb, bs), page_pos,
                                   nbq=nbq, k=4)


# ---------------------------------------------------------------------------
# unreduced scans (#2 scan_per_query, #3 scan_batched), every payload dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb", [   # tests/test_kernels_posting_scan.py:32
    (4, 32, 8, 16, 6),
    (8, 64, 16, 128, 4),
    (2, 16, 8, 32, 3),
    (1, 8, 4, 8, 1),
])
def test_scan_per_query_matches(rng, dtype, q_n, n_blocks, bs, d, nb):
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    table = rng.integers(0, n_blocks, size=(q_n, nb)).astype(np.int32)
    want = np.asarray(RK.scan_per_query(jnp.asarray(table), jnp.asarray(q), rblk,
                                        interpret=True))
    got = TK.scan_per_query(t(table), t(q), tblk)
    assert got.shape == (q_n, nb, bs) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=TOL)
    # against both direct-diff² oracles (the expansion cancels: a wider
    # tolerance, as the reference's own test states for this comparison)
    oracle = rref.scan_posting_blocks_ref(jnp.asarray(table), jnp.asarray(q), rblk)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=RTOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), tref.scan_posting_blocks_ref(t(table), t(q), tblk).numpy(),
        rtol=RTOL, atol=TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb", [   # tests/test_kernels_posting_scan.py:48
    (4, 32, 8, 16, 6),
    (8, 64, 16, 128, 12),
    (2, 16, 8, 32, 3),
])
def test_scan_batched_matches(rng, dtype, q_n, n_blocks, bs, d, nb):
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    ids = rng.choice(n_blocks, size=nb, replace=False).astype(np.int32)
    want = np.asarray(RK.scan_batched(jnp.asarray(ids), jnp.asarray(q), rblk,
                                      interpret=True))
    got = TK.scan_batched(t(ids), t(q), tblk)
    assert got.shape == (nb, q_n, bs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), tref.scan_unique_blocks_ref(t(ids), t(q), tblk).numpy(),
        rtol=RTOL, atol=TOL)


PADDING = {                                         # -1 rows of an 8-row id list
    "start": [0, 1], "middle": [3, 4, 5], "end": [6, 7], "spread": [0, 4, 7],
    "all": list(range(8)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", sorted(PADDING))
def test_scan_batched_padding_rows_are_big(rng, dtype, where):
    """#3 takes -1 ids as padding and writes their rows as float32(3e38);
    a real id's rows equal the reference's kernel on the clamped ids."""
    n_blocks, bs, d, q_n = 24, 8, 36, 5
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    ids = rng.choice(n_blocks, size=8, replace=False).astype(np.int32)
    pad = np.zeros(8, bool)
    pad[PADDING[where]] = True
    ids[pad] = -1
    got = TK.scan_batched(t(ids), t(q), tblk).numpy()
    assert got.shape == (8, q_n, bs) and got.dtype == np.float32
    assert (got[pad] == np.float32(BIG)).all() and (got[pad] >= BIG / 2).all()
    want = np.asarray(RK.scan_batched(jnp.asarray(np.maximum(ids, 0)), jnp.asarray(q), rblk,
                                      interpret=True))
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=RTOL, atol=TOL)
    assert (got[~pad] < BIG / 2).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["start", "middle", "end", "spread"])
def test_scan_unique_blocks_op_matches_with_padding(rng, dtype, where):
    """The ops wrapper passes the -1 padding ids to #3 as they are and
    still equals the reference's clamp-then-mask wrapper."""
    n_blocks, bs, d, q_n = 16, 4, 12, 3
    rblk, tblk, s = _payload(rng, (n_blocks, bs, d), dtype)
    q = (rng.normal(size=(q_n, d)) / s).astype(np.float32)
    ids = np.sort(rng.choice(n_blocks, size=8, replace=False)).astype(np.int32)
    pad = np.zeros(8, bool)
    pad[PADDING[where]] = True
    ids[pad] = -1
    rd = np.asarray(rops.scan_unique_blocks(jnp.asarray(q), jnp.asarray(ids), rblk,
                                            interpret=True))
    td = tops.scan_unique_blocks(t(q), t(ids), tblk).numpy()
    np.testing.assert_array_equal(td >= BIG / 2, rd >= BIG / 2)
    np.testing.assert_array_equal(td[pad], rd[pad])
    np.testing.assert_allclose(td[~pad], rd[~pad], rtol=RTOL, atol=TOL)


def test_scan_posting_blocks_and_unique_blocks_ops_match(rng):
    """The ops wrappers: block table from posting ids, absent pages and
    padding masked to BIG (tests/test_kernels_posting_scan.py:65,86)."""
    n_blocks, bs, d = 16, 4, 8
    blocks = rng.normal(size=(n_blocks, bs, d)).astype(np.float32)
    q = rng.normal(size=(2, d)).astype(np.float32)
    posting_blocks = np.array([[0, 1, -1, -1], [2, -1, -1, -1], [3, 4, 5, -1]], np.int32)
    pids = np.array([[0, 2], [1, -1]], np.int32)
    rd, rok = rops.scan_posting_blocks(jnp.asarray(q), jnp.asarray(posting_blocks),
                                       jnp.asarray(pids), jnp.asarray(blocks),
                                       interpret=True)
    td, tok = tops.scan_posting_blocks(t(q), t(posting_blocks), t(pids), t(blocks))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
    rd, td = np.asarray(rd), td.numpy()
    live = rd < BIG / 2
    np.testing.assert_array_equal(td < BIG / 2, live)
    np.testing.assert_allclose(td[live], rd[live], rtol=RTOL, atol=TOL)
    ids = np.array([2, 5, -1, -1], np.int32)
    rd = np.asarray(rops.scan_unique_blocks(jnp.asarray(q), jnp.asarray(ids),
                                            jnp.asarray(blocks), interpret=True))
    td = tops.scan_unique_blocks(t(q), t(ids), t(blocks)).numpy()
    assert (td[2:] >= BIG / 2).all()
    np.testing.assert_allclose(td[:2], rd[:2], rtol=RTOL, atol=TOL)


# ---------------------------------------------------------------------------
# int8-code scans (#5 scan_per_query_topk_q8, #7 scan_batched_topk_q8)
# ---------------------------------------------------------------------------

def _q8_inputs(rng, lead, n_blocks, bs, d):
    codes = rng.integers(-127, 128, size=(n_blocks, bs, d)).astype(np.int8)
    q = rng.normal(size=(lead[0], d)).astype(np.float32)
    page_sz = np.stack([rng.uniform(1e-3, 0.1, size=lead[1:]),
                        rng.normal(size=lead[1:])], axis=-1).astype(np.float32)
    return codes, q, page_sz


@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb,k", [   # tests/test_codec.py:123
    (4, 32, 8, 16, 6, 4),
    (2, 16, 8, 32, 3, 8),
    (3, 24, 32, 100, 5, 32),    # the spfresh-1b page, kpage = 32
])
def test_scan_per_query_topk_q8_matches(rng, q_n, n_blocks, bs, d, nb, k):
    codes, q, page_sz = _q8_inputs(rng, (q_n, q_n, nb), n_blocks, bs, d)
    table = rng.integers(0, n_blocks, size=(q_n, nb)).astype(np.int32)
    bias = np.where(rng.random(size=(q_n, nb, bs)) < 0.3, BIG, 0.0).astype(np.float32)
    bias[0, 0] = BIG                                    # an all-dead page
    args = (table, q, codes, bias, page_sz)
    rd, ri = RK.scan_per_query_topk_q8(*map(jnp.asarray, args), k=k, interpret=True)
    td, ti = TK.scan_per_query_topk_q8(*map(t, args), k=k)
    assert td.shape == (q_n, nb, k) and ti.dtype == torch.int32
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    od, oi = rref.scan_per_query_topk_q8_ref(*map(jnp.asarray, args), k=k)
    assert_tie_tolerant(np.asarray(od), np.asarray(oi), td.numpy(), ti.numpy())
    od, oi = tref.scan_per_query_topk_q8_ref(*map(t, args), k=k)
    assert_tie_tolerant(od.numpy(), oi.numpy(), td.numpy(), ti.numpy())


@pytest.mark.parametrize("q_n,n_blocks,bs,d,nb,k", [   # tests/test_codec.py:152
    (4, 32, 8, 16, 6, 4),
    (8, 64, 16, 128, 5, 8),
    (5, 24, 32, 100, 7, 32),
])
def test_scan_batched_topk_q8_matches(rng, q_n, n_blocks, bs, d, nb, k):
    codes, q, page_sz = _q8_inputs(rng, (q_n, nb), n_blocks, bs, d)
    ids = rng.choice(n_blocks, size=nb, replace=False).astype(np.int32)
    bias = np.where(rng.random(size=(nb, bs)) < 0.3, BIG, 0.0).astype(np.float32)
    bias[-1] = BIG
    args = (ids, q, codes, bias, page_sz)
    rd, ri = RK.scan_batched_topk_q8(*map(jnp.asarray, args), k=k, interpret=True)
    td, ti = TK.scan_batched_topk_q8(*map(t, args), k=k)
    assert td.shape == (nb, q_n, k)
    assert_tie_tolerant(np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy())
    od, oi = rref.scan_batched_topk_q8_ref(*map(jnp.asarray, args), k=k)
    assert_tie_tolerant(np.asarray(od), np.asarray(oi), td.numpy(), ti.numpy())
    od, oi = tref.scan_batched_topk_q8_ref(*map(t, args), k=k)
    assert_tie_tolerant(od.numpy(), oi.numpy(), td.numpy(), ti.numpy())


@pytest.mark.parametrize("bs", [32, 8])
def test_scan_batched_topk_q8_ties_at_k_equal_bs(rng, bs):
    """k = BS (the int8 cell's kpage = min(10 * 4, BS)) on pages whose slot
    j repeats code row j % 4, the four rows 24 code units apart on column
    0.  Integer queries, power-of-two scales and integer zeros make every
    distance exact in f32, so the port's plain version and the reference's
    Pallas kernel give equal values, equal slots where distances are
    distinct, and among ties the lowest slot first; the reference names
    a dead candidate's slot arbitrarily, so slots are held on live
    candidates."""
    nb, q_n, d, k = 6, 5, 100, bs
    base = rng.integers(-20, 21, size=(10, 4, d)).astype(np.int8)
    base[:, :, 0] = np.arange(4) * 24 - 36
    codes = np.ascontiguousarray(base[:, np.arange(bs) % 4])
    q = rng.integers(-8, 9, size=(q_n, d)).astype(np.float32)
    ids = rng.choice(10, size=nb, replace=False).astype(np.int32)
    bias = np.where(rng.random(size=(nb, bs)) < 0.2, BIG, 0.0).astype(np.float32)
    sz = np.stack([rng.choice([0.5, -0.25, 1.0, 2.0], size=nb),
                   rng.integers(-20, 21, size=nb)], axis=-1).astype(np.float32)
    args = (ids, q, codes, bias, sz)
    rd, ri = RK.scan_batched_topk_q8(*map(jnp.asarray, args), k=k, interpret=True)
    td, ti = TK.scan_batched_topk_q8(*map(t, args), k=k)
    rd, ri, td, ti = np.asarray(rd), np.asarray(ri), td.numpy(), ti.numpy()
    np.testing.assert_array_equal(td, rd)
    live = td < BIG / 2
    np.testing.assert_array_equal(ti[live], ri[live])
    # ties are present, and the port keeps them lowest slot first
    assert ((td[..., 1:] == td[..., :-1]) & live[..., 1:]).any()
    step_d, step_i = np.diff(td, axis=-1), np.diff(ti, axis=-1)
    assert ((step_d > 0) | ((step_d == 0) & (step_i > 0))).all()
    # every slot once per (page, query): the dead ones after the live, in order
    np.testing.assert_array_equal(np.sort(ti, axis=-1),
                                  np.broadcast_to(np.arange(bs, dtype=np.int32), ti.shape))


@pytest.mark.parametrize("schedule", ["per_query", "batched"])
def test_q8_wrapper_equals_fp32_wrapper_over_decoded_pages(rng, schedule):
    """The q8 ops wrapper over codes equals the fp32 wrapper over the
    payload decoded page by page under each page's own parameters
    (tests/test_codec.py:181): the dequant is the only difference."""
    n_blocks, bs, d, q_n, nb, k = 16, 8, 16, 3, 4, 4
    codes = rng.integers(-127, 128, size=(n_blocks, bs, d)).astype(np.int8)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if schedule == "per_query":
        table = rng.integers(-1, n_blocks, size=(q_n, nb)).astype(np.int32)
        lead = (q_n, nb)
        live = rng.random(size=(q_n, nb, bs)) < 0.8
    else:
        table = np.sort(rng.choice(n_blocks, size=nb, replace=False)).astype(np.int32)
        table[-1] = -1
        lead = (nb,)
        live = rng.random(size=(nb, bs)) < 0.8
    scale = rng.uniform(1e-3, 0.05, size=lead).astype(np.float32)
    zero = rng.normal(size=lead).astype(np.float32)
    # decode each probed page under its own parameters into a pool of its
    # own, page i of the flattened table at block i
    dec = (codes[np.maximum(table, 0)].astype(np.float32)
           * scale[..., None, None] + zero[..., None, None])
    own = np.where(table >= 0, np.arange(table.size).reshape(table.shape), -1)
    own = own.astype(np.int32)
    pool = t(dec.reshape(-1, bs, d))
    if schedule == "per_query":
        got = tops.scan_posting_blocks_topk_q8(t(q), t(table), t(live), t(codes),
                                               t(scale), t(zero), k=k)
        want = tops.scan_posting_blocks_topk(t(q), t(own), t(live), pool, k=k)
    else:
        got = tops.scan_unique_blocks_topk_q8(t(q), t(table), t(live), t(codes),
                                              t(scale), t(zero), k=k)
        want = tops.scan_unique_blocks_topk(t(q), t(own), t(live), pool, k=k)
    assert_tie_tolerant(want[0].numpy(), want[1].numpy(), got[0].numpy(), got[1].numpy())


def test_q8_wrappers_take_int8_codes_only(rng):
    blocks = torch.zeros((4, 8, 12), dtype=torch.float32)
    with pytest.raises(ValueError):
        TK.scan_batched_topk_q8(torch.zeros(2, dtype=torch.int32), torch.zeros(3, 12),
                                blocks, torch.zeros(2, 8), torch.ones(2, 2), k=4)
    with pytest.raises(ValueError):                     # page_sz shape
        TK.scan_batched_topk_q8(torch.zeros(2, dtype=torch.int32), torch.zeros(3, 12),
                                blocks.to(torch.int8), torch.zeros(2, 8),
                                torch.ones(3, 2), k=4)


# ---------------------------------------------------------------------------
# dedup_pages (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(6))
def test_dedup_pages_matches_exactly(rng, trial):
    n_blocks = int(rng.integers(8, 64))
    n = int(rng.integers(4, 128))
    budget = int(rng.integers(1, 24)) if trial % 2 else 2 * n   # overflow / not
    pages = rng.integers(-1, n_blocks, size=n).astype(np.int32)
    want = rops.dedup_pages(jnp.asarray(pages), budget=budget, num_blocks=n_blocks)
    got = tops.dedup_pages(t(pages), budget=budget, num_blocks=n_blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
