"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode).  The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import lire
from repro_torch.core.index import SPFreshIndex
from repro_torch.core.types import LireConfig
from repro_torch.kernels.l2_topk import kernel as LK
from repro_torch.kernels.posting_scan import kernel as SK
from repro_torch.utils.tree import map_tensors

pytestmark = pytest.mark.cuda

# cuBLAS is deterministic under torch.use_deterministic_algorithms only with
# a fixed workspace, read when CUDA starts (the training restart below)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

BIG = 3.0e38


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def assert_kmin_close(kd, ki, pd, pi, *, atol=1e-4, rtol=1e-5):
    """Kernel vs plain: live distances close, dead in both, index
    mismatches only at distance ties (f32 sums in another order)."""
    kd, ki, pd, pi = (x.cpu().numpy() for x in (kd, ki, pd, pi))
    live = pd < BIG / 2
    assert ((kd < BIG / 2) == live).all()
    np.testing.assert_allclose(kd[live], pd[live], rtol=rtol, atol=atol)
    swap = (ki != pi) & live
    assert (np.abs(kd - pd)[swap] <= atol + rtol * np.abs(pd[swap])).all()


def _blocks(gen, n, bs, d, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n, bs, d), generator=gen, dtype=torch.int8).to(dev)
    return torch.randn(n, bs, d, generator=gen).to(dtype).to(dev)


@pytest.mark.parametrize("q_n,p_n,block_p,k,d", [
    (37, 1024, 512, 64, 100), (5, 384, 128, 5, 16), (64, 512, 512, 1, 8),
])
def test_l2_topk_tiles_kernel_matches_plain(card, q_n, p_n, block_p, k, d):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(q_n, d, generator=gen).to(card)
    c = torch.randn(p_n, d, generator=gen).to(card)
    c[1::9] = c[0]                                   # exact ties
    csq = torch.sum(c * c, dim=1)
    csq[::4] = BIG
    csq = csq[None].contiguous()
    before = LK.LAUNCHES["l2_topk_tiles"]
    kd, ki = LK.l2_topk_tiles(q, c, csq, k=k, block_p=block_p)
    torch.cuda.synchronize()
    assert LK.LAUNCHES["l2_topk_tiles"] == before + 1
    assert_kmin_close(kd, ki, *LK.l2_topk_tiles_plain(q, c, csq, k=k, block_p=block_p))


def _tile_inputs(case, q_n, p_n, gen):
    """Navigation inputs at unit scale (d=16) for the edge cases of the
    tile k-min: exact ties across the k-th value, distances below zero,
    a tile masked whole."""
    d = 16
    c = torch.randn(p_n, d, generator=gen) * 0.5
    q = torch.randn(q_n, d, generator=gen) * 0.5
    if case == "ties":                      # 8 distinct centroids, repeated
        c = c[torch.arange(p_n) % 8]
    csq = torch.sum(c * c, dim=1)
    if case == "negative":                  # d = ||q - c||^2 - 0.5
        q = c[torch.randint(0, p_n, (q_n,), generator=gen)] + 0.01 * q
        csq = csq - 0.5
    if case == "all_big":                   # the first tile masked whole
        csq[: p_n // 2] = BIG
    return q, c, csq[None].contiguous()


@pytest.mark.parametrize("case,q_n,p_n,block_p,k", [
    ("ties", 37, 1024, 512, 64), ("ties", 37, 1024, 512, 50), ("ties", 40, 256, 128, 128),
    ("ties", 33, 128, 64, 1),
    ("negative", 45, 512, 256, 16), ("negative", 7, 128, 64, 64),
    ("all_big", 70, 1024, 512, 512), ("all_big", 9, 256, 128, 3),
])
def test_l2_topk_tiles_kernel_edge_cases(card, case, q_n, p_n, block_p, k):
    gen = torch.Generator().manual_seed(4)
    q, c, csq = (x.to(card) for x in _tile_inputs(case, q_n, p_n, gen))
    kd, ki = LK.l2_topk_tiles(q, c, csq, k=k, block_p=block_p)
    torch.cuda.synchronize()
    pd, pi = LK.l2_topk_tiles_plain(q, c, csq, k=k, block_p=block_p)
    assert_kmin_close(kd, ki, pd, pi)
    # each tile's candidates ascend by (value, index)
    t = p_n // block_p
    kd3, ki3 = kd.reshape(q_n, t, k).cpu(), ki.reshape(q_n, t, k).cpu()
    step_d, step_i = kd3[..., 1:] - kd3[..., :-1], ki3[..., 1:] - ki3[..., :-1]
    assert bool(((step_d > 0) | ((step_d == 0) & (step_i > 0))).all())
    if case == "ties":
        # the 8 distinct distances of a query lie well apart and duplicates
        # are bit-equal, so the kept columns (the lowest of each tie, also
        # where the k-th value is cut) are the plain version's, index for index
        u = c[:8].double().cpu()
        dist = torch.sort(((q.double().cpu()[:, None] - u[None]) ** 2).sum(-1), dim=1).values
        assert float((dist[:, 1:] - dist[:, :-1]).min()) > 1e-4
        assert torch.equal(ki.cpu(), pi.cpu())
    if case == "negative":
        assert bool((kd.min(dim=1).values < 0).all())   # each query's own centroid
    if case == "all_big":
        assert bool((kd[:, :k] >= BIG / 2).all())


def _page_sz(gen, n, *, far_zero=False):
    """Per-page (scale, zero): scales of both signs, and with ``far_zero``
    zeros far from 0 against the code range."""
    scale = (torch.rand(n, generator=gen) * 0.5 + 0.05) * torch.where(
        torch.rand(n, generator=gen) < 0.3, -1.0, 1.0)
    zero = torch.randn(n, generator=gen) * 20
    if far_zero:
        zero[::2] = 500.0 * torch.where(torch.rand(len(zero[::2]), generator=gen) < 0.5, -1.0, 1.0)
    return torch.stack([scale, zero], dim=-1).contiguous()


def _batched_topk(form, ids, q, blocks, bias, sz, k):
    """The kernel and the plain version of #6 (``form`` a dtype) or #7
    (``form`` "q8"): ``((kd, ki), (pd, pi), launches counted)``."""
    name = "scan_batched_topk_q8" if form == "q8" else "scan_batched_topk"
    args = (ids, q, blocks, bias, sz) if form == "q8" else (ids, q, blocks, bias)
    before = SK.LAUNCHES[name]
    got = getattr(SK, name)(*args, k=k)
    torch.cuda.synchronize()
    return got, getattr(SK, name + "_plain")(*args, k=k), SK.LAUNCHES[name] - before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, "q8"])
@pytest.mark.parametrize("bs,k", [(32, 32), (32, 10), (32, 1), (8, 8)])
def test_scan_batched_topk_kernel_dead_pages(card, dtype, bs, k):
    """All-dead pages at the start, middle and end of the id list, pages
    with one live slot, Q not a multiple of the 64-query tile; a dead page
    gives exactly (float32(3e38), slots 0..k-1).  ``q8`` is #7 over int8
    codes with per-page (scale, zero)."""
    gen = torch.Generator().manual_seed(5)
    codes = dtype == "q8"
    blocks = _blocks(gen, 64, bs, 100, torch.int8 if codes else dtype, card)
    q_n = 70
    q = (torch.randn(q_n, 100, generator=gen) * (1 if dtype in (torch.float32, torch.bfloat16)
                                                 else 64)).to(card)
    ids = torch.randint(0, 64, (21,), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(21, bs, generator=gen) < 0.3, BIG, 0.0)
    dead = [0, 10, 20]
    bias[dead] = BIG
    for page in (3, 12):                    # one live slot
        bias[page] = BIG
        bias[page, bs // 2] = 0.0
    bias = bias.to(card).contiguous()
    sz = _page_sz(gen, 21).to(card)
    (kd, ki), plain, launched = _batched_topk(dtype, ids, q, blocks, bias, sz, k)
    assert launched == 1
    atol = 1e-4 if dtype in (torch.float32, torch.bfloat16) else 1e-2
    assert_kmin_close(kd, ki, *plain, atol=atol)
    big = torch.tensor(BIG, dtype=torch.float32)
    assert bool((kd[dead].cpu() == big).all())
    assert bool((ki[dead].cpu() == torch.arange(k, dtype=torch.int32)).all())
    assert bool((kd[[3, 12], :, 0] < BIG / 2).all())


@pytest.mark.parametrize("k", [4, 10, 16, 32])
@pytest.mark.parametrize("form,d", [
    (torch.float32, 100), (torch.bfloat16, 100), (torch.int8, 100), ("q8", 100),
    (torch.float32, 256), (torch.bfloat16, 256), (torch.int8, 256), ("q8", 256),
])
def test_scan_batched_topk_pairs_kernel_equals_the_full_gathered(card, form, d, k):
    """The pairs form of #6 and #7 bit for bit against the full kernel's
    ``(NB, Q, k)`` output gathered through ``member_pos``, for every KMAX
    and payload the search uses, in the default shape (d=100) and the wide
    one (f32 and bf16 at d=256): a budget past its -1 padding rows and one
    that overflows, dead pages, absent pages and invalid probes, Q across
    two query tiles and the budget across two page runs."""
    from repro_torch.kernels.posting_scan import ops, ref

    gen = torch.Generator().manual_seed(d + k)
    codes = form == "q8"
    blocks = _blocks(gen, 160, 32, d, torch.int8 if codes else form, card)
    q_n, nbq = 70, 24
    q = (torch.randn(q_n, d, generator=gen) * (1 if form in (torch.float32, torch.bfloat16)
                                               else 64)).to(card)
    hot = torch.randperm(160, generator=gen)[:110]
    table = torch.stack([hot[torch.randperm(110, generator=gen)[:nbq]] for _ in range(q_n)])
    table[torch.rand(q_n, nbq, generator=gen) < 0.25] = -1
    table = table.to(torch.int32).to(card)
    for budget in (120, 90):                      # padding rows; 20 pages dropped
        uniq, member_pos, n_unique, overflow = ops.dedup_pages(table.reshape(-1), budget=budget,
                                                               num_blocks=160)
        assert int(overflow) == max(0, int(n_unique) - budget)
        mp = member_pos.reshape(q_n, nbq)
        page_pos = ops.page_positions(mp, budget)
        live = torch.rand(budget, 32, generator=gen).to(card) < 0.7
        live[[0, 7, 50]] = False                  # dead pages
        ids, bias = ops._clamped(uniq), ops._batched_bias(uniq, live)
        sz = _page_sz(gen, budget).to(card)
        name = "scan_batched_topk_q8" if codes else "scan_batched_topk"
        args = (ids, q, blocks, bias, sz) if codes else (ids, q, blocks, bias)
        before = SK.LAUNCHES[name + "_pairs"]
        got = getattr(SK, name + "_pairs")(*args, page_pos, nbq=nbq, k=k)
        full = getattr(SK, name)(*args, k=k)
        torch.cuda.synchronize()
        assert SK.LAUNCHES[name + "_pairs"] == before + 1
        want = ref.gather_pairs(*full, mp)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((got[1][mp < 0] == -1).all()) and bool((mp == 7).any())


def _roofline_reader(name):
    """The ``cardbench/metrics/<name>.py`` module (the benchmark's reader)."""
    import importlib.util
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  root / "cardbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batched_search_scan_names_satisfy_the_roofline_readers(card):
    """A batched search at the cells' page geometry (d=100 bytes, BS=32,
    k=10; the int8 codec's 40 candidates) under ``torch.profiler``: the
    scan kernel's device names are the ones the benchmark's two roofline
    readers find (``_is_scan``), each only by its own reader."""
    from torch.profiler import ProfilerActivity, profile

    six = _roofline_reader("scan_batched_topk_roofline")
    seven = _roofline_reader("scan_batched_topk_q8_roofline")
    rng = np.random.default_rng(6)
    centers = rng.uniform(-90, 90, size=(24, 100))
    base = np.clip(np.round(centers[rng.integers(0, 24, 6000)]
                            + 12 * rng.normal(size=(6000, 100))), -127, 127).astype(np.float32)
    q = base[rng.integers(0, 6000, 256)] + rng.normal(size=(256, 100)).astype(np.float32)
    for codec, reader, other in (("fp32", six, seven), ("int8", seven, six)):
        cfg = LireConfig(dim=100, block_size=32, max_blocks_per_posting=4, num_blocks=4096,
                         num_postings_cap=1024, num_vectors_cap=16384, split_limit=96,
                         merge_limit=12, replica_count=2, nprobe=16, vector_dtype="int8",
                         codec=codec, rerank_factor=4 if codec == "int8" else 1,
                         use_pallas_nav=True, use_pallas_scan=True, scan_schedule="batched",
                         scan_page_budget=2048)
        idx = SPFreshIndex.build(cfg, base, device="cuda")
        idx.search(q, 10)                                     # built and warm
        before = SK.LAUNCHES[("scan_batched_topk_q8" if codec == "int8"
                              else "scan_batched_topk") + "_pairs"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            idx.search(q, 10)
            torch.cuda.synchronize()
        names = {e.name() for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA") and "scan_batched_topk" in e.name()}
        assert names, f"no scan kernel in the {codec} search's trace"
        assert all(reader._is_scan(n) and not other._is_scan(n) for n in names), names
        assert SK.LAUNCHES[("scan_batched_topk_q8" if codec == "int8"
                            else "scan_batched_topk") + "_pairs"] > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bs,k", [(32, 10), (8, 8), (16, 1)])
def test_scan_kernels_match_plain(card, dtype, bs, k):
    gen = torch.Generator().manual_seed(1)
    blocks = _blocks(gen, 64, bs, 100, dtype, card)
    q = (torch.randn(9, 100, generator=gen) * (64 if dtype == torch.int8 else 1)).to(card)
    table = torch.randint(0, 64, (9, 12), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(9, 12, bs, generator=gen) < 0.3, BIG, 0.0).to(card)
    bias[0, 0] = BIG                                 # an all-dead page
    atol = 1e-2 if dtype == torch.int8 else 1e-4
    kd, ki = SK.scan_per_query_topk(table, q, blocks, bias, k=k)
    torch.cuda.synchronize()
    assert_kmin_close(kd, ki, *SK.scan_per_query_topk_plain(table, q, blocks, bias, k=k), atol=atol)
    ids = torch.arange(0, 60, 5, dtype=torch.int32, device=card)
    ub = bias[1, : ids.shape[0]].contiguous()
    kd, ki = SK.scan_batched_topk(ids, q, blocks, ub, k=k)
    torch.cuda.synchronize()
    assert_kmin_close(kd, ki, *SK.scan_batched_topk_plain(ids, q, blocks, ub, k=k), atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bs", [32, 16, 8, 7, 4])
@pytest.mark.parametrize("d", [100, 128, 36])
def test_unreduced_scan_kernels_match_plain(card, dtype, bs, d):
    """#2 and #3 against their plain versions.  #3: Q not a multiple of
    the 64-query tile (9, 77, 40), NB not a multiple of the page run or
    the 4-page step, d not a multiple of 16 (100, 36), BS odd (7: scalar
    stores), -1 padding among the ids, pages 4..7 (one whole step) all
    padding; padding rows are exactly float32(3e38)."""
    gen = torch.Generator().manual_seed(2)
    blocks = _blocks(gen, 64, bs, d, dtype, card)
    scale = 64 if dtype == torch.int8 else 1
    q = (torch.randn(9, d, generator=gen) * scale).to(card)
    table = torch.randint(0, 64, (9, 12), generator=gen, dtype=torch.int32).to(card)
    atol = 1e-2 if dtype == torch.int8 else 1e-4
    before = dict(SK.LAUNCHES)
    got = SK.scan_per_query(table, q, blocks)
    torch.cuda.synchronize()
    want = SK.scan_per_query_plain(table, q, blocks)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=atol)
    cases = [(q, torch.arange(0, 60, 7, dtype=torch.int32))]
    for q_n, nb in ((77, 71), (40, 300)):        # 300: two page runs, one partial
        ids = torch.randint(0, 64, (nb,), generator=gen, dtype=torch.int32)
        ids[[1, nb - 1]] = -1
        ids[4:8] = -1
        cases.append(((torch.randn(q_n, d, generator=gen) * scale).to(card), ids))
    big = torch.tensor(BIG, dtype=torch.float32)
    for qb, ids in cases:
        ids = ids.to(card)
        got = SK.scan_batched(ids, qb, blocks)
        torch.cuda.synchronize()
        want = SK.scan_batched_plain(ids, qb, blocks)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=atol)
        pad = (ids < 0).cpu()
        assert bool((got.cpu()[pad] == big).all())
        assert bool((got.cpu()[~pad] < BIG / 2).all())
    assert SK.LAUNCHES["scan_per_query"] == before["scan_per_query"] + 1
    assert SK.LAUNCHES["scan_batched"] == before["scan_batched"] + len(cases)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_scan_unique_blocks_op_on_the_card_matches_the_cpu(card, dtype):
    """``ops.scan_unique_blocks`` hands the -1 padding ids to #3 as they
    are: on the card it equals its CPU result (the plain version), padding
    rows exactly float32(3e38), in one launch."""
    from repro_torch.kernels.posting_scan import ops

    gen = torch.Generator().manual_seed(3)
    blocks = _blocks(gen, 256, 32, 100, dtype, "cpu")
    q = torch.randn(70, 100, generator=gen) * (64 if dtype == torch.int8 else 1)
    ids = torch.full((200,), -1, dtype=torch.int32)
    ids[:90] = torch.sort(torch.randperm(256, generator=gen)[:90]).values.to(torch.int32)
    ids[40:45] = -1
    before = SK.LAUNCHES["scan_batched"]
    got = ops.scan_unique_blocks(q.to(card), ids.to(card), blocks.to(card))
    torch.cuda.synchronize()
    assert SK.LAUNCHES["scan_batched"] == before + 1
    want = ops.scan_unique_blocks(q, ids, blocks)
    atol = 1e-2 if dtype == torch.int8 else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=atol)
    pad = ids < 0
    assert bool((got.cpu()[pad] == torch.tensor(BIG, dtype=torch.float32)).all())


@pytest.mark.parametrize("form", [torch.float32, torch.bfloat16, torch.int8, "q8"])
@pytest.mark.parametrize("k", [10, 32])
def test_scans_at_the_two_tower_geometry_match_plain(card, form, k):
    """The two-tower index's geometry, d = 256 at BS = 32, where #6 and #3
    take the wide shape for f32 and bf16 pages (the default layout passes
    the block's shared memory; int8 pages keep it): #6 (#7 for ``q8``) with dead pages
    and Q past one query tile, #3 with -1 padding, and #4 (#5) beside them,
    each against its plain version in one launch."""
    gen = torch.Generator().manual_seed(6)
    d, bs, q_n, nb = 256, 32, 70, 37
    codes = form == "q8"
    dtype = torch.int8 if codes else form
    blocks = _blocks(gen, 96, bs, d, dtype, card)
    scale = 64 if dtype == torch.int8 else 1
    q = (torch.randn(q_n, d, generator=gen) * scale).to(card)
    atol = 1e-2 if dtype == torch.int8 else 1e-4
    ids = torch.randint(0, 96, (nb,), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(nb, bs, generator=gen) < 0.3, BIG, 0.0)
    bias[[0, 9, 36]] = BIG
    bias = bias.to(card).contiguous()
    sz = _page_sz(gen, nb).to(card)
    (kd, ki), plain, launched = _batched_topk(form, ids, q, blocks, bias, sz, k)
    assert launched == 1
    assert_kmin_close(kd, ki, *plain, atol=atol, rtol=1e-5)
    assert bool((kd[[0, 9, 36]].cpu() == torch.tensor(BIG, dtype=torch.float32)).all())
    table = torch.randint(0, 96, (q_n, 12), generator=gen, dtype=torch.int32).to(card)
    pbias = torch.where(torch.rand(q_n, 12, bs, generator=gen) < 0.3, BIG, 0.0).to(card)
    name = "scan_per_query_topk_q8" if codes else "scan_per_query_topk"
    args = (table, q, blocks, pbias) + ((_page_sz(gen, q_n * 12).reshape(q_n, 12, 2).to(card),)
                                        if codes else ())
    before = SK.LAUNCHES[name]
    kd, ki = getattr(SK, name)(*args, k=k)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    assert_kmin_close(kd, ki, *getattr(SK, name + "_plain")(*args, k=k), atol=atol)
    if codes:
        return
    pad_ids = ids.clone()
    pad_ids[[1, 4, 5, 6, 7, nb - 1]] = -1
    before = SK.LAUNCHES["scan_batched"]
    got = SK.scan_batched(pad_ids, q, blocks)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["scan_batched"] == before + 1
    want = SK.scan_batched_plain(pad_ids, q, blocks)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=atol)
    pad = (pad_ids < 0).cpu()
    assert bool((got.cpu()[pad] == torch.tensor(BIG, dtype=torch.float32)).all())


@pytest.mark.parametrize("dtype,d", [(torch.float32, 300), (torch.bfloat16, 296),
                                     (torch.int8, 296)])
def test_batched_scans_refuse_a_d_past_the_block_shared_memory(card, dtype, d):
    """Past #3's largest d at BS = 32 (296 f32 and 292 bf16 in the wide
    shape, 292 int8 in the default layout, which int8 pages never leave)
    the launch fails and the wrapper raises: no plain fallback."""
    gen = torch.Generator().manual_seed(7)
    blocks = _blocks(gen, 8, 32, d, dtype, card)
    ids = torch.arange(4, dtype=torch.int32, device=card)
    q = torch.randn(5, d, generator=gen).to(card)
    with pytest.raises(RuntimeError):
        SK.scan_batched(ids, q, blocks)
        torch.cuda.synchronize()


@pytest.mark.parametrize("bs,k", [(32, 32), (32, 10), (8, 8), (16, 1)])
def test_q8_scan_kernels_match_plain(card, bs, k):
    gen = torch.Generator().manual_seed(3)
    codes = _blocks(gen, 64, bs, 100, torch.int8, card)
    q = torch.randn(9, 100, generator=gen).to(card)
    table = torch.randint(0, 64, (9, 12), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(9, 12, bs, generator=gen) < 0.3, BIG, 0.0).to(card)
    bias[0, 0] = BIG                                 # an all-dead page
    sz = torch.stack([torch.rand(9, 12, generator=gen) * 0.05 + 1e-3,
                      torch.randn(9, 12, generator=gen)], dim=-1).to(card).contiguous()
    kd, ki = SK.scan_per_query_topk_q8(table, q, codes, bias, sz, k=k)
    torch.cuda.synchronize()
    assert_kmin_close(kd, ki, *SK.scan_per_query_topk_q8_plain(table, q, codes, bias, sz, k=k))
    ids = torch.arange(0, 60, 5, dtype=torch.int32, device=card)
    ub = bias[1, : ids.shape[0]].contiguous()
    usz = sz[1, : ids.shape[0]].contiguous()
    kd, ki = SK.scan_batched_topk_q8(ids, q, codes, ub, usz, k=k)
    torch.cuda.synchronize()
    assert_kmin_close(kd, ki, *SK.scan_batched_topk_q8_plain(ids, q, codes, ub, usz, k=k))


@pytest.mark.parametrize("bs,k", [(bs, k) for bs in (32, 16, 8) for k in (32, 17, 16, 10, 1)
                                  if k <= bs] + [(8, 8)])
def test_scan_batched_topk_q8_kernel_matches_plain(card, bs, k):
    """#7 against its plain version: NB and Q not multiples of the 64-page
    run and the 64-query tile, negative scales, zeros far from 0 against
    the codes' range, all-dead pages; tolerance as chip_smoke.py's
    (atol 1e-2 + 1e-5 |d|: the product is taken on the codes, the plain
    version's on the dequantised values)."""
    gen = torch.Generator().manual_seed(6)
    codes = _blocks(gen, 200, bs, 100, torch.int8, card)
    nb, q_n = 133, 100
    q = (torch.randn(q_n, 100, generator=gen) * 32).to(card)
    ids = torch.randint(0, 200, (nb,), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(nb, bs, generator=gen) < 0.3, BIG, 0.0)
    bias[[0, 64, 100, nb - 1]] = BIG                 # all-dead pages
    bias = bias.to(card).contiguous()
    sz = _page_sz(gen, nb, far_zero=True).to(card)
    (kd, ki), (pd, pi), launched = _batched_topk("q8", ids, q, codes, bias, sz, k)
    assert launched == 1
    assert_kmin_close(kd, ki, pd, pi, atol=1e-2)
    dead = [0, 64, 100, nb - 1]
    assert bool((kd[dead].cpu() == torch.tensor(BIG, dtype=torch.float32)).all())
    assert bool((ki[dead].cpu() == torch.arange(k, dtype=torch.int32)).all())


def _repeated_rows(gen, n, bs, d, card):
    """int8 pages whose slot j repeats row j % 4, the four rows 24 code
    units apart on column 0: every distance comes four times (eight at
    BS = 32) and distinct ones lie far apart."""
    base = torch.randint(-20, 21, (n, 4, d), generator=gen, dtype=torch.int8)
    base[:, :, 0] = (torch.arange(4, dtype=torch.int8) * 24 - 36)[None, :]
    return base[:, torch.arange(bs) % 4].contiguous().to(card)


@pytest.mark.parametrize("form", ["q8", torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [32, 17])
def test_scan_batched_topk_rank_select_ties(card, form, k):
    """The k > 16 select (a rank count) of #6 and #7 on repeated code rows.
    Integer queries, power-of-two scales and integer zeros make every
    distance exact in f32 for the int8 forms, so the kernel must give the
    plain version's values and slots exactly (ties: the lowest slot
    first); bf16 and f32 pages are held tie-tolerantly."""
    gen = torch.Generator().manual_seed(7)
    bs, nb, q_n = 32, 70, 75
    blocks = _repeated_rows(gen, 40, bs, 100, card)
    if form in (torch.bfloat16, torch.float32):
        blocks = (blocks.float() / 16).to(form)
    q = torch.randint(-8, 9, (q_n, 100), generator=gen).float().to(card)
    ids = torch.randint(0, 40, (nb,), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(nb, bs, generator=gen) < 0.2, BIG, 0.0)
    bias[5] = BIG
    bias = bias.to(card).contiguous()
    scale = torch.tensor([0.5, -0.25, 1.0, 2.0])[torch.randint(0, 4, (nb,), generator=gen)]
    zero = torch.randint(-20, 21, (nb,), generator=gen).float()
    sz = torch.stack([scale, zero], dim=-1).contiguous().to(card)
    (kd, ki), (pd, pi), launched = _batched_topk(form, ids, q, blocks, bias, sz, k)
    assert launched == 1
    if form in ("q8", torch.int8):
        assert torch.equal(kd.cpu(), pd.cpu())
        assert torch.equal(ki.cpu(), pi.cpu())
    else:
        assert_kmin_close(kd, ki, pd, pi)
    # ascending by (value, slot) in every row
    step_d, step_i = kd[..., 1:] - kd[..., :-1], ki[..., 1:] - ki[..., :-1]
    assert bool(((step_d > 0) | ((step_d == 0) & (step_i > 0))).all())


def _per_query_topk(form, table, q, blocks, bias, sz, k):
    """The kernel and the plain version of #4 (``form`` a dtype) or #5
    (``form`` "q8"): ``((kd, ki), (pd, pi), launches counted)``."""
    name = "scan_per_query_topk_q8" if form == "q8" else "scan_per_query_topk"
    args = (table, q, blocks, bias, sz) if form == "q8" else (table, q, blocks, bias)
    before = SK.LAUNCHES[name]
    got = getattr(SK, name)(*args, k=k)
    torch.cuda.synchronize()
    return got, getattr(SK, name + "_plain")(*args, k=k), SK.LAUNCHES[name] - before


FLOAT_FORMS = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("form", [torch.float32, torch.bfloat16, torch.int8, "q8"])
@pytest.mark.parametrize("bs,k", [(32, 32), (32, 10), (32, 1), (8, 8)])
def test_scan_per_query_topk_kernel_dead_pairs(card, form, bs, k):
    """All-dead (query, page) pairs at the start, middle and end of the
    rows, a query whose every pair is dead, pairs with one live slot; a
    dead pair gives exactly (float32(3e38), slots 0..k-1), which the
    kernel writes without loading the page.  ``q8`` is #5 over int8 codes
    with per-pair (scale, zero)."""
    gen = torch.Generator().manual_seed(8)
    dtype = torch.int8 if form == "q8" else form
    blocks = _blocks(gen, 64, bs, 100, dtype, card)
    q_n, nb = 9, 21
    q = (torch.randn(q_n, 100, generator=gen) * (1 if form in FLOAT_FORMS else 64)).to(card)
    table = torch.randint(0, 64, (q_n, nb), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(q_n, nb, bs, generator=gen) < 0.3, BIG, 0.0)
    dead = torch.zeros(q_n, nb, dtype=torch.bool)
    dead[:, [0, 10, nb - 1]] = True
    dead[4] = True                                   # a query with no live pair
    bias[dead] = BIG
    for i, j in ((1, 3), (7, 12)):                   # one live slot
        bias[i, j] = BIG
        bias[i, j, bs // 2] = 0.0
    bias = bias.to(card).contiguous()
    sz = _page_sz(gen, q_n * nb).reshape(q_n, nb, 2).contiguous().to(card)
    (kd, ki), plain, launched = _per_query_topk(form, table, q, blocks, bias, sz, k)
    assert launched == 1
    assert_kmin_close(kd, ki, *plain, atol=1e-4 if form in FLOAT_FORMS else 1e-2)
    dead = dead.to(card)
    assert bool((kd[dead].cpu() == torch.tensor(BIG, dtype=torch.float32)).all())
    assert bool((ki[dead].cpu() == torch.arange(k, dtype=torch.int32)).all())
    assert bool((kd[[1, 7], [3, 12], 0] < BIG / 2).all())


@pytest.mark.parametrize("form", [torch.float32, torch.bfloat16, torch.int8, "q8"])
@pytest.mark.parametrize("bs,d,k", [(32, 128, 10), (32, 128, 32), (16, 64, 5),
                                    (8, 4, 8), (7, 4, 3), (3, 12, 2)])
def test_scan_per_query_kernels_padded_rows_and_small_pages(card, form, bs, d, k):
    """#4, #5 and #2 where a row is an even number of 4-value units (d =
    128, 64: the kernel's ring pads each row by one unit so that the lanes'
    shared-memory reads stay conflict-free) and where a page is not a
    multiple of 16 bytes (int8 at BS = 7, d = 4: 28 bytes; BS = 3, d = 12:
    36 bytes; bf16 at BS = 7 or 3: copied one unit at a time); int8 at
    BS = 8, d = 4 is a 32-byte page (16-byte copies)."""
    gen = torch.Generator().manual_seed(9)
    dtype = torch.int8 if form == "q8" else form
    blocks = _blocks(gen, 50, bs, d, dtype, card)
    q_n, nb = 11, 13
    q = (torch.randn(q_n, d, generator=gen) * (1 if form in FLOAT_FORMS else 64)).to(card)
    table = torch.randint(0, 50, (q_n, nb), generator=gen, dtype=torch.int32).to(card)
    bias = torch.where(torch.rand(q_n, nb, bs, generator=gen) < 0.3, BIG, 0.0)
    bias[0, 0] = BIG                                 # an all-dead pair
    bias = bias.to(card).contiguous()
    sz = _page_sz(gen, q_n * nb).reshape(q_n, nb, 2).contiguous().to(card)
    atol = 1e-4 if form in FLOAT_FORMS else 1e-2
    (kd, ki), plain, launched = _per_query_topk(form, table, q, blocks, bias, sz, k)
    assert launched == 1
    assert_kmin_close(kd, ki, *plain, atol=atol)
    if form != "q8":
        got = SK.scan_per_query(table, q, blocks)
        torch.cuda.synchronize()
        want = SK.scan_per_query_plain(table, q, blocks)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=atol)


def test_wrappers_raise_instead_of_falling_back(card):
    blocks = torch.zeros((4, 8, 10), device=card)            # d % 4 != 0
    with pytest.raises(ValueError):
        SK.scan_batched_topk(torch.zeros(2, dtype=torch.int32, device=card),
                             torch.zeros(3, 10, device=card), blocks,
                             torch.zeros(2, 8, device=card), k=4)
    with pytest.raises(ValueError):                           # mixed devices
        LK.l2_topk_tiles(torch.zeros(4, 8, device=card), torch.zeros(128, 8),
                         torch.zeros(1, 128), k=4, block_p=128)


def test_index_on_the_card_matches_the_cpu_path(card):
    """The same index searched through the kernels on the card and through
    the plain versions on the CPU: tie-tolerant agreement."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(12, 16)).astype(np.float32)
    base = (centers[rng.integers(0, 12, 800)] + 0.05 * rng.normal(size=(800, 16))).astype(np.float32)
    cfg = LireConfig(dim=16, block_size=8, max_blocks_per_posting=16, num_blocks=2048,
                     num_postings_cap=256, num_vectors_cap=8192, split_limit=48,
                     merge_limit=6, replica_count=2, nprobe=8, use_pallas_nav=True,
                     use_pallas_scan=True)
    cpu = SPFreshIndex.build(cfg, base, device="cpu")
    gpu = SPFreshIndex(map_tensors(lambda x: x.to(card), cpu.state))
    q = base[:48] + 0.01 * rng.normal(size=(48, 16)).astype(np.float32)
    for sched in ("per_query", "batched"):
        d0, v0 = cpu.search(q, 10, scan_schedule=sched)
        d1, v1 = gpu.search(q, 10, scan_schedule=sched)
        np.testing.assert_allclose(d0, d1, atol=1e-4)
        assert (np.abs(d0 - d1)[v0 != v1] < 1e-4).all()
    # the int8 codec with the exact rerank (rerank_factor=4), both schedules
    cfg8 = dataclasses.replace(cfg, codec="int8", rerank_factor=4)
    cpu8 = SPFreshIndex.build(cfg8, base, device="cpu")
    gpu8 = SPFreshIndex(map_tensors(lambda x: x.to(card), cpu8.state))
    for sched in ("per_query", "batched"):
        d0, v0 = cpu8.search(q, 10, scan_schedule=sched)
        d1, v1 = gpu8.search(q, 10, scan_schedule=sched)
        np.testing.assert_allclose(d0, d1, atol=1e-4)
        assert (np.abs(d0 - d1)[v0 != v1] < 1e-4).all()
    ids = np.arange(5000, 5032, dtype=np.int32)
    gpu.insert(q[:32], ids)
    _, got = gpu.search(q[:32], 5, scan_schedule="batched")
    assert all(ids[i] in got[i] for i in range(32))
    stats = lire.scan_page_stats(gpu.state, torch.as_tensor(q, device=card))
    assert int(stats["overflow"]) == 0
    assert dataclasses.is_dataclass(gpu.state)


def _churned_cpu_index(**kw):
    """A small index with a split and a merge backlog, on the CPU."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 16)) * 5
    base = (centers[rng.integers(0, 8, 1000)] + rng.normal(size=(1000, 16))).astype(np.float32)
    cfg = LireConfig(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                     num_postings_cap=256, num_vectors_cap=8192, split_limit=48, merge_limit=6,
                     reassign_range=8, reassign_budget=128, replica_count=2, nprobe=8,
                     jobs_per_round=4, use_pallas_nav=True, **kw)
    idx = SPFreshIndex.build(cfg, base, device="cpu")
    cen = idx.state.centroids[idx.state.centroid_valid].numpy()
    hot = np.concatenate([(c[None] + 0.05 * rng.normal(size=(40, 16))).astype(np.float32)
                          for c in cen[:4]])
    idx.insert(hot, np.arange(4000, 4000 + len(hot), dtype=np.int32), max_retries=0)
    idx.delete(np.argsort(((base - base[0]) ** 2).sum(-1))[:150].astype(np.int32))
    return idx.state


def _leaves_np(state):
    from repro_torch.utils.tree import tensor_leaves

    return {n: t.cpu() for n, t in tensor_leaves(state).items()}


@pytest.mark.parametrize("policy", ["size", "drift"])
def test_maintenance_round_on_the_card_matches_the_cpu(card, policy):
    """One round through #1 on the card and through its plain version on
    the CPU: integer leaves equal, float leaves within 1e-5."""
    cpu = _churned_cpu_index(maintain_policy=policy)
    gpu = map_tensors(lambda x: x.to(card), cpu)
    before = LK.LAUNCHES["l2_topk_tiles"]
    out_g, did_g = lire.maintenance_round(gpu, 4)
    torch.cuda.synchronize()
    assert LK.LAUNCHES["l2_topk_tiles"] > before
    out_c, did_c = lire.maintenance_round(cpu, 4)
    assert int(did_g) == int(did_c) > 0
    a, b = _leaves_np(out_g), _leaves_np(out_c)
    for name in a:
        if a[name].is_floating_point():
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_maintenance_round_in_place_equals_functional_and_replays_on_the_card(card, codec):
    from repro_torch.utils.tree import clone_state

    gpu = map_tensors(lambda x: x.to(card), _churned_cpu_index(codec=codec, rerank_factor=2))
    func, did_f = lire.maintenance_round(gpu, 4)
    again, _ = lire.maintenance_round(gpu, 4)
    owned = clone_state(gpu)
    inpl, did_i = lire.maintenance_round(owned, 4, inplace=True)
    assert inpl.pool.blocks is owned.pool.blocks
    assert int(did_f) == int(did_i) > 0
    a, b, c = _leaves_np(func), _leaves_np(inpl), _leaves_np(again)
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert torch.equal(a[name], c[name]), name


def test_index_drain_on_the_card(card):
    """Insert past capacity on the card: the backpressure drain lands every
    row, leaves no backlog, and runs #1."""
    cpu = _churned_cpu_index()
    idx = SPFreshIndex(map_tensors(lambda x: x.to(card), cpu))
    rng = np.random.default_rng(4)
    cen = cpu.centroids[cpu.centroid_valid].numpy()[:2]
    more = np.concatenate([(c[None] + 0.05 * rng.normal(size=(60, 16))).astype(np.float32)
                           for c in cen])
    before = LK.LAUNCHES["l2_topk_tiles"]
    idx.insert(more, np.arange(6000, 6120, dtype=np.int32))
    assert idx.maintain() >= 0 and idx.backlog() == 0
    assert LK.LAUNCHES["l2_topk_tiles"] > before
    _, got = idx.search(more, 5)
    assert sum(6000 + i in got[i] for i in range(120)) >= 114


def test_maintenance_round_reads_nothing_back(card):
    """A round enqueues its work without waiting for the card: the drain's
    one did-work read per round is its only host sync."""
    state = map_tensors(lambda x: x.to(card), _churned_cpu_index())
    lire.maintenance_round(state, 4)            # kernels built, caches warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, did = lire.maintenance_round(state, 4, inplace=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(did) > 0


def _serve_index(card, **kw):
    """A small kernel-path index on the card (the churned CPU build)."""
    cpu = _churned_cpu_index(use_pallas_scan=True, **kw)
    return SPFreshIndex(map_tensors(lambda x: x.to(card), cpu))


@pytest.mark.parametrize("schedule", ["batched", "per_query"])
def test_deferred_readback_equals_the_blocking_search(card, schedule):
    """``search_begin``'s pinned, event-guarded readback gives exactly the
    blocking ``search_padded`` results, and its probe histogram folds into
    the pending access counts at finalize."""
    from repro_torch.serve import LocalBackend

    idx = _serve_index(card)
    q = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32) * 3
    valid = np.arange(64) < 50
    be = LocalBackend(idx, use_pallas_scan=True, scan_schedule=schedule)
    want = idx.search_padded(q, 10, nprobe=8, use_pallas_scan=True, scan_schedule=schedule,
                             with_access=True, qvalid=valid)
    fin = be.search_begin(q, 10, 8, valid)
    assert be._pending_access.sum() == 0
    d, v = fin()
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(v, want[1])
    np.testing.assert_array_equal(be._pending_access, want[2])


@pytest.mark.parametrize("schedule", ["batched", "per_query"])
def test_search_dispatch_runs_without_a_host_sync(card, schedule):
    """One search dispatch of each schedule under
    ``set_sync_debug_mode("error")``, queued behind a device sleep: it
    raises on any host sync, and returns while the card still works."""
    from repro_torch.serve import LocalBackend

    idx = _serve_index(card)
    q = np.random.default_rng(6).normal(size=(32, 16)).astype(np.float32) * 3
    valid = np.ones(32, bool)
    be = LocalBackend(idx, use_pallas_scan=True, scan_schedule=schedule)
    want = be.search(q, 10, 8, valid)          # kernels built, pinned buffers cached
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fin = be.search_begin(q, 10, 8, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not torch.cuda.current_stream().query()
    d, v = fin()
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(v, want[1])


def test_async_engine_on_the_card_replays_bit_identically(card):
    """The async pump on the card: deferred searches interleaved with
    in-place inserts, deletes and slots on one stream; the recorded stream
    replays on a clone leaf for leaf, and awaited inserts are visible."""
    from repro_torch.serve import EngineConfig, LocalBackend, ServeEngine
    from repro_torch.storage.durability import RecordingSink
    from repro_torch.utils.tree import clone_state, tensor_leaves

    idx = _serve_index(card)
    before = clone_state(idx.state)
    eng = ServeEngine(idx, EngineConfig(nprobe=8, max_batch=64, async_serve=True,
                                        max_wait_ms=1.0, lock_check=True, maintain_budget=4))
    sink = RecordingSink()
    eng.backend.attach_replication(sink)
    rng = np.random.default_rng(7)
    try:
        for i in range(12):
            vecs = (rng.normal(size=(16, 16)) * 5).astype(np.float32)
            ids = np.arange(7000 + 16 * i, 7016 + 16 * i, dtype=np.int32)
            _, landed = eng.submit_insert(vecs, ids).result(timeout=120)
            assert landed.all()
            _, got = eng.submit_search(vecs, k=5).result(timeout=120)
            assert sum(ids[j] in got[j] for j in range(16)) >= 15
            eng.submit_delete(ids[:4]).result(timeout=120)
        eng.pump()
    finally:
        eng.shutdown(timeout=120)
    twin = LocalBackend(SPFreshIndex(before), track_access=False)
    twin.replay(sink.records)
    a, b = tensor_leaves(idx.state), tensor_leaves(twin.index.state)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_durable_service_checkpoints_under_a_deferred_search_and_recovers(card, tmp_path):
    """A durable service on the card: a deferred ``search_begin`` is still
    in flight (behind a device sleep) when a delta checkpoint copies the
    state to the host on the same stream; its readback equals the blocking
    search, and after more updates a crash recovers base + delta + WAL
    tail to bit-identical leaves."""
    from repro_torch import api
    from repro_torch.utils.tree import clone_state, tensor_leaves

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 16)) * 5
    base = (centers[rng.integers(0, 8, 1000)] + rng.normal(size=(1000, 16))).astype(np.float32)
    cfg = LireConfig(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                     num_postings_cap=256, num_vectors_cap=8192, split_limit=48, merge_limit=6,
                     reassign_range=8, reassign_budget=128, replica_count=2, nprobe=8,
                     jobs_per_round=4, use_pallas_nav=True, use_pallas_scan=True)
    spec = api.ServiceSpec(index=api.IndexSpec(config=cfg),
                           serve=api.ServeSpec(max_batch=64)).with_durability(
        str(tmp_path / "svc"), group_commit=8)
    svc = api.open(spec, vectors=base)
    assert svc.index.state.device.type == "cuda"
    ids = np.arange(5000, 5096, dtype=np.int32)
    vecs = (centers[rng.integers(0, 8, 96)] + rng.normal(size=(96, 16))).astype(np.float32)
    for s in range(0, 64, 16):
        svc.insert(vecs[s:s + 16], ids[s:s + 16])
    svc.delete(ids[:8])
    q = vecs[:32]
    valid = np.ones(32, bool)
    want = svc.index.search_padded(q, 10, nprobe=8)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    fin = svc.backend.search_begin(q, 10, 8, valid)
    assert not torch.cuda.current_stream().query()
    svc.checkpoint(delta=True)
    assert svc.last_checkpoint["unit"].startswith("delta-")
    d, v = fin()
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(v, want[1])
    for s in range(64, 96, 16):
        svc.insert(vecs[s:s + 16], ids[s:s + 16])
    svc.delete(ids[64:70])
    kept = clone_state(svc.index.state)
    want = svc.search(q, k=10)
    svc.engine.shutdown()                      # crash: no checkpoint, no close
    twin = api.open(spec)
    assert twin.recovered and twin.recovery["replayed_records"] > 0
    a, b = tensor_leaves(kept), tensor_leaves(twin.index.state)
    assert not [n for n in a if not torch.equal(a[n], b[n])]
    got = twin.search(q, k=10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# the sharded index and its replicas on the card
# ---------------------------------------------------------------------------

def _sharded_pair(card):
    """The same 4-shard index on the CPU and on the card (built on the CPU,
    copied over)."""
    from repro_torch.distributed.sharded_index import ShardedIndex

    rng = np.random.default_rng(4)
    centers = rng.normal(size=(12, 16)) * 5
    base = (centers[rng.integers(0, 12, 2000)] + rng.normal(size=(2000, 16))).astype(np.float32)
    cfg = LireConfig(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=1024,
                     num_postings_cap=128, num_vectors_cap=4096, split_limit=48, merge_limit=6,
                     reassign_range=8, reassign_budget=128, replica_count=2, nprobe=8,
                     jobs_per_round=4, use_pallas_nav=True, use_pallas_scan=True)
    cpu, _ = ShardedIndex.build(cfg, base, 4, device="cpu")
    gpu = ShardedIndex(cfg, [map_tensors(lambda x: x.to(card), st) for st in cpu.states])
    return cpu, gpu, base


@pytest.mark.parametrize("schedule", ["batched", "per_query"])
def test_sharded_search_on_the_card_matches_the_cpu_path(card, schedule):
    """A 4-shard search through the kernels (#1, #4 / #6 per shard, then the
    tournament merge) against the plain path on the CPU: tie-tolerant.
    Distances within atol + 1e-5 max||q||^2 (the bound chip_smoke.py and
    the kernel tests hold the f32 expansion to: ||q||^2 - 2 q.b + ||b||^2
    carries ~1e-6 ||q||^2 of rounding on either path)."""
    cpu, gpu, base = _sharded_pair(card)
    for be in (cpu, gpu):
        be.scan_schedule = schedule
        be.set_alive([True, False, True, True])
    q = base[:64] + 0.01
    d0, v0 = cpu.search(q, 10, 8)
    d1, v1 = gpu.search(q, 10, 8)
    tol = 1e-4 + 1e-5 * float(np.max(np.sum(q.astype(np.float64) ** 2, axis=1)))
    np.testing.assert_allclose(d1, d0, atol=tol, rtol=0)
    assert (np.abs(d0 - d1)[v0 != v1] <= tol).all()
    assert not ((v1 // 4096 == 1) & (v1 >= 0)).any()


def test_sharded_search_begin_runs_without_a_host_sync(card):
    """Every shard's search and the merge queued under
    ``set_sync_debug_mode("error")`` behind a device sleep: no host sync
    between the shards, and the call returns while the card still works."""
    _, gpu, base = _sharded_pair(card)
    q = base[:32]
    valid = np.ones(32, bool)
    want = gpu.search(q, 10, 8, valid)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fin = gpu.search_begin(q, 10, 8, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not torch.cuda.current_stream().query()
    d, v = fin()
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(v, want[1])


def test_replica_catch_up_fork_on_the_card_equals_the_primary(card):
    """A replica paused past its window catches up by forking the primary's
    shards under the engine's exclusive lock, on the default stream behind
    the pump's dispatches: its leaves equal the primary's."""
    from repro_torch.distributed.replication import ReplicaSet, states_equal
    from repro_torch.serve import EngineConfig, ServeEngine

    _, gpu, base = _sharded_pair(card)
    rs = ReplicaSet(gpu, [gpu.clone()], max_lag=4, window=4)
    gpu.attach_replication(rs)
    eng = ServeEngine(gpu, EngineConfig(max_batch=64, async_serve=True, maintain_budget=4),
                      replicas=rs)
    rs.bind(eng)
    rs.start()
    rng = np.random.default_rng(9)
    try:
        rs.pause(0)
        for _ in range(8):
            rows = base[rng.integers(0, 2000, 16)] + 0.01
            _, landed = eng.submit_insert(rows, np.full(16, -1, np.int32)).result(timeout=120)
            assert landed.all()
        eng.barrier()
        assert rs.report()["per_replica"][0]["lag"] > 4
        rs.resume(0)
        rs.wait_sync(timeout=120)
        rep = rs.report()["per_replica"][0]
        assert rep["catchups"] >= 1 and not rep["failed"]
        assert states_equal(gpu.states, rs.replicas[0].backend.states)
        assert rs.replicas[0].backend.states[0].device.type == "cuda"
    finally:
        eng.shutdown(timeout=120)


def test_counter_init_on_the_card_equals_the_cpu(card):
    """``twotower_init_counter`` gives the card the CPU's bits: the
    retrieval path's recall floor is the reference's run on params made on
    the CPU."""
    from repro_torch.configs.two_tower_retrieval import SERVE_CONFIG
    from repro_torch.models import recsys

    cfg = dataclasses.replace(SERVE_CONFIG, n_items=70_000, user_vocab_per_field=1000)
    a = recsys.twotower_init_counter(3, cfg, device=card)
    b = recsys.twotower_init_counter(3, cfg, device="cpu")
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x.cpu(), y), name


def test_retriever_on_the_card_matches_the_cpu(card):
    """``IndexedRetriever`` at the reference test's sizes: the same params
    and built state on the card (#1, #4, #6) and on the CPU (their plain
    versions) give the same embeddings, brute force and ANN results under
    both schedules, ties aside; fresh items added on the card find
    themselves."""
    import copy

    from repro_torch.models import recsys
    from repro_torch.serve.retrieval import IndexedRetriever

    mcfg = recsys.TwoTowerConfig(n_items=2000, n_user_fields=4, user_vocab_per_field=100,
                                 embed_dim=16, tower_dims=(32, 8))
    icfg = LireConfig(dim=8, block_size=8, max_blocks_per_posting=8, num_blocks=4096,
                      num_postings_cap=512, num_vectors_cap=16384, split_limit=48,
                      merge_limit=6, reassign_range=8, replica_count=2, nprobe=16,
                      use_pallas_nav=True, use_pallas_scan=True)
    params = recsys.twotower_init(torch.Generator().manual_seed(0), mcfg, device="cpu")
    cpu = IndexedRetriever(params, mcfg, icfg, device="cpu")
    cpu.build_corpus(np.arange(1500))
    gpu = IndexedRetriever(copy.deepcopy(params), mcfg, icfg, device=card)
    gpu.index = SPFreshIndex(map_tensors(lambda x: x.to(card), cpu.index.state))
    gpu._id_map = cpu._id_map.copy()
    users = np.random.default_rng(0).integers(0, 100, size=(48, 4)).astype(np.int32)
    np.testing.assert_allclose(gpu.embed_items(np.arange(1500)), cpu.embed_items(np.arange(1500)),
                               rtol=1e-5, atol=1e-5)

    def agree(a, b):
        (s0, i0), (s1, i1) = a, b
        np.testing.assert_allclose(s1, s0, atol=1e-4)
        assert (np.abs(s0 - s1)[i0 != i1] <= 1e-4).all()

    agree(cpu.retrieve_bruteforce(users), gpu.retrieve_bruteforce(users))
    before = dict(SK.LAUNCHES)
    for sched in ("per_query", "batched"):
        for r in (cpu, gpu):
            st = r.index.state
            r.index.state = st.replace(cfg=dataclasses.replace(st.cfg, scan_schedule=sched))
        agree(cpu.retrieve(users), gpu.retrieve(users))
    assert SK.LAUNCHES["scan_per_query_topk"] > before["scan_per_query_topk"]
    assert SK.LAUNCHES["scan_batched_topk_pairs"] > before["scan_batched_topk_pairs"]
    fresh = np.arange(1500, 1564)
    gpu.add_items(fresh)
    _, v = gpu.index.search(gpu.embed_items(fresh), 10)
    assert all(1500 + i in v[i] for i in range(len(fresh)))


# ---------------------------------------------------------------------------
# the launchers' shared memory: the C queries against spflint's mirror
# ---------------------------------------------------------------------------

def _smem_cases():
    from repro_torch.analysis.config import DEFAULT_SPEC

    spec = DEFAULT_SPEC.smem
    return [pytest.param(entry, form, payload, g, id=f"{entry}-{payload}-{g['name']}")
            for entry, (form, payloads) in spec.entries.items()
            for payload in payloads for g in spec.bindings]


@pytest.mark.parametrize("entry,form,payload,g", _smem_cases())
def test_smem_query_equals_the_mirror(card, entry, form, payload, g):
    """Each launch entry's ``_smem_bytes`` query (the launcher's own
    arithmetic) equals ``repro_torch.analysis.smem`` at every payload and
    geometry of the spec; the card's occupancy is at most the blocks an SM
    the shared memory allows."""
    from repro_torch.analysis import smem as SM
    from repro_torch.analysis.config import DEFAULT_SPEC
    from repro_torch.kernels import build

    spec = DEFAULT_SPEC.smem
    want = SM.shape_of(form, payload, g, spec)
    got, shape = build.smem_query(entry, *SM.query_args(entry, form, payload, g))
    assert (got, shape[:3]) == (want.bytes, (want.variant, want.warps, want.stages))
    assert torch.cuda.get_device_properties(0).shared_memory_per_block_optin == spec.limit_bytes
    if want.variant >= 0:
        assert 1 <= shape[3] <= SM.blocks_per_sm(want, spec)


def _edge_cases():
    from repro_torch.analysis.config import DEFAULT_SPEC

    return [pytest.param(entry, form, payload, id=f"{entry}-{payload}")
            for entry, (form, payloads) in DEFAULT_SPEC.smem.entries.items()
            for payload in payloads]


@pytest.mark.parametrize("entry,form,payload", _edge_cases())
def test_launcher_launches_or_refuses_as_the_mirror_predicts(card, entry, form, payload):
    """At BS = 32 the largest d the mirror says fits launches and agrees
    with the plain version; the next d is refused with
    cudaErrorInvalidValue: the wrapper raises and counts no launch."""
    import chip_smoke
    from repro_torch.analysis import smem as SM
    from repro_torch.analysis.config import DEFAULT_SPEC

    gen = torch.Generator(device="cuda").manual_seed(0)
    fit, past = chip_smoke._edge_geometries(SM, DEFAULT_SPEC.smem, form, payload)
    run, plain = chip_smoke._resource_launch(torch, gen, entry, form, payload, fit)
    got, want = run(), plain()
    if isinstance(got, tuple):
        chip_smoke.compare_kmin(*got, *want, atol=1e-2)
    else:
        chip_smoke.compare_dense(got, want)
    run, _ = chip_smoke._resource_launch(torch, gen, entry, form, payload, past)
    before = sum(LK.LAUNCHES.values()) + sum(SK.LAUNCHES.values())
    with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
        run()
    assert sum(LK.LAUNCHES.values()) + sum(SK.LAUNCHES.values()) == before


# ---------------------------------------------------------------------------
# The recsys training path: each family's smoke step on the card against
# the CPU's, the MIND restart under deterministic algorithms, the ragged bag
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["two-tower-retrieval", "deepfm", "bert4rec", "mind"]


def _train_inputs(arch, device):
    """A train cell's smoke inputs on the CPU and a copy on ``device``."""
    from repro_torch.configs import get_cell
    from repro_torch.train.optimizer import adamw_init

    cell = get_cell(arch, "train_batch")
    params, opt, batch = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(0),
                                                device="cpu")
    gpu = copy.deepcopy(params).to(device)
    return cell, (params, opt, batch), (gpu, adamw_init(gpu),
                                        {k: v.to(device) for k, v in batch.items()})


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """Three smoke steps: the loss at 1e-5 relative, ``grad_norm`` at 1e-4,
    ``lr`` and ``count`` exact, every parameter and moment at rtol 1e-4,
    atol 1e-5 (TF32 off: the card sums in f32, in its own order)."""
    from repro_torch.convert import train_state_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cell, cpu, gpu = _train_inputs(arch, card)
    for _ in range(3):
        *cpu_state, mc = cell.smoke_step_fn(*cpu)
        *gpu_state, mg = cell.smoke_step_fn(*gpu)
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]), rtol=1e-4)
        assert float(mg["lr"]) == float(mc["lr"])
    for (a, _), (b, _) in zip(train_state_leaves(*cpu[:2]), train_state_leaves(*gpu[:2])):
        assert b.device.type == card.type
        np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_mind_restart_on_the_card_is_bit_identical(card, tmp_path):
    """Six steps in one run against three, a checkpoint, a fresh Trainer
    restoring it and three more, all under deterministic algorithms."""
    from repro_torch.configs import get_cell
    from repro_torch.configs.common import OPT
    from repro_torch.convert import train_state_leaves
    from repro_torch.models import recsys as R
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cell = get_cell("mind", "train_batch")
    cfg = cell.smoke_cfg

    def trainer(ckpt):
        return Trainer(
            loss_fn=lambda p, b: R.mind_loss(p, b, cfg),
            init_params_fn=lambda: R.mind_init(torch.Generator(device="cuda").manual_seed(0),
                                               cfg, device=card),
            batch_fn=lambda s: cell.make_smoke_inputs(cfg, np.random.default_rng(s),
                                                      device=card)[-1],
            opt_cfg=OPT, trainer_cfg=TrainerConfig(total_steps=6, checkpoint_every=3),
            ckpt_dir=ckpt, device=card)

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = trainer(None)
        a.run()
        trainer(str(tmp_path)).run(steps=3)
        b = trainer(str(tmp_path))
        b.run()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert a.step == b.step == 6
    for (x, _), (y, _) in zip(train_state_leaves(a.params, a.opt_state),
                              train_state_leaves(b.params, b.opt_state)):
        assert torch.equal(x, y)


def test_embedding_bag_ragged_on_the_card_matches_the_cpu(card):
    """The card's sum equals the CPU's and is the same bits run to run
    under deterministic algorithms; its gradient too."""
    from repro_torch.models.recsys import embedding_bag_ragged

    gen = torch.Generator().manual_seed(0)
    table = torch.randn(5000, 64, generator=gen)
    flat = torch.randint(-1, 5000, (200_000,), generator=gen)
    seg = torch.randint(0, 1030, (200_000,), generator=gen)       # some past n_segments
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for _ in range(2):
            t = table.to(card).requires_grad_(True)
            out = embedding_bag_ragged(t, flat.to(card), seg.to(card), 1024, combiner="mean")
            (g,) = torch.autograd.grad(out.square().sum(), t)
            outs.append((out.detach(), g))
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    t = table.clone().requires_grad_(True)
    want = embedding_bag_ragged(t, flat, seg, 1024, combiner="mean")
    (wg,) = torch.autograd.grad(want.square().sum(), t)
    np.testing.assert_allclose(outs[0][0].cpu().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0][1].cpu().numpy(), wg.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The LM family: prefill, decode and a train step on the card against the
# CPU at the smoke configs; a decode step without a host sync
# ---------------------------------------------------------------------------

LM_ARCHS = ["granite-20b", "deepseek-7b", "qwen1.5-110b", "granite-moe-1b-a400m",
            "phi3.5-moe-42b-a6.6b"]


def _lm_inputs(arch, shape, device):
    """An LM cell's smoke inputs on the CPU and a copy on ``device`` (a
    train cell's optimiser state made anew for the copy)."""
    from repro_torch.configs import get_cell
    from repro_torch.train.optimizer import adamw_init

    cell = get_cell(arch, shape)
    cpu = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(0), device="cpu")
    gpu = [copy.deepcopy(cpu[0]).to(device)]
    for x in cpu[1:]:
        if cell.kind == "train" and x is cpu[1]:
            gpu.append(adamw_init(gpu[0]))
        else:
            gpu.append({k: v.to(device) for k, v in x.items()} if isinstance(x, dict)
                       else x.to(device))
    return cell, cpu, gpu


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(card, arch):
    """The ``prefill_32k`` and ``decode_32k`` smoke steps: logits and cache
    at rtol = atol = 1e-5 (TF32 off), the decode's cache written in place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in ("prefill_32k", "decode_32k"):
        cell, cpu, gpu = _lm_inputs(arch, shape, card)
        (lc, cc), (lg, cg) = cell.smoke_step_fn(*cpu), cell.smoke_step_fn(*gpu)
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-5, atol=1e-5)
        for name in ("k", "v"):
            assert cg[name].device.type == card.type
            np.testing.assert_allclose(cg[name].cpu().numpy(), cc[name].numpy(), rtol=1e-5,
                                       atol=1e-5)
        if shape == "decode_32k":
            assert cg is gpu[1]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-7b"])
def test_lm_decode_step_runs_without_a_host_sync(card, arch):
    cell, _, gpu = _lm_inputs(arch, "decode_32k", card)
    cell.smoke_step_fn(*gpu)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = cell.smoke_step_fn(gpu[0], gpu[1], gpu[2], gpu[3] + 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen1.5-110b"])
def test_lm_train_step_on_the_card_matches_the_cpu(card, arch):
    """Two ``train_4k`` smoke steps: loss at 1e-5 relative, ``grad_norm``
    at 1e-4, the state at rtol 1e-4, atol 1e-5."""
    from repro_torch.convert import train_state_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cell, cpu, gpu = _lm_inputs(arch, "train_4k", card)
    for _ in range(2):
        *_, mc = cell.smoke_step_fn(*cpu)
        *_, mg = cell.smoke_step_fn(*gpu)
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]), rtol=1e-4)
    for (a, _), (b, _) in zip(train_state_leaves(*cpu[:2]), train_state_leaves(*gpu[:2])):
        np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_lm_path_on_the_card_at_small_widths(card):
    """``chip_smoke.lm_path`` at small configs on the card: every check it
    makes, no kernel launched."""
    import chip_smoke
    from repro_torch.configs import deepseek_7b, granite_moe_1b_a400m

    torch.backends.cuda.matmul.allow_tf32 = False
    moe = dataclasses.replace(granite_moe_1b_a400m.CONFIG, n_layers=3, d_model=128, n_heads=4,
                              n_kv_heads=2, d_ff=64, n_experts=8, moe_top_k=2, vocab=1000,
                              kv_chunk=32)
    dense = dataclasses.replace(deepseek_7b.CONFIG, n_layers=4, d_model=128, n_heads=4,
                                n_kv_heads=4, d_ff=256, vocab=1024, kv_chunk=32)
    before = sum(LK.LAUNCHES.values()) + sum(SK.LAUNCHES.values())
    rep = chip_smoke.lm_path(torch, np, 0, {}, device="cuda",
                             configs={chip_smoke.LM_MOE: moe, chip_smoke.LM_DENSE: dense},
                             prefill=dict(batch=2, seq=96), decode=dict(batch=4, seq=64), steps=3,
                             consist=dict(batch=2, seq=40), cpu=dict(layers=2, batch=1, seq=24))
    assert rep[chip_smoke.LM_MOE]["decode"]["sync_free"]
    assert sum(LK.LAUNCHES.values()) + sum(SK.LAUNCHES.values()) == before


def test_index_cells_on_the_card_equal_the_calls_they_wrap(card):
    """The smoke's index-cell checks at the smoke geometry with the kernels
    on: spfresh-1b's searches, update and round through ``get_cell``, bit
    for bit against the calls they wrap (``serve_search_paged`` launches
    #6), and an empty ``CONFIG`` state's bytes on the card equal to the dry
    run's ``meta`` count in 512-byte allocator blocks."""
    import chip_smoke
    from repro_torch.configs.spfresh import SMOKE
    from repro_torch.core.index import build_state

    cfg = dataclasses.replace(SMOKE, use_pallas_nav=True, use_pallas_scan=True,
                              scan_schedule="batched", scan_page_budget=512)
    rng = np.random.default_rng(0)
    base = (rng.normal(size=(12, 16))[rng.integers(0, 12, 1500)]
            + 0.05 * rng.normal(size=(1500, 16))).astype(np.float32)
    state = build_state(cfg, base, seed=0, device="cuda")
    out = {}
    chip_smoke.fp32_index_cells(torch, out, state, torch.as_tensor(base[:64] + 0.01, device=card),
                                torch.as_tensor(base[:96], device=card))
    chip_smoke.maintain_index_cell(torch, out, state)
    assert out["serve_search_paged"]["launches"]["scan_batched_topk_pairs"] >= 1
    recs = chip_smoke.index_cells_records(torch, out)
    assert out["empty_config_state"]["card_delta"] == out["empty_config_state"]["meta_bytes_in_blocks"]
    assert all(r["status"] == "ok" for r in recs.values()) and len(recs) == 6
