"""Port vs reference for the lossy-codec search: int8 and bf16 hot tiers
with the exact fp32 rerank (``rerank_factor=4``, the reference's int8 cell
in ``benchmarks/bench_search_path.py`` ``CODEC_CELLS``).

Searches run on states the reference built, churned and converted, through
the gather oracle (whole and in probe chunks) and both kernel schedules;
the rerank itself, an insert and a delete are compared directly; the
port's own build is held to the reference's recall-floor gate
(``tests/test_codec.py::test_int8_rerank_recall_floor``).  The port runs
on the CPU (each kernel wrapper's plain version); the reference runs its
Pallas kernels in interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lire as rlire
from repro.core.index import SPFreshIndex as RIndex
from repro.core.types import LireConfig as RConfig
from repro_torch import convert
from repro_torch.core import lire as tlire
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.types import LireConfig as TConfig
from repro_torch.data.vectors import make_sift_like
from tests.conftest import make_clustered
from tests.test_torch_index import assert_tie_tolerant
from tests.test_torch_storage import assert_leaves_equal, ref_leaves

RERANK = 4


def _cfg_kw(**kw):
    # split_limit 24 → build postings of ~14: some 45 postings, so that
    # nprobe=32 in chunks of 16 probes real postings in both chunks
    args = dict(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=2048,
                num_postings_cap=256, num_vectors_cap=8192, split_limit=24,
                merge_limit=6, reassign_range=8, reassign_budget=128,
                replica_count=2, nprobe=8, rerank_factor=RERANK)
    args.update(kw)
    return args


_CACHE = {}


def _churned(codec):
    """A reference index with the ``codec`` hot tier after build + insert +
    delete + maintenance; the port's config beside it."""
    if codec not in _CACHE:
        rng = np.random.default_rng(17)
        base = make_clustered(rng, 600, 16, n_clusters=8)
        idx = RIndex.build(RConfig(**_cfg_kw(codec=codec)), base)
        extra = make_clustered(rng, 150, 16, n_clusters=4)
        idx.insert(extra, np.arange(3000, 3150, dtype=np.int32))
        idx.delete(rng.choice(600, size=80, replace=False).astype(np.int32))
        idx.maintain()
        queries = (np.concatenate([base[100:116], extra[:16]])
                   + 0.01 * rng.normal(size=(32, 16))).astype(np.float32)
        _CACHE[codec] = (idx, TConfig(**_cfg_kw(codec=codec)), queries)
    return _CACHE[codec]


def _to_port(ref_state, tcfg):
    return convert.state_from_numpy(tcfg, ref_leaves(ref_state), device="cpu")


# ---------------------------------------------------------------------------
# search with rerank on converted reference states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("path", ["oracle", "oracle_chunked", "per_query", "batched"])
def test_rerank_search_on_converted_state_matches(codec, path):
    idx, tcfg, queries = _churned(codec)
    kw = dict(k=10, nprobe=8)
    if path in ("per_query", "batched"):
        kw.update(use_pallas_scan=True, scan_schedule=path)
    if path == "oracle_chunked":
        kw.update(nprobe=32, probe_chunk=16)
    port = _to_port(idx.state, tcfg)
    d0, v0 = rlire.search(idx.state, jnp.asarray(queries), **kw)
    d1, v1 = tlire.search(port, torch.as_tensor(queries), **kw)
    assert_tie_tolerant(d0, v0, d1.numpy(), v1.numpy())
    # the rerank ran: every distance is the exact diff² of its vid's vector
    exact = port.pool.blocks_exact.reshape(-1, 16)
    vid_at = port.pool.block_vid.reshape(-1)
    v1, d1 = v1.numpy(), d1.numpy()
    for qi in range(len(queries)):
        for vid, dist in zip(v1[qi], d1[qi]):
            rows = exact[vid_at == int(vid)].numpy()
            true = ((rows[0] - queries[qi]) ** 2).sum()
            assert abs(true - dist) <= 1e-5 * max(1.0, true), (qi, vid)


def test_rerank_search_batched_budget_overflow_matches():
    """A page budget below the probed pages: the dropped probes write the
    spare scale/zero row, which is cut."""
    idx, tcfg, queries = _churned("int8")
    rstate = idx.state.replace(cfg=dataclasses.replace(idx.state.cfg, scan_page_budget=16))
    port = _to_port(idx.state, dataclasses.replace(tcfg, scan_page_budget=16))
    kw = dict(k=10, nprobe=8, use_pallas_scan=True, scan_schedule="batched")
    d0, v0 = rlire.search(rstate, jnp.asarray(queries), **kw)
    d1, v1 = tlire.search(port, torch.as_tensor(queries), **kw)
    assert_tie_tolerant(d0, v0, d1.numpy(), v1.numpy())


def test_rerank_exact_matches_reference(rng):
    """``_rerank_exact`` alone: dead positions, dead vids and exact ties
    (one position twice) — lowest candidate index first, as top_k."""
    idx, tcfg, queries = _churned("int8")
    port = _to_port(idx.state, tcfg)
    live_pos = np.flatnonzero(np.asarray(idx.state.pool.block_vid).reshape(-1) >= 0)
    q_n, kq, k = len(queries), 40, 10
    pos = rng.choice(live_pos, size=(q_n, kq)).astype(np.int32)
    pos[rng.random(size=(q_n, kq)) < 0.1] = -1
    vids = np.asarray(idx.state.pool.block_vid).reshape(-1)[np.maximum(pos, 0)]
    vids = np.where(pos >= 0, vids, -1).astype(np.int32)
    vids[:, 11] = -1                                        # a dead vid
    # an exact tie at distance 0 between candidates 3 and 7 (one position
    # under two vids): the first half of the queries sit on that vector
    pos[:, 3] = live_pos[:q_n]
    pos[:, 7] = pos[:, 3]
    vids[:, 3] = np.asarray(idx.state.pool.block_vid).reshape(-1)[pos[:, 3]]
    vids[:, 7] = 90_000 + np.arange(q_n)
    queries = queries.copy()
    exact = np.asarray(idx.state.pool.blocks_exact).reshape(-1, 16)
    queries[: q_n // 2] = exact[pos[: q_n // 2, 3]]
    cand_d = rng.random(size=(q_n, kq)).astype(np.float32)
    rd, rv = rlire._rerank_exact(idx.state, jnp.asarray(queries), jnp.asarray(cand_d),
                                 jnp.asarray(vids), jnp.asarray(pos), k)
    td, tv = tlire._rerank_exact(port, torch.as_tensor(queries), torch.as_tensor(cand_d),
                                 torch.as_tensor(vids), torch.as_tensor(pos), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-7)
    assert (tv.numpy()[: q_n // 2, :2] == vids[: q_n // 2][:, [3, 7]]).all()


def test_kernel_paths_agree_with_oracle_on_int8():
    """Both q8 kernel schedules against the gather oracle on one int8
    state: id overlap >= 0.95 (tests/test_kernel_integration.py)."""
    idx, tcfg, queries = _churned("int8")
    port = _to_port(idx.state, dataclasses.replace(tcfg, use_pallas_nav=True))
    q = torch.as_tensor(queries)
    _, v0 = tlire.search(port, q, k=10, nprobe=8, use_pallas_scan=False)
    for sched in ("per_query", "batched"):
        _, v1 = tlire.search(port, q, k=10, nprobe=8, use_pallas_scan=True,
                             scan_schedule=sched)
        overlap = np.mean([len(set(a) & set(b)) / 10
                           for a, b in zip(v0.tolist(), v1.tolist())])
        assert overlap >= 0.95, (sched, overlap)


# ---------------------------------------------------------------------------
# insert / delete on an int8 state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nav", [False, True])
def test_int8_insert_and_delete_match_reference(nav):
    idx, tcfg, _ = _churned("int8")
    rng = np.random.default_rng(23)
    rstate = idx.state.replace(cfg=dataclasses.replace(idx.state.cfg, use_pallas_nav=nav))
    port = _to_port(idx.state, dataclasses.replace(tcfg, use_pallas_nav=nav))
    vecs = make_clustered(rng, 64, 16, n_clusters=3)
    vecs[:4] *= 3.0                                         # outside the posting's range: clipped codes
    vids = np.arange(5000, 5064, dtype=np.int32)
    vids[5] = 12                                            # re-insert of a live id
    valid = np.arange(64) < 60
    rstate, rl = rlire.insert_batch(rstate, jnp.asarray(vecs), jnp.asarray(vids),
                                    jnp.asarray(valid))
    port, tl = tlire.insert_batch(port, torch.as_tensor(vecs), torch.as_tensor(vids),
                                  torch.as_tensor(valid))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(rl))
    dv = np.concatenate([vids[:20], [-1, 3, 3]]).astype(np.int32)
    dvalid = np.ones(len(dv), bool)
    dvalid[-1] = False
    rstate = rlire.delete_batch(rstate, jnp.asarray(dv), jnp.asarray(dvalid))
    port = tlire.delete_batch(port, torch.as_tensor(dv), torch.as_tensor(dvalid))
    # drift_vec: the same f32 adds in another order than XLA's scatter-add
    assert_leaves_equal(port, rstate, close=("telemetry.drift_vec",), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# recall floor of the port's own build (tests/test_codec.py:423)
# ---------------------------------------------------------------------------

def _recall_cell(codec: str, rerank_factor: int) -> float:
    n, dim, k = 600, 16, 10
    base = make_sift_like(n, dim, seed=41)
    cfg = TConfig(dim=dim, block_size=4, max_blocks_per_posting=4, num_blocks=1024,
                  num_postings_cap=128, num_vectors_cap=4096, split_limit=12,
                  merge_limit=2, reassign_range=4, reassign_budget=32,
                  replica_count=1, nprobe=4, codec=codec, rerank_factor=rerank_factor)
    idx = TIndex.build(cfg, base, device="cpu")
    rng = np.random.default_rng(42)
    queries = (base[rng.integers(0, n, 24)]
               + 0.02 * rng.normal(size=(24, dim))).astype(np.float32)
    d = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :k]
    _, got = idx.search(queries, k, nprobe=8)
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(gt, got)) / gt.size


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_rerank_recall_floor(codec):
    """The lossy tier with the exact rerank within 0.01 recall@10 of fp32."""
    r_fp32 = _recall_cell("fp32", 1)
    r_lossy = _recall_cell(codec, RERANK)
    assert r_fp32 - r_lossy <= 0.01, (r_fp32, r_lossy)
