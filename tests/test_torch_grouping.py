"""Two-level centroid routing, port against reference.

The reference's group index is drawn by JAX's PRNG; it is carried into
the port with ``convert.group_index_from_numpy`` together with the index
state, so both navigate the same groups.  Level 2 takes the direct f32
``diff²`` on both sides (summed in another order): distances are held to
``rtol = 1e-5``, ids equal up to distance ties.  The reference's own
checks — exactness at full ``gprobe``, recall at small ``gprobe``,
graceful staleness — then run on the port's own group build.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grouping as rgrouping
from repro.core.index import SPFreshIndex as RIndex
from repro_torch import convert
from repro_torch.core import grouping, lire
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.types import LireConfig as TConfig
from tests.conftest import make_clustered
from tests.test_lire import brute_force_knn, small_cfg
from tests.test_torch_storage import ref_leaves

RTOL = 1e-5


_PAIR = {}


def _pair(rng):
    """A reference index and group index (built once, from seed 0), and
    their port twins on the CPU."""
    if not _PAIR:
        base = make_clustered(np.random.default_rng(0), 1200, 16, n_clusters=10)
        ridx = RIndex.build(small_cfg(), base)
        rg = rgrouping.build_group_index(ridx.state, n_groups=8, capacity=64)
        tcfg = TConfig(**dataclasses.asdict(small_cfg()))
        _PAIR["v"] = (base, ridx, rg, convert.state_from_numpy(
            tcfg, ref_leaves(ridx.state), device="cpu"))
    base, ridx, rg, tstate = _PAIR["v"]
    tg = convert.group_index_from_numpy(
        {k: np.asarray(getattr(rg, k)) for k in ("group_centroids", "group_sqn", "members",
                                                 "member_valid")}, device="cpu")
    return base, ridx, rg, tstate, tg


def _tie_tolerant(d0, v0, d1, v1):
    np.testing.assert_allclose(d1, d0, rtol=RTOL, atol=1e-6)
    swap = v0 != v1
    assert (np.abs(d0 - d1)[swap] <= RTOL * np.abs(d0[swap]) + 1e-6).all()


@pytest.mark.parametrize("gprobe", [8, 3, 1])
def test_navigate_grouped_equals_the_reference(rng, gprobe):
    base, ridx, rg, tstate, tg = _pair(rng)
    q = base[:24]
    d0, p0 = rgrouping.navigate_grouped(ridx.state, rg, jnp.asarray(q), nprobe=8, gprobe=gprobe)
    d1, p1 = grouping.navigate_grouped(tstate, tg, torch.as_tensor(q), nprobe=8, gprobe=gprobe)
    _tie_tolerant(np.asarray(d0), np.asarray(p0), d1.numpy(), p1.numpy())
    assert p1.dtype == torch.int32


@pytest.mark.parametrize("schedule", ["oracle", "batched", "per_query"])
def test_search_grouped_equals_the_reference(rng, schedule):
    base, ridx, rg, tstate, tg = _pair(rng)
    q = base[rng.integers(0, len(base), 16)] + 0.01 * rng.normal(size=(16, 16)).astype(np.float32)
    kw = {} if schedule == "oracle" else dict(use_pallas_scan=True, scan_schedule=schedule)
    d0, v0 = rgrouping.search_grouped(ridx.state, rg, jnp.asarray(q), k=10, nprobe=8, gprobe=3,
                                      **kw)
    d1, v1 = grouping.search_grouped(tstate, tg, torch.as_tensor(q), k=10, nprobe=8, gprobe=3,
                                     **kw)
    d0, v0, d1, v1 = np.asarray(d0), np.asarray(v0), d1.numpy(), v1.numpy()
    # the kernel path's f32 expansion errs with ||q||², not with d
    scale = np.abs(d0) + (0 if schedule == "oracle" else np.sum(q * q, 1, keepdims=True))
    assert (np.abs(d0 - d1) <= RTOL * scale + 1e-6).all()
    swap = v0 != v1
    assert (np.abs(d0 - d1)[swap] <= (RTOL * scale + 1e-6)[swap]).all()


def test_grouped_exact_when_probing_all_groups(rng):
    """On the reference's group index, full ``gprobe`` is the flat
    navigation: the reference test's criteria (distances within 1e-4,
    probe overlap > 0.9), on the port."""
    base, _, _, tstate, tg = _pair(rng)
    q = torch.as_tensor(base[:16])
    d0, p0 = lire.navigate(tstate, q, 8)
    d1, p1 = grouping.navigate_grouped(tstate, tg, q, nprobe=8, gprobe=8)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), rtol=1e-4, atol=1e-4)
    overlap = np.mean([len(set(a) & set(b)) / 8 for a, b in zip(p0.tolist(), p1.tolist())])
    assert overlap > 0.9


def _port_index(rng, n, n_clusters):
    base = make_clustered(rng, n, 16, n_clusters=n_clusters)
    return base, TIndex.build(TConfig(**dataclasses.asdict(small_cfg())), base, device="cpu")


def test_port_group_build_exact_at_full_gprobe(rng):
    base, idx = _port_index(rng, 1200, 10)
    gidx = grouping.build_group_index(idx.state, n_groups=8, capacity=64)
    valid = idx.state.centroid_valid.numpy()
    members = gidx.members.numpy()
    held = np.sort(members[members >= 0])
    np.testing.assert_array_equal(held, np.flatnonzero(valid))     # each once
    np.testing.assert_array_equal(gidx.member_valid.numpy(), members >= 0)
    q = torch.as_tensor(base[:16])
    d0, _ = lire.navigate(idx.state, q, 8)
    d1, _ = grouping.navigate_grouped(idx.state, gidx, q, nprobe=8, gprobe=8)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), rtol=1e-4, atol=1e-4)


def test_grouped_search_recall_small_gprobe(rng):
    base, idx = _port_index(rng, 1500, 12)
    gidx = grouping.build_group_index(idx.state, n_groups=16, capacity=32)
    queries = base[rng.integers(0, len(base), 32)] + 0.01 * rng.normal(
        size=(32, 16)).astype(np.float32)
    gt = brute_force_knn(base, np.arange(len(base)), queries, 10)
    _, got = grouping.search_grouped(idx.state, gidx, torch.as_tensor(queries), k=10,
                                     nprobe=8, gprobe=6)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(gt, got.numpy()))
    assert hits / 320 > 0.85


def test_grouped_staleness_degrades_gracefully(rng):
    """Splits between group refreshes leave new centroids unrouted: the
    queries keep working, and a refresh restores fresh-vector recall."""
    base, idx = _port_index(rng, 1000, 8)
    gidx = grouping.build_group_index(idx.state, n_groups=16, capacity=32)
    extra = (base[0][None, :] + 0.02 * rng.normal(size=(200, 16))).astype(np.float32)
    ids = np.arange(5000, 5200, dtype=np.int32)
    idx.insert(extra, ids)
    idx.maintain()
    q = torch.as_tensor(extra[:16])
    _, stale = grouping.search_grouped(idx.state, gidx, q, k=5, nprobe=8, gprobe=6)
    assert stale.shape == (16, 5)
    gidx2 = grouping.build_group_index(idx.state, n_groups=16, capacity=64)
    _, got = grouping.search_grouped(idx.state, gidx2, q, k=5, nprobe=8, gprobe=6)
    found = sum(int(ids[i]) in got[i].tolist() for i in range(16))
    assert found >= 14, f"{found}/16 after refresh"


def test_level2_query_chunks_change_no_result(rng, monkeypatch):
    base, _, _, tstate, tg = _pair(rng)
    q = torch.as_tensor(base[:20])
    whole = grouping.navigate_grouped(tstate, tg, q, nprobe=8, gprobe=4)
    monkeypatch.setattr(grouping, "_GATHER_ELEMS", 3 * 4 * 64 * 16)   # 3 queries a chunk
    chunked = grouping.navigate_grouped(tstate, tg, q, nprobe=8, gprobe=4)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["fits", "overflow", "too_small"])
def test_place_members_follows_the_reference_loop(case):
    """The reference's placement: pid order, overflow to the least-full
    group, refusal when the capacity cannot hold every posting."""
    assign = np.array([0, 0, 0, 1, -1, 0, 2, 0])
    valid = np.array([True, True, True, True, True, True, True, False])
    cap = {"fits": 4, "overflow": 2, "too_small": 1}[case]
    if case == "too_small":
        with pytest.raises(ValueError, match="capacity too small"):
            grouping.place_members(assign, valid, 3, cap)
        return
    got = grouping.place_members(assign, valid, 3, cap)
    want = {"fits": [[0, 1, 2, 5], [3, -1, -1, -1], [6, -1, -1, -1]],
            "overflow": [[0, 1], [2, 3], [5, 6]]}[case]
    np.testing.assert_array_equal(got, np.array(want, np.int32))


def test_group_index_round_trips_through_numpy(rng):
    _, _, rg, _, tg = _pair(rng)
    back = convert.group_index_to_numpy(tg)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(rg, k)))
