"""Port vs reference for two-tower retrieval (``IndexedRetriever``), at the
reference's own test sizes (``tests/test_serve.py``): the reference's
params carried over, the corpus embedded by both, brute force, ANN
retrieval on the reference's built state under both scan schedules, the
port's own build by recall, catalog churn with and without the engine,
and the engine config a ``ServiceSpec`` compiles to.

The port runs on the CPU (the kernel wrappers' plain versions); the
reference its gather oracle.
"""
import dataclasses
from unittest.mock import patch

import jax
import numpy as np
import pytest

from repro.api.spec import IndexSpec as RIndexSpec
from repro.api.spec import MaintenanceSpec as RMaintenanceSpec
from repro.api.spec import ServeSpec as RServeSpec
from repro.api.spec import ServiceSpec as RServiceSpec
from repro.core.types import LireConfig as RConfig
from repro.models import recsys as R
from repro.serve.policy import BacklogPolicy as RBacklogPolicy
from repro.serve.retrieval import IndexedRetriever as RRetriever
from repro_torch import api, convert
from repro_torch.core.index import SPFreshIndex as TIndex
from repro_torch.core.types import LireConfig as TConfig
from repro_torch.models import recsys as T
from repro_torch.serve.policy import BacklogPolicy as TBacklogPolicy
from repro_torch.serve.retrieval import IndexedRetriever as TRetriever
from tests.test_torch_storage import ref_leaves

MODEL = dict(n_items=2000, n_user_fields=4, user_vocab_per_field=100, embed_dim=16,
             tower_dims=(32, 8))
INDEX = dict(dim=8, block_size=8, max_blocks_per_posting=8, num_blocks=4096,
             num_postings_cap=512, num_vectors_cap=16384, split_limit=48, merge_limit=6,
             reassign_range=8, replica_count=2, nprobe=16)
CORPUS = np.arange(1500)
# ANN and brute-force scores on unit vectors: f32 sums in another order
TOL = 1e-5


def _recall(a, b):
    return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b)) / a.size


def _tie_tolerant(s0, i0, s1, i1, tol):
    """Scores within ``tol``; a position's ids differ only inside a tie:
    another position of the row within ``tol`` of its score, or the last
    position (a tie with an item just outside the top-k)."""
    np.testing.assert_allclose(s0, s1, atol=tol)
    for r, j in zip(*np.nonzero(i0 != i1)):
        tied = np.abs(s0[r] - s0[r, j]) <= tol
        assert tied.sum() > 1 or j == s0.shape[1] - 1, (r, j, s0[r], i0[r], i1[r])


@pytest.fixture(scope="module")
def pair():
    """The reference's retriever with its corpus built, and the port's over
    the same params (no index yet)."""
    rcfg = R.TwoTowerConfig(**MODEL)
    rparams = R.twotower_init(jax.random.PRNGKey(0), rcfg)
    ref = RRetriever(rparams, rcfg, RConfig(**INDEX))
    ref.build_corpus(CORPUS)
    tcfg = T.TwoTowerConfig(**MODEL)
    model = convert.twotower_params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams), tcfg,
                                               device="cpu")
    port = TRetriever(model, tcfg, TConfig(**INDEX), device="cpu")
    users = np.random.default_rng(0).integers(0, 100, size=(8, 4)).astype(np.int32)
    return ref, port, users


def test_corpus_embeddings_and_bruteforce_match_the_reference(pair):
    ref, port, users = pair
    np.testing.assert_allclose(port.embed_items(CORPUS, batch=512),
                               ref.embed_items(CORPUS), rtol=1e-5, atol=1e-5)
    port._id_map = CORPUS.copy()
    s1, i1 = port.retrieve_bruteforce(users, k=10)
    s0, i0 = ref.retrieve_bruteforce(users, k=10)
    _tie_tolerant(s0, i0, s1, i1, TOL)


@pytest.mark.parametrize("schedule", ["per_query", "batched"])
def test_retrieve_on_the_reference_state_matches(pair, schedule):
    """The reference's built index carried in by ``convert.state_from_numpy``:
    the port's ``retrieve`` (the kernels' plain versions, ``schedule``)
    returns the reference's ids and scores, ties aside."""
    ref, port, users = pair
    cfg = TConfig(**INDEX, use_pallas_scan=True, scan_schedule=schedule)
    port.index = TIndex(convert.state_from_numpy(cfg, ref_leaves(ref.index.state), device="cpu"))
    port._id_map = CORPUS.copy()
    s1, i1 = port.retrieve(users, k=10)
    s0, i0 = ref.retrieve(users, k=10)
    _tie_tolerant(s0, i0, s1, i1, TOL)


def test_port_build_recall_reaches_the_reference(pair):
    ref, port, users = pair
    port.build_corpus(CORPUS)
    _, ann_t = port.retrieve(users, k=10)
    _, bf_t = port.retrieve_bruteforce(users, k=10)
    _, ann_r = ref.retrieve(users, k=10)
    _, bf_r = ref.retrieve_bruteforce(users, k=10)
    assert _recall(ann_t, bf_t) >= _recall(ann_r, bf_r) - 0.05
    assert _recall(ann_t, bf_t) > 0.8


def _churn_checks(port, fresh, gone, users):
    """Every fresh item finds itself; no removed item comes back, to the
    users or to its own embedding."""
    vid0 = int(np.flatnonzero(port._id_map == fresh[0])[0])
    _, v = port.index.search(port.embed_items(fresh), 10)
    assert all(vid0 + i in v[i] for i in range(len(fresh)))
    _, v = port.index.search(port.embed_items(port._id_map[gone]), 10)
    assert not set(v.ravel().tolist()) & set(gone.tolist())
    _, ids = port.retrieve(users, k=10)
    assert not set(ids.ravel().tolist()) & set(port._id_map[gone].tolist())


def test_churn_with_and_without_the_engine_keeps_the_reference_id_map():
    """``add_items`` then ``remove_items`` on both packages, first on the
    index, then through an engine attached by a ``ServiceSpec`` (the
    reference example's): the id maps stay equal, every fresh item finds
    itself, and no removed item comes back."""
    rcfg = R.TwoTowerConfig(**MODEL)
    rparams = R.twotower_init(jax.random.PRNGKey(0), rcfg)
    tcfg = T.TwoTowerConfig(**MODEL)
    ref = RRetriever(rparams, rcfg, RConfig(**INDEX))
    port = TRetriever(convert.twotower_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, device="cpu"),
        tcfg, TConfig(**INDEX), device="cpu")
    users = np.random.default_rng(1).integers(0, 100, size=(16, 4)).astype(np.int32)
    for r in (ref, port):
        r.build_corpus(CORPUS)
    phases = [(np.arange(1500, 1600), np.arange(0, 300, 3)),
              (np.arange(1600, 1700), np.arange(1, 301, 3))]
    for engine, (fresh, gone) in zip((False, True), phases):
        if engine:
            serve, maint = dict(search_k=10, max_batch=128, policy="backlog"), \
                dict(maintain_budget=16)
            ref.attach_engine(RServiceSpec(index=RIndexSpec(config=RConfig(**INDEX)),
                                           serve=RServeSpec(**serve),
                                           maintenance=RMaintenanceSpec(**maint)),
                              policy=RBacklogPolicy(threshold=1, budget=16))
            port.attach_engine(api.ServiceSpec(index=api.IndexSpec(config=TConfig(**INDEX)),
                                               serve=api.ServeSpec(**serve),
                                               maintenance=api.MaintenanceSpec(**maint)),
                               policy=TBacklogPolicy(threshold=1, budget=16))
        for r in (ref, port):
            r.add_items(fresh)
            r.remove_items(gone)
            r.retrieve(users, k=10)
            if engine:
                r.engine.drain()
        np.testing.assert_array_equal(port._id_map, ref._id_map)
        _churn_checks(port, fresh, gone, users)


def test_smoke_retrieval_path_runs_on_the_cpu():
    """``chip_smoke.retrieval_path`` end to end on the CPU at a small
    width and corpus (the card runs it at ``SERVE_CONFIG``): the floor's
    corpus with its recall floor and oracle check, then both schedules,
    churn checks and the engine phase."""
    import torch

    import chip_smoke

    cfg = dataclasses.replace(T.TwoTowerConfig(**MODEL), dtype="bfloat16")
    icfg = dataclasses.replace(chip_smoke.retrieval_index_cfg(1), **INDEX)
    rep = {}
    chip_smoke.retrieval_path(torch, np, 0, rep, device="cpu", model_cfg=cfg, n=1500, cfg=icfg,
                              floor_n=1000, floor_cfg=icfg, floor=0.5, users_n=32, lookups=2,
                              n_add=64, n_remove=32, bursts=2, engine_add=32, engine_remove=16)
    assert rep["fresh_self_top10"] == {"per_query": 1.0, "batched": 1.0}
    assert min(rep["floor_corpus"]["recall_at_10"].values()) >= 0.5
    assert min(rep["recall_at_10"].values()) >= 0.5
    assert min(rep["oracle_overlap"].values()) >= chip_smoke.ORACLE_OVERLAP
    assert rep["engine_report"]["search"]["n"] > 0


def test_smoke_retrieval_path_serves_the_floor_corpus_when_sizes_match():
    """With ``n`` and ``cfg`` the floor's (the card's default), the path
    serves the floor's index instead of building a second one."""
    import torch

    import chip_smoke

    cfg = dataclasses.replace(T.TwoTowerConfig(**MODEL), dtype="bfloat16")
    icfg = dataclasses.replace(chip_smoke.retrieval_index_cfg(1), **INDEX)
    from repro_torch.serve.retrieval import IndexedRetriever

    built, real = [], IndexedRetriever.build_corpus

    def counting(self, ids):
        built.append(len(ids))
        return real(self, ids)

    rep = {}
    with patch.object(IndexedRetriever, "build_corpus", counting):
        chip_smoke.retrieval_path(torch, np, 0, rep, device="cpu", model_cfg=cfg, n=1000,
                                  cfg=icfg, floor_n=1000, floor_cfg=icfg, floor=0.5, users_n=32,
                                  lookups=2, n_add=64, n_remove=32, bursts=2, engine_add=32,
                                  engine_remove=16)
    assert built == [1000]
    assert rep["build_s"] == rep["floor_corpus"]["build_s"]
    assert rep["fresh_self_top10"] == {"per_query": 1.0, "batched": 1.0}


def test_attach_engine_compiles_a_service_spec_like_the_reference(pair):
    ref, port, _ = pair
    port.build_corpus(CORPUS)
    kw = dict(serve=dict(search_k=10, max_batch=128, policy="backlog"),
              maintenance=dict(maintain_budget=16))
    rspec = RServiceSpec(index=RIndexSpec(config=RConfig(**INDEX)),
                         serve=RServeSpec(**kw["serve"]),
                         maintenance=RMaintenanceSpec(**kw["maintenance"]))
    tspec = api.ServiceSpec(index=api.IndexSpec(config=TConfig(**INDEX)),
                            serve=api.ServeSpec(**kw["serve"]),
                            maintenance=api.MaintenanceSpec(**kw["maintenance"]))
    got = dataclasses.asdict(port.attach_engine(tspec).cfg)
    want = dataclasses.asdict(rspec.engine_config())
    assert got == want
    assert port.engine.backend.index is port.index
