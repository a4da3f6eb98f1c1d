"""The port's cell registry (``repro_torch.configs``) against the
reference's: the ported archs, their exact configs, every cell's smoke
batch (the same draws as the reference's), a smoke step of every cell
(finite, a train step moves the parameters, a decode step writes its
cache in place), every serving cell's step on the reference's params at
f32 rtol = atol = 1e-5, and one train step of every LM arch's ``train_4k``
cell against the reference's (loss and ``grad_norm`` rtol 1e-5, the
updated state at the training tests' rtol 1e-4, atol 1e-5).  The GAT's
four cells: the config and shapes exact, each smoke batch the reference's
draws (the fanout sampler's arrays for ``minibatch_lg``), each smoke step
finite and moving every leaf.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_cell
from repro_torch import configs as C
from repro_torch import convert
from repro_torch.configs import bert4rec, deepfm, gat_cora, mind, two_tower_retrieval
from repro_torch.convert import param_leaves
from repro_torch.train.optimizer import adamw_init
from tests.test_torch_lm import ARCHS as LM_MODULES
from tests.test_torch_train import STEP, assert_state_close, ref_inputs

PORTED = {"bert4rec", "mind", "two-tower-retrieval", "deepfm"}
LM_ARCHS = set(LM_MODULES)
MODULES = {"bert4rec": bert4rec, "mind": mind, "two-tower-retrieval": two_tower_retrieval,
           "deepfm": deepfm}
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# the recsys cells with smoke inputs (not the index-served retrieval_cand_ann)
CELLS = [c for c in C.all_cells() if c.family == "recsys" and c.make_mesh_step is None]
LM_CELLS = [c for c in C.all_cells() if c.family == "lm"]
GNN_CELLS = [c for c in C.all_cells() if c.family == "gnn"]


def test_registry_holds_the_ported_archs():
    assert set(C.arch_names()) == PORTED | LM_ARCHS | {"gat-cora", "spfresh-1b"}
    for arch in PORTED:
        extra = ["retrieval_cand_ann"] if arch == "two-tower-retrieval" else []
        assert [c.shape for c in C.get_cells(arch)] == extra + list(SHAPES)
        assert all(c.family == "recsys" and c.skip_reason is None for c in C.get_cells(arch))
    for arch in LM_ARCHS:
        cells = C.get_cells(arch)
        assert [c.shape for c in cells] == list(LM_SHAPES)
        assert [c.kind for c in cells] == ["train", "prefill", "decode", "decode"]
        assert [c.donate_argnums for c in cells] == [(0, 1), (), (1,), (1,)]
        assert all(c.family == "lm" for c in cells)
        assert [c.skip_reason is None for c in cells] == [True, True, True, False]
    gnn_cells = C.get_cells("gat-cora")
    assert [c.shape for c in gnn_cells] == list(GNN_SHAPES)
    assert all(c.family == "gnn" and c.kind == "train" and c.skip_reason is None
               and c.donate_argnums == (0, 1) for c in gnn_cells)
    assert len(C.all_cells(include_skipped=False)) == len(C.all_cells()) - len(LM_ARCHS)
    assert C.get_cell("mind", "serve_bulk").kind == "serve"
    assert C.get_cell("deepfm", "train_batch").donate_argnums == (0, 1)
    import repro_torch.configs as registry
    assert not hasattr(registry, "_NOT_PORTED")
    assert [c.shape for c in C.get_cells("spfresh-1b")] == [
        "serve_search", "serve_search_paged", "serve_search_grouped", "serve_update", "maintain"]
    assert C.get_cell("spfresh-1b", "maintain").family == "index"
    assert len(C.all_cells()) == 46
    with pytest.raises(KeyError):
        C.get_cells("no-such-arch")


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_exact_assigned_configs(arch):
    from repro.configs import bert4rec as rb, deepfm as rd, mind as rm
    from repro.configs import two_tower_retrieval as rt

    ref = {"bert4rec": rb, "mind": rm, "two-tower-retrieval": rt, "deepfm": rd}[arch]
    mod = MODULES[arch]
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(ref.SMOKE)
    for shape in SHAPES:
        r, t = ref_cell(arch, shape), C.get_cell(arch, shape)
        assert (t.kind, t.family) == (r.kind, r.family)
        assert dataclasses.asdict(t.model_cfg) == dataclasses.asdict(r.model_cfg)
        assert dataclasses.asdict(t.smoke_cfg) == dataclasses.asdict(r.smoke_cfg)
    df, tt, b4, mi = deepfm.CONFIG, two_tower_retrieval.CONFIG, bert4rec.CONFIG, mind.CONFIG
    assert (df.n_fields, df.embed_dim, df.mlp_dims) == (39, 10, (400, 400, 400))
    assert (tt.embed_dim, tt.tower_dims) == (256, (1024, 512, 256))
    assert (b4.embed_dim, b4.n_blocks, b4.n_heads, b4.seq_len) == (64, 2, 2, 200)
    assert (mi.embed_dim, mi.n_interests, mi.capsule_iters) == (64, 4, 3)
    assert bert4rec.N_MASK == 4


def _struct(arch, cell, sh):
    mod = MODULES[arch]
    if arch == "deepfm":
        return mod._batch_struct(cell.smoke_cfg, {**sh, "kind": cell.kind})
    return mod._batch_struct(cell.smoke_cfg, sh, cell.kind, cell.shape)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.name)
def test_smoke_batches_are_the_reference_draws(cell):
    from repro_torch.configs.common import RECSYS_SMOKE_SHAPES

    r = ref_cell(cell.arch, cell.shape)
    want = r.make_smoke_inputs(r.smoke_cfg, np.random.default_rng(7))[-1]
    got = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(7), device="cpu")[-1]
    struct = _struct(cell.arch, cell, RECSYS_SMOKE_SHAPES[cell.shape])
    assert set(got) == set(want) == set(struct)
    for k in want:
        assert got[k].dtype == struct[k].dtype and got[k].shape == struct[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.name)
def test_cell_smoke(cell):
    args = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(42), device="cpu")
    before = [t.detach().clone() for _, t, _ in param_leaves(args[0])]
    out = cell.smoke_step_fn(*args)
    leaves = [out] if isinstance(out, torch.Tensor) else (
        [t for _, t, _ in param_leaves(out[0])] + list(out[1]["m"]) + list(out[2].values()))
    assert leaves
    for leaf in leaves:
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all(), f"{cell.name}: non-finite output"
    if cell.kind == "train":
        assert out[0] is args[0] and out[1] is args[1]              # updated in place
        after = [t for _, t, _ in param_leaves(out[0])]
        assert any(not torch.allclose(a, b) for a, b in zip(before, after)), cell.name
        assert int(out[1]["count"]) == 1
        assert {"loss", "grad_norm", "lr"} <= set(out[2])
    else:
        assert not out.requires_grad


_REF_SERVE: dict = {}


@pytest.mark.parametrize("cell", [c for c in CELLS if c.kind == "serve"], ids=lambda c: c.name)
def test_serving_cells_match_the_reference(cell):
    r = ref_cell(cell.arch, cell.shape)
    rp, _, model, _ = ref_inputs(cell.arch)
    rb = r.make_smoke_inputs(r.smoke_cfg, np.random.default_rng(3))[-1]
    tb = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(3), device="cpu")[-1]
    if cell.name not in _REF_SERVE:
        _REF_SERVE[cell.name] = jax.jit(r.smoke_step_fn)
    want = np.asarray(_REF_SERVE[cell.name](rp, rb))
    got = cell.smoke_step_fn(model, tb)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The LM family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(LM_ARCHS))
def test_exact_lm_configs(arch):
    ref, mod = LM_MODULES[arch]
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(ref.SMOKE)
    for shape in LM_SHAPES:
        r, t = ref_cell(arch, shape), C.get_cell(arch, shape)
        assert (t.kind, t.family, t.skip_reason, t.donate_argnums) == (
            r.kind, r.family, r.skip_reason, r.donate_argnums)
        assert dataclasses.asdict(t.model_cfg) == dataclasses.asdict(r.model_cfg)
        assert dataclasses.asdict(t.smoke_cfg) == dataclasses.asdict(r.smoke_cfg)
    from repro_torch.configs.common import LM_SHAPES as T_SHAPES, LM_SMOKE_SHAPES as T_SMOKE
    from repro.configs.common import LM_SHAPES as R_SHAPES, LM_SMOKE_SHAPES as R_SMOKE
    assert (T_SHAPES, T_SMOKE) == (R_SHAPES, R_SMOKE)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cell", LM_CELLS, ids=lambda c: c.name)
def test_lm_smoke_inputs_are_the_reference_draws(cell):
    """Tokens drawn alike; a decode cell's cache is zeros of the
    reference's shape at ``pos = seq // 2``."""
    r = ref_cell(cell.arch, cell.shape)
    want = r.make_smoke_inputs(r.smoke_cfg, np.random.default_rng(7))[1:]
    got = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(7), device="cpu")[1:]
    if cell.kind == "train":
        want, got = want[1:], got[1:]                   # the optimiser states: test_torch_train
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype in (torch.int32, torch.bfloat16, torch.float32)
                assert tuple(g[k].shape) == np.shape(w[k])
                np.testing.assert_array_equal(_host(g[k]).astype(np.float32),
                                              np.asarray(w[k]).astype(np.float32))
        else:
            assert g.dtype == torch.int32 and tuple(g.shape) == np.shape(w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cell", [c for c in LM_CELLS if c.skip_reason is None],
                         ids=lambda c: c.name)
def test_lm_cell_smoke(cell):
    args = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(42), device="cpu")
    scfg = cell.smoke_cfg
    if cell.kind == "train":
        before = [t.detach().clone() for _, t, _ in param_leaves(args[0])]
        params, opt, metrics = cell.smoke_step_fn(*args)
        assert params is args[0] and opt is args[1] and int(opt["count"]) == 1
        assert all(torch.isfinite(v).all() for v in metrics.values())
        assert {"loss", "ce", "aux", "grad_norm", "lr"} <= set(metrics)
        after = [t for _, t, _ in param_leaves(params)]
        assert any(not torch.equal(a, b) for a, b in zip(before, after))
        return
    logits, cache = cell.smoke_step_fn(*args)
    b = args[1 if cell.kind == "prefill" else 2].shape[0]
    assert logits.shape == (b, scfg.vocab_padded) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all() and not logits.requires_grad
    if cell.kind == "decode":
        assert cache is args[1]                            # donated: written in place
        pos = int(args[3])
        assert cache["k"][:, :, pos].abs().sum() > 0
        assert cache["k"][:, :, pos + 1:].abs().sum() == 0


_REF_TRAIN: dict = {}


@pytest.mark.parametrize("arch", sorted(LM_ARCHS))
def test_lm_train_cell_step_matches_the_reference(arch):
    """One ``train_4k`` smoke step (loss, AdamW) from the reference's
    smoke params, on the same batch."""
    r, t = ref_cell(arch, "train_4k"), C.get_cell(arch, "train_4k")
    params, opt, batch = r.make_smoke_inputs(r.smoke_cfg, np.random.default_rng(5))
    lm = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), t.smoke_cfg,
                                      device="cpu")
    tbatch = t.make_smoke_inputs(t.smoke_cfg, np.random.default_rng(5), device="cpu")[-1]
    if arch not in _REF_TRAIN:
        _REF_TRAIN[arch] = jax.jit(r.smoke_step_fn)
    rp, ro, rm = _REF_TRAIN[arch](params, opt, batch)
    _, opt_t, tm = t.smoke_step_fn(lm, adamw_init(lm), tbatch)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    assert_state_close(jax.tree_util.tree_map(np.asarray, rp), ro, lm, opt_t, STEP)


# ---------------------------------------------------------------------------
# The GNN family (gat-cora)
# ---------------------------------------------------------------------------

def test_exact_gnn_config_and_shapes():
    from repro.configs import gat_cora as rg
    from repro.configs.common import GNN_SHAPES as R_SHAPES, GNN_SMOKE_SHAPES as R_SMOKE
    from repro_torch.configs.common import GNN_SHAPES as T_SHAPES, GNN_SMOKE_SHAPES as T_SMOKE

    assert dataclasses.asdict(gat_cora.CONFIG) == dataclasses.asdict(rg.CONFIG)
    assert (T_SHAPES, T_SMOKE) == (R_SHAPES, R_SMOKE)
    for shape in GNN_SHAPES:
        r, t = ref_cell("gat-cora", shape), C.get_cell("gat-cora", shape)
        assert (t.kind, t.family, t.skip_reason, t.donate_argnums) == (
            r.kind, r.family, r.skip_reason, r.donate_argnums)
        assert dataclasses.asdict(t.model_cfg) == dataclasses.asdict(r.model_cfg)
        assert dataclasses.asdict(t.smoke_cfg) == dataclasses.asdict(r.smoke_cfg)


@pytest.mark.parametrize("cell", GNN_CELLS, ids=lambda c: c.name)
def test_gnn_smoke_inputs_are_the_reference_draws(cell):
    """The batch array for array (``minibatch_lg``: the sampler's), and the
    parameters' shapes and dtypes the reference's."""
    r = ref_cell(cell.arch, cell.shape)
    rp, _, want = r.make_smoke_inputs(r.smoke_cfg, np.random.default_rng(7))
    params, opt, got = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(7),
                                              device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"float32": torch.float32, "int32": torch.int32}[
            str(np.asarray(want[k]).dtype)], k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(rp)]
    assert [tuple(t.shape) for _, t, _ in param_leaves(params)] == shapes
    assert int(opt["count"]) == 0 and len(opt["m"]) == len(shapes)


@pytest.mark.parametrize("cell", GNN_CELLS, ids=lambda c: c.name)
def test_gnn_cell_smoke(cell):
    args = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(42), device="cpu")
    before = [t.detach().clone() for _, t, _ in param_leaves(args[0])]
    params, opt, metrics = cell.smoke_step_fn(*args)
    assert params is args[0] and opt is args[1] and int(opt["count"]) == 1
    assert {"loss", "ce", "acc", "grad_norm", "lr"} <= set(metrics)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    after = [t for _, t, _ in param_leaves(params)]
    assert all(not torch.equal(a, b) for a, b in zip(before, after)), cell.name
