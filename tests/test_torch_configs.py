"""The port's cell registry (``repro_torch.configs``) against the
reference's: the ported archs, their exact configs, every cell's smoke
batch (the same draws as the reference's), a smoke step of every cell
(finite, a train step moves the parameters), and every serving cell's
step on the reference's params at f32 rtol = atol = 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_cell
from repro_torch import configs as C
from repro_torch.configs import bert4rec, deepfm, mind, two_tower_retrieval
from repro_torch.convert import param_leaves
from tests.test_torch_train import ref_inputs

PORTED = {"bert4rec", "mind", "two-tower-retrieval", "deepfm"}
MODULES = {"bert4rec": bert4rec, "mind": mind, "two-tower-retrieval": two_tower_retrieval,
           "deepfm": deepfm}
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
CELLS = C.all_cells()


def test_registry_holds_the_ported_archs():
    assert set(C.arch_names()) == PORTED
    for arch in PORTED:
        assert [c.shape for c in C.get_cells(arch)] == list(SHAPES)
        assert all(c.family == "recsys" and c.skip_reason is None for c in C.get_cells(arch))
    assert C.get_cell("mind", "serve_bulk").kind == "serve"
    assert C.get_cell("deepfm", "train_batch").donate_argnums == (0, 1)
    with pytest.raises(KeyError, match="ROADMAP.md queue 1 item 9"):
        C.get_cells("granite-20b")
    with pytest.raises(KeyError, match="ROADMAP.md queue 1 item 10"):
        C.get_cell("spfresh-1b", "maintain")
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
