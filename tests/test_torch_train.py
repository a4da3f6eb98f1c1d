"""Port vs reference for the training substrate (``repro_torch.train``):
AdamW, the schedule, the ``train_batch`` cells' steps, the ``Trainer``
and its checkpoints, on the reference's params carried over by
``convert``.

The GAT's four cells take the same five-step and checkpoint tests as
the recsys families.

Tolerances: one ``adamw_update`` from the same gradients has ``count``
and ``lr`` exact and the parameters, ``m`` and ``v`` at rtol = atol =
1e-6; five steps of a cell at rtol 1e-4, atol 1e-5 (the gradients differ
in their last bits, AdamW divides by their root); a checkpoint written by
either package restores in the other bit for bit; the port's restart is
bit for bit (the reference's own test holds it at rtol 1e-5).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_cell
from repro.train import checkpoint as RCK
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import adamw_update as r_adamw_update
from repro.train.optimizer import schedule as r_schedule
from repro_torch import convert
from repro_torch.configs import get_cell as port_cell
from repro_torch.configs import deepfm as TDF
from repro_torch.models import recsys as T
from repro_torch.models import transformer as TT
from repro_torch.storage import snapshot as TSNAP
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                         schedule, value_and_grad)
from repro_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_recsys import FAMILIES, _np, family
from tests.test_torch_lm import one_thread  # noqa: F401  (a fixture)

STEP = dict(rtol=1e-4, atol=1e-5)
ARCHS = {"deepfm": "deepfm", "two-tower": "two-tower-retrieval", "bert4rec": "bert4rec",
         "mind": "mind"}
# the GAT's train cells, named ``arch/shape`` (a recsys arch's is its train_batch)
GNN_CELLS = ["gat-cora/full_graph_sm", "gat-cora/minibatch_lg", "gat-cora/ogb_products",
             "gat-cora/molecule"]
_REF_STEP: dict = {}


def _cell(name):
    """``(arch, shape)`` of a cell named ``arch`` or ``arch/shape``."""
    arch, _, shape = name.partition("/")
    return arch, shape or "train_batch"


def ref_step(arch):
    """The reference cell's ``smoke_step_fn``, compiled once."""
    if arch not in _REF_STEP:
        _REF_STEP[arch] = jax.jit(ref_cell(*_cell(arch)).smoke_step_fn)
    return _REF_STEP[arch]


def ref_inputs(arch, seed=0):
    """The reference cell's smoke inputs (numpy leaves) and the port's
    over the same params: ``(ref params, ref opt, port params, port opt)``."""
    cell = ref_cell(*_cell(arch))
    params, opt, _ = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(seed))
    pc = port_cell(*_cell(arch))
    from_np = {"deepfm": convert.deepfm_params_from_numpy,
               "two-tower-retrieval": convert.twotower_params_from_numpy,
               "bert4rec": convert.bert4rec_params_from_numpy,
               "mind": convert.mind_params_from_numpy,
               "gat-cora": convert.gnn_params_from_numpy}[pc.arch]
    model = from_np(_np(params), pc.smoke_cfg, device="cpu")
    return params, opt, model, adamw_init(model)


def batches(arch, step):
    """Step ``step``'s smoke batch from both packages (the same draws)."""
    rc, pc = ref_cell(*_cell(arch)), port_cell(*_cell(arch))
    rb = rc.make_smoke_inputs(rc.smoke_cfg, np.random.default_rng(step))[-1]
    tb = pc.make_smoke_inputs(pc.smoke_cfg, np.random.default_rng(step), device="cpu")[-1]
    return rb, tb


def assert_state_close(ref_params, ref_opt, model, opt, tol, *, exact=False):
    """Every leaf of the port's ``(params, opt_state)`` against the
    reference's, in the reference's layout."""
    got = jax.tree_util.tree_leaves((convert.params_to_numpy(model),
                                     convert.adamw_state_to_numpy(opt, model)))
    want = jax.tree_util.tree_leaves((ref_params, ref_opt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count0,warmup", [(0, 100), (7, 50)])
def test_one_adamw_update_matches_the_reference(count0, warmup):
    """From the same gradients (clipped: their norm is above ``clip_norm``)
    and moments: ``count`` and ``lr`` exact (in the warmup, see the
    schedule's test), the rest at 1e-6."""
    _, _, tree, model, _ = family("two-tower")
    rng = np.random.default_rng(3)
    leaves = convert.param_leaves(model)
    ref_grads = convert.tree_from_paths(
        (path, rng.normal(size=np.shape(_leaf(tree, path))).astype(np.float32))
        for path, _, _ in leaves)
    opt = adamw_init(model)
    if count0:
        for m, v in zip(opt["m"], opt["v"]):
            m.copy_(torch.as_tensor(rng.normal(size=m.shape).astype(np.float32)))
            v.copy_(torch.as_tensor(rng.random(size=v.shape).astype(np.float32)))
        opt["count"].fill_(count0)
    ref_opt = jax.tree_util.tree_map(jnp.asarray, convert.adamw_state_to_numpy(opt, model))
    grads = [torch.as_tensor(_leaf(ref_grads, path)).T.contiguous() if tr else
             torch.as_tensor(_leaf(ref_grads, path)) for path, _, tr in leaves]
    cfg = AdamWConfig(warmup_steps=warmup, decay_steps=50)
    rp, ro, rm = jax.jit(r_adamw_update, static_argnums=3)(
        ref_grads, ref_opt, tree, RAdamWConfig(**dataclasses.asdict(cfg)))
    _, opt, tm = adamw_update(grads, opt, model, cfg)
    assert int(opt["count"]) == int(ro["count"]) == count0 + 1
    assert float(tm["lr"]) == float(rm["lr"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    assert float(tm["grad_norm"]) > cfg.clip_norm
    assert_state_close(_np(rp), ro, model, opt, dict(rtol=1e-6, atol=1e-6))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("warmup,decay", [(10, 100), (100, 10_000), (7, 45)])
def test_schedule_matches_the_reference_at_every_step(warmup, decay):
    """Against the reference's compiled schedule, as its train step runs
    it: exact through the warmup (products of constants; cos(0) = 1), and
    within 1e-6 past it, where torch's and XLA's cos differ in the last
    bit."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, decay_steps=decay)
    rcfg = RAdamWConfig(**dataclasses.asdict(cfg))
    steps = np.unique(np.linspace(0, decay + 30, 400).astype(np.int32))
    got = schedule(cfg, torch.as_tensor(steps)).numpy()
    want = np.asarray(jax.jit(r_schedule, static_argnums=0)(rcfg, jnp.asarray(steps)))
    warm = steps <= warmup
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lr0 = float(schedule(cfg, torch.tensor(0)))
    lr10 = float(schedule(cfg, torch.tensor(10)))
    lr100 = float(schedule(cfg, torch.tensor(100)))
    assert lr0 < 0.2 * lr10
    assert abs(lr10 - 1.0) < 1e-5
    assert abs(lr100 - 0.1) < 1e-2


def test_adamw_updates_params():
    params = {"w": torch.ones((4, 4))}
    grads = [torch.full((4, 4), 0.5)]
    opt = adamw_init(params)
    before = params["w"].clone()
    new_p, new_opt, m = adamw_update(grads, opt, params, AdamWConfig(lr=0.1, warmup_steps=1))
    assert new_p is params and not torch.allclose(new_p["w"], before)
    assert int(new_opt["count"]) == 1
    assert float(m["grad_norm"]) > 0
    np.testing.assert_allclose(float(global_norm(grads)), 2.0, rtol=1e-7)


def test_value_and_grad_gives_zeros_for_an_unreached_leaf():
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    (loss, _), grads = value_and_grad(lambda p, b: ((p["a"] * 2).sum(), {}), params, {})
    assert float(loss) == 6.0
    assert torch.equal(grads[0], torch.full((3,), 2.0)) and torch.equal(grads[1], torch.zeros(2))


# ---------------------------------------------------------------------------
# The train_batch cells, five steps against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS.values()) + GNN_CELLS)
def test_five_cell_steps_match_the_reference(arch):
    rp, ro, model, opt = ref_inputs(arch)
    step = port_cell(*_cell(arch)).smoke_step_fn
    for s in range(5):
        rb, tb = batches(arch, s)
        for k in rb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]))
        rp, ro, rm = ref_step(arch)(rp, ro, rb)
        model, opt, tm = step(model, opt, tb)
        assert set(tm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), err_msg=k, **STEP)
        assert float(tm["lr"]) == float(rm["lr"])
    assert_state_close(_np(rp), ro, model, opt, STEP)


# ---------------------------------------------------------------------------
# The Trainer (twins of tests/test_trainer.py on DeepFM and its tiny LM)
# ---------------------------------------------------------------------------

def deepfm_batch_fn(b=64):
    """A learnable task: the label is field 0's id below half the vocab."""
    cfg = TDF.SMOKE

    def batch_fn(step):
        rng = np.random.default_rng(step)
        fields = rng.integers(0, cfg.vocab_per_field, size=(b, cfg.n_fields)).astype(np.int32)
        return {"fields": fields,
                "labels": (fields[:, 0] < cfg.vocab_per_field // 2).astype(np.int32)}
    return batch_fn


def tiny_lm():
    """The reference trainer test's tiny LM (with the remat, the default)."""
    return TT.LMConfig(name="tiny", vocab=64, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                       d_ff=64, dtype="float32", kv_chunk=16)


def lm_batch_fn(cfg, batch=4, seq=16):
    """The reference's: the second half of each sequence repeats the first."""
    def batch_fn(step):
        toks = np.random.default_rng(step).integers(0, cfg.vocab, size=(batch, seq))
        toks[:, seq // 2:] = toks[:, : seq - seq // 2]
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}
    return batch_fn


TRAINER_FAMILIES = {
    "deepfm": (lambda: (lambda p, b: T.deepfm_loss(p, b, TDF.SMOKE)),
               lambda: T.deepfm_init(torch.Generator().manual_seed(0), TDF.SMOKE, device="cpu"),
               deepfm_batch_fn, "bce"),
    "lm": (lambda: (lambda p, b: TT.loss_fn(p, b, tiny_lm())),
           lambda: TT.init_params(torch.Generator().manual_seed(0), tiny_lm(), device="cpu"),
           lambda: lm_batch_fn(tiny_lm()), "ce"),
}


def make_trainer(ckpt_dir, total=30, family="deepfm"):
    loss, init, batch_fn, _ = TRAINER_FAMILIES[family]
    return Trainer(
        loss_fn=loss(),
        init_params_fn=init,
        batch_fn=batch_fn(),
        opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=5, decay_steps=total),
        trainer_cfg=TrainerConfig(total_steps=total, checkpoint_every=10, log_every=5),
        ckpt_dir=ckpt_dir,
        device="cpu",
    )


@pytest.mark.parametrize("family", sorted(TRAINER_FAMILIES))
def test_loss_decreases(tmp_path, family, one_thread):
    t = make_trainer(str(tmp_path / "ck"), family=family)
    res = t.run()
    assert res["final_step"] == 30
    assert [h["step"] for h in t.history] == [5, 10, 15, 20, 25, 30]
    assert res["final_loss"] < t.history[0]["loss"] * 0.9
    assert {"loss", "grad_norm", "lr", TRAINER_FAMILIES[family][3], "dt"} <= set(t.history[0])


@pytest.mark.parametrize("family", sorted(TRAINER_FAMILIES))
def test_restart_resumes_bit_for_bit(tmp_path, family, one_thread):
    t1 = make_trainer(str(tmp_path / "a"), family=family)
    res1 = t1.run()
    t2 = make_trainer(str(tmp_path / "b"), family=family)
    t2.run(steps=20)
    assert CheckpointStore(str(tmp_path / "b")).steps() == [10, 20]
    t3 = make_trainer(str(tmp_path / "b"), family=family)
    res3 = t3.run()
    assert res3["final_step"] == 30 and res3["final_loss"] == res1["final_loss"]
    a = convert.train_state_leaves(t1.params, t1.opt_state)
    b = convert.train_state_leaves(t3.params, t3.opt_state)
    assert len(a) == len(b)
    for (x, _), (y, _) in zip(a, b):
        assert torch.equal(x, y)
    _, step, extra = CheckpointStore(str(tmp_path / "b")).restore_latest(
        (t3.params, t3.opt_state))
    assert step == 30 and extra == {"straggler_steps": t3.straggler_steps}


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["two-tower-retrieval", "bert4rec", "gat-cora/minibatch_lg"])
def test_a_reference_checkpoint_restores_in_the_port_and_continues(arch, tmp_path):
    """The reference trains N=3 steps and checkpoints; the port restores
    leaf for leaf bit-equal, then both go on M=2 steps and agree."""
    rp, ro, _, _ = ref_inputs(arch)
    for s in range(3):
        rp, ro, _ = ref_step(arch)(rp, ro, batches(arch, s)[0])
    RCK.CheckpointStore(str(tmp_path)).save(3, (rp, ro), extra={"by": "reference"})
    _, _, model, opt = ref_inputs(arch, seed=1)          # other values, same shapes
    (model, opt), step, extra = CheckpointStore(str(tmp_path)).restore_latest((model, opt))
    assert step == 3 and extra == {"by": "reference"}
    assert_state_close(_np(rp), ro, model, opt, None, exact=True)
    tstep = port_cell(*_cell(arch)).smoke_step_fn
    for s in range(3, 5):
        rb, tb = batches(arch, s)
        rp, ro, _ = ref_step(arch)(rp, ro, rb)
        model, opt, _ = tstep(model, opt, tb)
    assert_state_close(_np(rp), ro, model, opt, STEP)


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "mind", "gat-cora/molecule"])
def test_a_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    _, _, model, opt = ref_inputs(arch)
    tstep = port_cell(*_cell(arch)).smoke_step_fn
    for s in range(3):
        model, opt, _ = tstep(model, opt, batches(arch, s)[1])
    CheckpointStore(str(tmp_path)).save(3, (model, opt), extra={"by": "port"})
    rp, ro, _, _ = ref_inputs(arch, seed=1)
    (rp, ro), step, extra = RCK.CheckpointStore(str(tmp_path)).restore_latest((rp, ro))
    assert step == 3 and extra == {"by": "port"}
    assert_state_close(jax.tree_util.tree_map(np.asarray, rp), ro, model, opt, None,
                       exact=True)


def test_a_bfloat16_checkpoint_has_the_reference_bytes(tmp_path):
    """bf16 parameters are stored as the reference stores them, their bits
    in a ``|V2`` void, leaf for leaf the same bytes; the port restores the
    reference's.  (The reference cannot restore a bf16 checkpoint itself:
    its ``_assemble`` casts the ``|V2`` array with ``jnp.asarray``, which
    numpy refuses.)"""
    from repro.models import recsys as R
    from repro.train.optimizer import adamw_init as r_adamw_init

    cfg = dataclasses.replace(FAMILIES["two-tower"][0], dtype="bfloat16")
    rp = R.twotower_init(jax.random.PRNGKey(0), R.TwoTowerConfig(**dataclasses.asdict(cfg)))
    RCK.CheckpointStore(str(tmp_path / "ref")).save(1, (rp, r_adamw_init(rp)))
    model = convert.twotower_params_from_numpy(_np(rp), cfg, device="cpu")
    CheckpointStore(str(tmp_path / "port")).save(1, (model, adamw_init(model)))
    a = np.load(tmp_path / "ref" / "step_1" / "leaves.npz")
    b = np.load(tmp_path / "port" / "step_1" / "leaves.npz")
    assert sorted(a.files) == sorted(b.files)
    assert a["leaf_0"].dtype == np.dtype("V2")
    for name in a.files:
        assert a[name].dtype == b[name].dtype and a[name].tobytes() == b[name].tobytes(), name
    other = T.twotower_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    CheckpointStore(str(tmp_path / "ref")).restore_latest((other, adamw_init(other)))
    for x, y in zip(other.state_dict().values(), model.state_dict().values()):
        assert torch.equal(x, y)


def test_retention_keeps_the_last_checkpoints(tmp_path):
    _, _, model, opt = ref_inputs("mind")
    store = CheckpointStore(str(tmp_path), keep=3)
    for s in range(1, 6):
        store.save(s, (model, opt))
    assert store.steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]


def test_a_crash_before_the_rename_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    _, _, model, opt = ref_inputs("mind")
    store = CheckpointStore(str(tmp_path))
    store.save(1, (model, opt))
    saved = [t.clone() for t, _ in convert.train_state_leaves(model, opt)]
    tstep = port_cell("mind", "train_batch").smoke_step_fn
    model, opt, _ = tstep(model, opt, batches("mind", 0)[1])

    def crash(src, dst):
        raise OSError("crash between the temp write and the rename")

    monkeypatch.setattr(TSNAP.os, "replace", crash)
    with pytest.raises(OSError, match="crash"):
        store.save(2, (model, opt))
    monkeypatch.undo()
    assert store.steps() == [1]
    (model, opt), step, _ = store.restore_latest((model, opt))
    assert step == 1
    for (t, _), s in zip(convert.train_state_leaves(model, opt), saved):
        assert torch.equal(t, s)


def test_the_chip_smoke_train_path_on_the_cpu(tmp_path):
    """``chip_smoke.train_path`` rehearsed at the smoke widths: every family
    steps (finite, every leaf moves, ``lr`` the schedule's), the first step
    equals the CPU path's, the MIND restart is bit-identical under
    deterministic algorithms and its root removed, and the trained towers
    serve through ``IndexedRetriever``."""
    import chip_smoke
    from repro_torch.configs import bert4rec, mind, two_tower_retrieval
    from repro_torch.core.types import LireConfig

    configs = {"two-tower-retrieval": two_tower_retrieval.SMOKE, "deepfm": TDF.SMOKE,
               "bert4rec": bert4rec.SMOKE, "mind": mind.SMOKE}
    index_cfg = LireConfig(dim=16, block_size=8, max_blocks_per_posting=8, num_blocks=512,
                           num_postings_cap=128, num_vectors_cap=2048, split_limit=48,
                           merge_limit=6, reassign_range=8, replica_count=2, nprobe=16,
                           use_pallas_nav=True, use_pallas_scan=True)
    rep = chip_smoke.train_path(torch, np, 0, {}, device="cpu", configs=configs,
                                batches={a: 48 for a in configs}, serve_n=400,
                                index_cfg=index_cfg, users_n=32, ckpt_parent=tmp_path)
    for arch in configs:
        r = rep[arch]
        assert len(r["step_ms"]) == chip_smoke.TRAIN_WARM + chip_smoke.TRAIN_TIMED
        assert r["first_step"]["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
        assert set(r["split"]) == {"forward_ms", "backward_ms", "adamw_ms"}
    assert set(rep["reduced"]) == set(configs)
    assert rep["restart"]["leaves"] == 1 + 3 * 3 and rep["restart"]["checkpoint_bytes"] > 0
    assert list(tmp_path.iterdir()) == []
    assert rep["serve"]["oracle_overlap"] >= chip_smoke.ORACLE_OVERLAP
