"""Port vs reference for the two-tower model: the reference's params
(``twotower_init(PRNGKey(0))``) carried over by
``convert.twotower_params_from_numpy``, then each tower and both scoring
functions on the same ids, out-of-range and negative ones included.
Tolerances: f32 ``rtol = atol = 1e-5``; bf16 ``atol = 2e-2`` on unit
vectors (JAX on the CPU and PyTorch each round a bf16 matmul their own
way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as RC
from repro.models import recsys as R
from repro_torch import convert
from repro_torch.configs import two_tower_retrieval as TC
from repro_torch.models import layers as TL
from repro_torch.models import recsys as T

WIDER = dataclasses.replace(TC.SMOKE, name="two-tower-wider", n_items=300, n_user_fields=3,
                            user_vocab_per_field=50, embed_dim=24, tower_dims=(48, 40, 8))
CONFIGS = {"smoke": TC.SMOKE, "wider": WIDER}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=2e-2)}
# the reference's functions, compiled once per config and shape
R_USER, R_ITEM, R_PAIRS, R_RETRIEVAL = (
    jax.jit(f, static_argnums=2) for f in (R.user_tower, R.item_tower, R.twotower_score_pairs,
                                           R.twotower_retrieval))


def _ref_cfg(cfg):
    return R.TwoTowerConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg):
    return R.twotower_init(jax.random.PRNGKey(0), _ref_cfg(cfg))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ids(cfg, rng, b=17):
    users = rng.integers(-5, cfg.user_vocab_per_field + 5, size=(b, cfg.n_user_fields))
    users[0] = -3                                     # below the range
    users[1] = cfg.user_vocab_per_field + 7           # above it
    items = rng.integers(-5, cfg.n_items + 5, size=(b,))
    items[:2] = [-1, cfg.n_items + 3]
    return users.astype(np.int32), items.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_towers_and_scores_match_the_reference(name, dtype):
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    rp = _ref_params(cfg)
    model = convert.twotower_params_from_numpy(_np(rp), cfg, device="cpu")
    users, items = _ids(cfg, np.random.default_rng(0))
    rcfg = _ref_cfg(cfg)
    tol = TOL[dtype]
    ru = R_USER(rp, jnp.asarray(users), rcfg)
    tu = T.user_tower(model, torch.as_tensor(users), cfg)
    assert tu.dtype == T.torch_dtype(dtype) and tuple(tu.shape) == ru.shape
    np.testing.assert_allclose(_f32(tu), _f32(ru), **tol)
    ri = R_ITEM(rp, jnp.asarray(items), rcfg)
    ti = T.item_tower(model, torch.as_tensor(items), cfg)
    np.testing.assert_allclose(_f32(ti), _f32(ri), **tol)
    np.testing.assert_allclose(np.linalg.norm(_f32(ti), axis=-1), 1.0, atol=tol["atol"] + 1e-6)
    batch = {"user_fields": users, "item_ids": items}
    rs = R_PAIRS(rp, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    ts = T.twotower_score_pairs(model, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(_f32(ts), _f32(rs), **tol)
    cand = np.arange(-2, cfg.n_items + 3, dtype=np.int32)
    rr = R_RETRIEVAL(rp, {"user_fields": jnp.asarray(users),
                          "candidate_ids": jnp.asarray(cand)}, rcfg)
    tr = T.twotower_retrieval(model, {"user_fields": torch.as_tensor(users),
                                      "candidate_ids": torch.as_tensor(cand)}, cfg)
    assert tr.dtype == torch.float32 and tuple(tr.shape) == rr.shape
    np.testing.assert_allclose(tr.numpy(), np.asarray(rr), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_conversion_round_trips_both_ways(name, dtype):
    """reference → port → reference is bit-equal; port → reference → port
    too; ``nn.Linear`` holds each ``w (in, out)`` as ``(out, in)``."""
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    tree = _np(_ref_params(cfg))
    model = convert.twotower_params_from_numpy(tree, cfg, device="cpu")
    back = convert.twotower_params_to_numpy(model)
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16) if dtype == "bfloat16" else a, b)
    for lin, lp in zip(model.user_mlp, tree["user_mlp"]):
        assert tuple(lin.weight.shape) == lp["w"].shape[::-1]
        assert isinstance(lin, torch.nn.Linear)
    again = convert.twotower_params_from_numpy(back, cfg, device="cpu")
    for (n, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n


def test_param_conversion_refuses_another_dtype():
    tree = _np(_ref_params(TC.SMOKE))
    with pytest.raises(TypeError):
        convert.twotower_params_from_numpy(tree, dataclasses.replace(TC.SMOKE, dtype="bfloat16"),
                                           device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_init_has_the_reference_shapes_and_is_deterministic(name, dtype):
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    ref = _np(_ref_params(cfg))
    a = convert.twotower_params_to_numpy(
        T.twotower_init(torch.Generator().manual_seed(3), cfg, device="cpu"))
    b = convert.twotower_params_to_numpy(
        T.twotower_init(torch.Generator().manual_seed(3), cfg, device="cpu"))
    c = convert.twotower_params_to_numpy(
        T.twotower_init(torch.Generator().manual_seed(4), cfg, device="cpu"))
    for x, y, z, r in zip(*(jax.tree_util.tree_leaves(t) for t in (a, b, c, ref))):
        assert x.shape == r.shape and x.itemsize == r.dtype.itemsize
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(jax.tree_util.tree_leaves(a),
                                                         jax.tree_util.tree_leaves(c)))
    w = a["user_mlp"][0]["w"]
    if dtype == "bfloat16":                           # uint16 bits → f32
        w = (w.astype(np.uint32) << 16).view(np.float32)
    # dense_init's scale 1/sqrt(d_in)
    assert abs(float(np.std(w)) * np.sqrt(w.shape[0]) - 1.0) < 0.2


def test_counter_init_is_the_same_for_every_table_prefix_and_rows():
    """``twotower_init_counter`` is a function of (seed, stream, row,
    column): a shorter item table is a prefix of the longer one, the
    towers equal, and the draws have the stated scales."""
    cfg = dataclasses.replace(WIDER, dtype="bfloat16")
    a = T.twotower_init_counter(5, cfg, device="cpu")
    b = T.twotower_init_counter(5, dataclasses.replace(cfg, n_items=40), device="cpu")
    assert torch.equal(a.item_embed[:40], b.item_embed)
    assert torch.equal(a.user_embed, b.user_embed)
    for x, y in zip(a.item_mlp.parameters(), b.item_mlp.parameters()):
        assert torch.equal(x, y)
    t = TL.counter_normal(1, 7, 4096, 64, scale=0.02, dtype=torch.float32, device="cpu")
    assert abs(float(t.std()) - 0.02) < 1e-3 and abs(float(t.mean())) < 1e-3
    part = TL.counter_normal(1, 7, 100, 64, scale=0.02, dtype=torch.float32, device="cpu")
    assert torch.equal(part, t[:100])
    other = TL.counter_normal(1, 8, 100, 64, scale=0.02, dtype=torch.float32, device="cpu")
    assert not torch.equal(part, other)


def test_serving_configs_mirror_the_reference():
    assert dataclasses.asdict(TC.CONFIG) == dataclasses.asdict(RC.CONFIG)
    assert dataclasses.asdict(TC.SMOKE) == dataclasses.asdict(RC.SMOKE)
    assert TC.SERVE_CONFIG == dataclasses.replace(TC.CONFIG, dtype="bfloat16")
    from repro.configs.two_tower_retrieval import _ann_index_cfg
    ref, port = dataclasses.asdict(_ann_index_cfg()), dataclasses.asdict(TC.ann_index_cfg())
    assert ref == port


# ---------------------------------------------------------------------------
# The training families: losses, forwards and gradients against the
# reference's on its converted params.  f32 at rtol = atol = 1e-5;
# gradients against jax.grad at rtol 1e-4, atol 1e-6.
# ---------------------------------------------------------------------------

from repro.configs import bert4rec as RB4  # noqa: E402
from repro.configs import deepfm as RDF  # noqa: E402
from repro.configs import mind as RMI  # noqa: E402
from repro_torch.configs import bert4rec as TB4  # noqa: E402
from repro_torch.configs import deepfm as TDF  # noqa: E402
from repro_torch.configs import mind as TMI  # noqa: E402
from repro_torch.train.optimizer import value_and_grad  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _batch_deepfm(cfg, rng, b=24):
    fields = rng.integers(-3, cfg.vocab_per_field + 3, size=(b, cfg.n_fields))
    return {"fields": fields.astype(np.int32),
            "labels": rng.integers(0, 2, size=b).astype(np.int32)}


def _batch_twotower(cfg, rng, b=24):
    users, items = _ids(cfg, rng, b)
    return {"user_fields": users, "item_ids": items,
            "item_logq": rng.normal(size=b).astype(np.float32)}


def _batch_bert4rec(cfg, rng, b=6, m=3):
    items = rng.integers(0, cfg.n_items, size=(b, cfg.seq_len)).astype(np.int32)
    items[0, -3:] = -1                                 # padding at the end
    items[1, 2] = -1                                   # and mid-sequence
    pos = np.stack([rng.choice(cfg.seq_len, size=m, replace=False) for _ in range(b)])
    labels = items[np.arange(b)[:, None], pos].copy()
    labels[2, 1] = -1                                  # an ignored slot
    items[np.arange(b)[:, None], pos] = cfg.mask_id
    return {"items": items, "mask_pos": pos.astype(np.int32),
            "mask_label": labels.astype(np.int32)}


def _batch_mind(cfg, rng, b=12):
    items = rng.integers(0, cfg.n_items, size=(b, cfg.seq_len)).astype(np.int32)
    items[0, 4:] = -1
    items[3, 1] = -1
    return {"items": items, "target": rng.integers(0, cfg.n_items, size=b).astype(np.int32)}


# name: (port smoke config, reference init, port from_numpy, losses (ref, port), batch)
FAMILIES = {
    "deepfm": (TDF.SMOKE, R.deepfm_init, convert.deepfm_params_from_numpy,
               (R.deepfm_loss, T.deepfm_loss), _batch_deepfm),
    "two-tower": (TC.SMOKE, R.twotower_init, convert.twotower_params_from_numpy,
                  (R.twotower_loss, T.twotower_loss), _batch_twotower),
    "bert4rec": (TB4.SMOKE, R.bert4rec_init, convert.bert4rec_params_from_numpy,
                 (R.bert4rec_loss, T.bert4rec_loss), _batch_bert4rec),
    "mind": (TMI.SMOKE, R.mind_init, convert.mind_params_from_numpy,
             (R.mind_loss, T.mind_loss), _batch_mind),
}
REF_CFG = {"deepfm": R.DeepFMConfig, "two-tower": R.TwoTowerConfig,
           "bert4rec": R.Bert4RecConfig, "mind": R.MINDConfig}
_JIT: dict = {}


def ref_jit(fn, *, grad=False):
    """``fn`` (and its gradient) compiled once, the config static."""
    key = (fn, grad)
    if key not in _JIT:
        f = jax.grad(lambda p, b, c: fn(p, b, c)[0]) if grad else fn
        _JIT[key] = jax.jit(f, static_argnums=2)
    return _JIT[key]


def family(name, seed=0):
    """``(port cfg, ref cfg, ref params (numpy tree), port model on the
    CPU, numpy batch)``."""
    cfg, init, from_np, _, make = FAMILIES[name]
    rcfg = REF_CFG[name](**dataclasses.asdict(cfg))
    tree = _np(init(jax.random.PRNGKey(seed), rcfg))
    return cfg, rcfg, tree, from_np(tree, cfg, device="cpu"), make(cfg, np.random.default_rng(seed))


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_losses_and_gradients_match_the_reference(name):
    cfg, rcfg, tree, model, batch = family(name)
    r_loss, t_loss = FAMILIES[name][3]
    rl, rm = ref_jit(r_loss)(tree, _j(batch), rcfg)
    (tl, tm), grads = value_and_grad(lambda p, b: t_loss(p, b, cfg), model, _t(batch))
    np.testing.assert_allclose(float(tl), float(rl), **F32)
    assert set(tm) == set(rm)
    rg = jax.tree_util.tree_leaves(ref_jit(r_loss, grad=True)(tree, _j(batch), rcfg))
    leaves = convert.param_leaves(model)
    assert len(rg) == len(grads) == len(leaves)
    for (path, p, tr), g, r in zip(leaves, grads, rg):
        g = (g.T if tr else g).numpy()
        assert g.shape == r.shape, path
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(path), **GRAD)
    assert any(np.abs(np.asarray(r)).max() > 0 for r in rg)


def test_forward_and_serving_functions_match_the_reference():
    cfg, rcfg, tree, model, batch = family("deepfm")
    np.testing.assert_allclose(T.deepfm_forward(model, _t(batch), cfg).detach().numpy(),
                               ref_jit(R.deepfm_forward)(tree, _j(batch), rcfg), **F32)
    cfg, rcfg, tree, model, batch = family("bert4rec")
    items = {"items": batch["items"]}
    np.testing.assert_allclose(T.bert4rec_encode(model, torch.as_tensor(batch["items"]),
                                                 cfg).detach().numpy(),
                               ref_jit(R.bert4rec_encode)(tree, jnp.asarray(batch["items"]),
                                                          rcfg), **F32)
    ts = T.bert4rec_score(model, _t(items), cfg)
    assert ts.dtype == torch.float32 and not ts.requires_grad
    np.testing.assert_allclose(ts.numpy(), ref_jit(R.bert4rec_score)(tree, _j(items), rcfg),
                               **F32)
    cfg, rcfg, tree, model, batch = family("mind")
    items = {"items": batch["items"]}
    caps = T.mind_serve(model, _t(items), cfg)
    assert tuple(caps.shape) == (batch["items"].shape[0], cfg.n_interests, cfg.embed_dim)
    np.testing.assert_allclose(caps.numpy(), ref_jit(R.mind_serve)(tree, _j(items), rcfg), **F32)
    np.testing.assert_allclose(
        T.mind_interests(model, torch.as_tensor(batch["items"]), cfg).detach().numpy(),
        ref_jit(R.mind_interests)(tree, jnp.asarray(batch["items"]), rcfg), **F32)


def _bags(rng):
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(-1, 40, size=(5, 4)).astype(np.int32)
    ids[2] = -1                                        # an empty bag
    flat = rng.integers(-1, 40, size=23).astype(np.int32)
    seg = rng.integers(0, 7, size=23).astype(np.int32)  # unsorted; 6 and 7 out of range
    seg[:3] = [-2, 9, 6]
    return table, ids, flat, seg


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bag_lookups_and_their_gradients_match_the_reference(combiner):
    table, ids, flat, seg = _bags(np.random.default_rng(1))
    n_seg = 6
    ref_fixed = jax.jit(lambda t, i: R.bag_lookup(t, i, combiner=combiner))
    ref_ragged = jax.jit(lambda t, f, s: R.embedding_bag_ragged(t, f, s, n_seg,
                                                                combiner=combiner))
    tt = torch.tensor(table, requires_grad=True)
    got = T.bag_lookup(tt, torch.as_tensor(ids), combiner=combiner)
    np.testing.assert_allclose(got.detach().numpy(), ref_fixed(table, ids), **F32)
    (g,) = torch.autograd.grad(got.square().sum(), tt)
    rg = jax.grad(lambda t: jnp.sum(jnp.square(ref_fixed(t, ids))))(table)
    np.testing.assert_allclose(g.numpy(), rg, **GRAD)
    got = T.embedding_bag_ragged(tt, torch.as_tensor(flat), torch.as_tensor(seg), n_seg,
                                 combiner=combiner)
    assert tuple(got.shape) == (n_seg, 8)
    np.testing.assert_allclose(got.detach().numpy(), ref_ragged(table, flat, seg), **F32)
    (g,) = torch.autograd.grad(got.square().sum(), tt)
    rg = jax.grad(lambda t: jnp.sum(jnp.square(ref_ragged(t, flat, seg))))(table)
    np.testing.assert_allclose(g.numpy(), rg, **GRAD)


@pytest.mark.parametrize("name", ["deepfm", "bert4rec", "mind"])
def test_family_param_conversion_round_trips(name):
    """reference → port → reference is bit-equal, in the reference's leaf
    order, each ``w`` ``(in, out)``."""
    cfg, _, tree, model, _ = family(name)
    back = convert.params_to_numpy(model)
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert [p for p, _ in convert.tree_paths(tree)] == [p for p, _, _ in
                                                       convert.param_leaves(model)]


def test_the_port_inits_have_the_reference_shapes():
    inits = {"deepfm": T.deepfm_init, "bert4rec": T.bert4rec_init, "mind": T.mind_init}
    for name, init in inits.items():
        _, _, tree, _, _ = family(name)
        a = convert.params_to_numpy(init(torch.Generator().manual_seed(1), FAMILIES[name][0],
                                         device="cpu"))
        ref = jax.tree_util.tree_flatten(tree)
        got = jax.tree_util.tree_flatten(a)
        assert got[1] == ref[1], name
        for x, r in zip(got[0], ref[0]):
            assert x.shape == r.shape and x.dtype == r.dtype, name


def test_towers_train_and_serving_stays_grad_free():
    """``TwoTower``'s parameters take gradients through the methods; the
    reference-named serving functions build no graph."""
    model = convert.twotower_params_from_numpy(_np(_ref_params(TC.SMOKE)), TC.SMOKE,
                                               device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    users, items = _ids(TC.SMOKE, np.random.default_rng(2))
    assert model.user_tower(torch.as_tensor(users)).requires_grad
    for out in (T.user_tower(model, torch.as_tensor(users)),
                T.item_tower(model, torch.as_tensor(items)),
                T.twotower_score_pairs(model, {"user_fields": torch.as_tensor(users),
                                               "item_ids": torch.as_tensor(items)}),
                T.twotower_retrieval(model, {"user_fields": torch.as_tensor(users),
                                             "candidate_ids": torch.as_tensor(items)})):
        assert not out.requires_grad


def test_layers_match_the_reference():
    """``rms_norm``, ``layer_norm`` and the SwiGLU ``mlp`` (on the
    reference's ``init_mlp`` params) at f32 rtol = atol = 1e-5."""
    from repro.models import layers as RL

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3
    scale, bias = (rng.normal(size=24).astype(np.float32) for _ in range(2))
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(TL.rms_norm(tx, torch.as_tensor(scale)).numpy(),
                               RL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), **F32)
    np.testing.assert_allclose(
        TL.layer_norm(tx, torch.as_tensor(scale), torch.as_tensor(bias)).numpy(),
        RL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)), **F32)
    tree = _np(RL.init_mlp(jax.random.PRNGKey(0), 24, 40, jnp.float32))
    params = TL.ParamTree({k: torch.tensor(v) for k, v in tree.items()})
    np.testing.assert_allclose(TL.mlp(params, tx).detach().numpy(),
                               RL.mlp(tree, jnp.asarray(x)), **F32)
    port = TL.init_mlp(torch.Generator().manual_seed(0), 24, 40, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in tree.items()}
    assert TL.NEG_INF == RL.NEG_INF
