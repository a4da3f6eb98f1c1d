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
