"""Port vs reference for the GNN family: the graph substrate
(``repro_torch.data.graphs``: ``CSRGraph``, the fanout sampler, the
minibatch stream) and the GAT (``repro_torch.models.gnn``), the same
numpy inputs from a seed through both packages, the reference's params
carried over by ``convert.gnn_params_from_numpy``.

Tolerances: the sampler's arrays are equal (``np.array_equal``: the same
draws from the same generator); the GAT's logits, loss and accuracy at
f32 ``rtol = atol = 1e-5``, and each gradient leaf within ``1e-5`` of its
largest value (the port sums each segment in edge order, XLA's scatter in
its own).  The twins of the reference's own GAT tests (``test_models.py``,
``test_graph_sampler.py``) keep its bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as RG
from repro.models import gnn as RGNN
from repro_torch import convert
from repro_torch.data import graphs as TG
from repro_torch.models import gnn as T
from repro_torch.train.optimizer import AdamWConfig, adamw_init, make_train_step, value_and_grad
from tests.test_torch_lm import one_thread  # noqa: F401  (a fixture)

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5


def model(cfg, seed=0):
    """``(reference params as a numpy tree, the port's GAT over them on the CPU)``."""
    tree = jax.tree_util.tree_map(
        np.asarray, RGNN.init_params(jax.random.PRNGKey(seed),
                                     RGNN.GATConfig(**dataclasses.asdict(cfg))))
    return tree, convert.gnn_params_from_numpy(tree, cfg, device="cpu")


def graph_batch(rng, n, e, d, n_classes, *, pad=0, isolated=0, n_graphs=0):
    """``n`` nodes, ``e`` uniform edges, the last ``pad`` of them -1 (both
    ends, or only one), the last ``isolated`` nodes never a destination."""
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n - isolated, size=e).astype(np.int32)
    if pad:
        src[-pad:] = -1
        dst[-pad // 2:] = -1
    b = {"features": rng.normal(size=(n, d)).astype(np.float32), "edge_src": src,
         "edge_dst": dst}
    if n_graphs:
        b["graph_ids"] = np.repeat(np.arange(n_graphs), n // n_graphs).astype(np.int32)
        b["labels"] = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    else:
        labels = rng.integers(0, n_classes, size=n).astype(np.int32)
        labels[::5] = -1                                   # unlabelled nodes
        b["labels"] = labels
    return b


def both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def rcfg(cfg):
    return RGNN.GATConfig(**dataclasses.asdict(cfg))


_JIT: dict = {}


def ref_fn(name, cfg):
    """The reference's ``gnn.<name>(params, batch, cfg)`` (``loss_fn`` as
    ``value_and_grad``), compiled once a config."""
    key = (name, cfg)
    if key not in _JIT:
        if name == "loss_fn":
            fn = jax.value_and_grad(lambda p, b: RGNN.loss_fn(p, b, rcfg(cfg)), has_aux=True)
        else:
            fn = lambda p, b: RGNN.forward(p, b, rcfg(cfg))                # noqa: E731
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


CASES = {
    "node": (T.GATConfig(d_in=12, d_hidden=4, n_heads=3, n_classes=5), {}),
    "node-3-layers": (T.GATConfig(d_in=12, d_hidden=6, n_heads=2, n_layers=3, n_classes=4), {}),
    "graph-readout": (T.GATConfig(d_in=12, d_hidden=4, n_heads=2, n_classes=3, readout="mean",
                                  n_graphs=4), {"n_graphs": 4}),
}


# ---------------------------------------------------------------------------
# The graph substrate, array for array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,deg,d,c,seed,homophily", [(300, 6, 8, 5, 0, 0.8),
                                                      (120, 3, 4, 1, 7, 0.5),
                                                      (64, 8, 16, 5, 0, 0.8)])
def test_csr_graph_random_equals_the_reference(n, deg, d, c, seed, homophily):
    a = TG.CSRGraph.random(n, deg, d, c, seed=seed, homophily=homophily)
    b = RG.CSRGraph.random(n, deg, d, c, seed=seed, homophily=homophily)
    for f in ("indptr", "indices", "features", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_nodes == b.n_nodes == n
    assert np.array_equal(a.neighbors(n // 2), b.neighbors(n // 2))


@pytest.mark.parametrize("fanouts", [(4,), (3, 6), (5, 2, 2)])
def test_sample_subgraph_equals_the_reference(fanouts):
    g, rg = TG.CSRGraph.random(200, 5, 4, 3, seed=1), RG.CSRGraph.random(200, 5, 4, 3, seed=1)
    targets = np.random.default_rng(2).choice(200, size=8, replace=False)
    a = TG.sample_subgraph(g, targets, fanouts, np.random.default_rng(3))
    b = RG.sample_subgraph(rg, targets, fanouts, np.random.default_rng(3))
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_minibatch_stream_equals_the_reference():
    g, rg = TG.CSRGraph.random(500, 6, 8, 5, seed=0), RG.CSRGraph.random(500, 6, 8, 5, seed=0)
    a, b = TG.minibatch_stream(g, 16, (4, 3), seed=9), RG.minibatch_stream(rg, 16, (4, 3), seed=9)
    for step in (0, 1, 5):
        x, y = a(step), b(step)
        for k in y:
            assert np.array_equal(x[k], y[k]), (step, k)


# the reference's tests/test_graph_sampler.py on the port

def test_fixed_shapes_across_batches():
    g = TG.CSRGraph.random(500, avg_degree=6, d_feat=8, n_classes=5, seed=0)
    stream = TG.minibatch_stream(g, batch_nodes=16, fanouts=(4, 3))
    b0, b1 = stream(0), stream(1)
    for k in ("features", "edge_src", "edge_dst", "labels"):
        assert b0[k].shape == b1[k].shape, k
    n_expect = 16 + 16 * 4 + 16 * 4 * 3
    e_expect = 16 * 4 + 16 * 4 * 3 + n_expect  # + per-slot self-loops
    assert b0["features"].shape == (n_expect, 8)
    assert b0["edge_src"].shape == (e_expect,)


def test_edges_reference_true_neighbors():
    g = TG.CSRGraph.random(200, avg_degree=5, d_feat=4, n_classes=3, seed=1)
    rng = np.random.default_rng(2)
    targets = rng.choice(200, size=8, replace=False)
    b = TG.sample_subgraph(g, targets, (4,), rng)
    ids = b["node_ids"]
    for s, d in zip(b["edge_src"], b["edge_dst"]):
        if s < 0 or d < 0 or s == d:  # skip pads and self-loops
            continue
        child, parent = ids[s], ids[d]
        assert child in g.neighbors(int(parent)), (child, parent)
    assert (b["labels"][:8] >= 0).all()
    assert (b["labels"][8:] == -1).all()


def test_gat_trains_on_sampled_minibatches(one_thread):
    g = TG.CSRGraph.random(400, avg_degree=8, d_feat=8, n_classes=3, seed=3,
                           feature_signal=1.5)
    cfg = T.GATConfig(d_in=8, d_hidden=8, n_heads=2, n_classes=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw_init(params)
    stream = TG.minibatch_stream(g, batch_nodes=32, fanouts=(5, 3), seed=4)
    step_fn = make_train_step(lambda p, b: T.loss_fn(p, b, cfg),
                              AdamWConfig(lr=2e-2, warmup_steps=5, decay_steps=60,
                                          weight_decay=0.0))
    losses, accs = [], []
    for step in range(60):
        raw = stream(step)
        batch = {k: torch.as_tensor(v) for k, v in raw.items() if k != "node_ids"}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.9, losses
    assert np.mean(accs[-10:]) > 0.55, accs[-10:]


# ---------------------------------------------------------------------------
# The GAT against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("pad,isolated", [(0, 0), (6, 3)])
def test_gat_layer_matches_the_reference(rng, concat, pad, isolated):
    """One layer's output and its gradients (``w``, ``a_src``, ``a_dst``
    and ``x``), with ``-1`` edges and nodes no edge reaches."""
    heads, d_out, n = 3, 4, 20
    lp = {"w": (rng.normal(size=(6, heads * d_out)) / 3).astype(np.float32),
          "a_src": (rng.normal(size=(heads, d_out)) * 0.5).astype(np.float32),
          "a_dst": (rng.normal(size=(heads, d_out)) * 0.5).astype(np.float32)}
    b = graph_batch(rng, n, 50, 6, 2, pad=pad, isolated=isolated)
    kw = dict(heads=heads, d_out=d_out, negative_slope=0.2, concat=concat)
    probe = rng.normal(size=(n, heads * d_out if concat else d_out)).astype(np.float32)

    def ref(lp, x):
        out = RGNN.gat_layer(lp, x, jnp.asarray(b["edge_src"]), jnp.asarray(b["edge_dst"]), **kw)
        return jnp.sum(out * probe), out

    (_, want), rg = jax.jit(jax.value_and_grad(ref, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(b["features"]))
    tlp = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    x = torch.tensor(b["features"], requires_grad=True)
    got = T.gat_layer(tlp, x, torch.as_tensor(b["edge_src"]), torch.as_tensor(b["edge_dst"]), **kw)
    grads = torch.autograd.grad(torch.sum(got * torch.as_tensor(probe)),
                                [tlp["a_dst"], tlp["a_src"], tlp["w"], x])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    for g, r in zip(grads, [*jax.tree_util.tree_leaves(rg[0]), rg[1]]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_REL * np.abs(r).max())
    if isolated:                       # no incoming edge: the reference's 0 row
        assert torch.all(got[-isolated:] == 0) and np.all(np.asarray(want)[-isolated:] == 0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pad,isolated", [(0, 0), (8, 4)])
def test_forward_loss_and_grads_match_the_reference(rng, case, pad, isolated):
    cfg, extra = CASES[case]
    tree, gat = model(cfg)
    b = graph_batch(rng, 24, 70, cfg.d_in, cfg.n_classes, pad=pad, isolated=isolated, **extra)
    jb, tb = both(b)
    np.testing.assert_allclose(T.forward(gat, tb, cfg).detach().numpy(),
                               np.asarray(ref_fn("forward", cfg)(tree, jb)), **F32)
    (want, wm), rg = ref_fn("loss_fn", cfg)(tree, jb)
    (got, gm), grads = value_and_grad(lambda p, bt: T.loss_fn(p, bt, cfg), gat, tb)
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert float(gm["acc"]) == float(wm["acc"])
    leaves = convert.param_leaves(gat)
    rleaves = jax.tree_util.tree_leaves(rg)
    assert len(leaves) == len(rleaves) == len(grads)
    for (path, _, _), g, r in zip(leaves, grads, rleaves):
        r = np.asarray(r)
        assert g.shape == r.shape, path
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_REL * np.abs(r).max(),
                                   err_msg=str(path))


def test_a_node_with_no_incoming_edge_gets_zeros(rng):
    """``segment_reduce``'s empty segment (max ``-inf``, sum 0) gives the
    reference's 0 row, and no NaN reaches a gradient."""
    cfg = T.GATConfig(d_in=4, d_hidden=3, n_heads=2, n_classes=3)
    tree, gat = model(cfg)
    b = {"features": rng.normal(size=(5, 4)).astype(np.float32),
         "edge_src": np.array([0, 1, 2, 3], np.int32), "edge_dst": np.array([1, 2, 1, -1],
                                                                          np.int32),
         "labels": np.array([0, 1, 2, 0, 1], np.int32)}
    jb, tb = both(b)
    lp = gat["layers"][0]
    out = T.gat_layer(lp, tb["features"], tb["edge_src"], tb["edge_dst"], heads=2, d_out=3,
                      negative_slope=0.2, concat=True)
    want = jax.jit(lambda *a: RGNN.gat_layer(*a, heads=2, d_out=3, negative_slope=0.2,
                                             concat=True))(
        tree["layers"][0], jb["features"], jb["edge_src"], jb["edge_dst"])
    for v in (0, 3, 4):                                    # no incoming edge
        assert torch.all(out[v] == 0) and np.all(np.asarray(want)[v] == 0)
    _, grads = value_and_grad(lambda p, bt: T.loss_fn(p, bt, cfg), gat, tb)
    assert all(torch.isfinite(g).all() for g in grads)


# the reference's GAT cases of tests/test_models.py on the port

def test_gat_node_classification_smoke(rng):
    cfg = T.GATConfig(d_in=32, d_hidden=8, n_heads=4, n_classes=5)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    n, e = 50, 200
    batch = {
        "features": torch.as_tensor(rng.normal(size=(n, 32)).astype(np.float32)),
        "edge_src": torch.as_tensor(rng.integers(0, n, size=e).astype(np.int32)),
        "edge_dst": torch.as_tensor(rng.integers(0, n, size=e).astype(np.int32)),
        "labels": torch.as_tensor(rng.integers(0, 5, size=n).astype(np.int32)),
    }
    loss, _ = T.loss_fn(params, batch, cfg)
    assert np.isfinite(float(loss))
    assert T.forward(params, batch, cfg).shape == (n, 5)


def test_gat_learns_trivial_task(rng):
    """A few gradient steps reduce loss on a separable toy graph."""
    cfg = T.GATConfig(d_in=8, d_hidden=8, n_heads=2, n_classes=2)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    n = 40
    labels = np.concatenate([np.zeros(20), np.ones(20)]).astype(np.int32)
    feats = (rng.normal(size=(n, 8)) + labels[:, None] * 3).astype(np.float32)
    src, dst = [], []
    for c in (0, 1):
        idx = np.where(labels == c)[0]
        for i in idx:
            for j in rng.choice(idx, size=3):
                src.append(i)
                dst.append(j)
    batch = {"features": torch.as_tensor(feats), "edge_src": torch.as_tensor(src).int(),
             "edge_dst": torch.as_tensor(dst).int(), "labels": torch.as_tensor(labels)}
    loss0, _ = T.loss_fn(params, batch, cfg)
    for _ in range(80):
        (_, _), g = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), params, batch)
        with torch.no_grad():
            for (_, p, _), gg in zip(convert.param_leaves(params), g):
                p -= 0.2 * gg
    loss1, m = T.loss_fn(params, batch, cfg)
    assert float(loss1) < float(loss0) * 0.5
    assert float(m["acc"]) > 0.9


def test_gat_padded_edges_are_ignored(rng):
    cfg = T.GATConfig(d_in=8, d_hidden=4, n_heads=2, n_classes=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    feats = torch.as_tensor(rng.normal(size=(10, 8)).astype(np.float32))
    src = torch.tensor([0, 1, 2, -1, -1], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, -1, -1], dtype=torch.int32)
    out1 = T.forward(params, {"features": feats, "edge_src": src, "edge_dst": dst}, cfg)
    out2 = T.forward(params, {"features": feats, "edge_src": src[:3], "edge_dst": dst[:3]}, cfg)
    np.testing.assert_allclose(out1.detach().numpy(), out2.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_gat_graph_readout(rng):
    cfg = T.GATConfig(d_in=8, d_hidden=4, n_heads=2, n_classes=3, readout="mean", n_graphs=2)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    n = 12
    batch = {
        "features": torch.as_tensor(rng.normal(size=(n, 8)).astype(np.float32)),
        "edge_src": torch.as_tensor(rng.integers(0, n, size=20).astype(np.int32)),
        "edge_dst": torch.as_tensor(rng.integers(0, n, size=20).astype(np.int32)),
        "graph_ids": torch.tensor([0] * 6 + [1] * 6, dtype=torch.int32),
        "labels": torch.tensor([0, 1], dtype=torch.int32),
    }
    assert T.forward(params, batch, cfg).shape == (2, 3)
    loss, _ = T.loss_fn(params, batch, cfg)
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# The port's own: deterministic segment ops, params, conversion
# ---------------------------------------------------------------------------

def test_the_segment_ops_gradients_are_exact_in_f64(rng):
    """``gather_src``, ``gather_dst`` and ``aggregate`` (their hand-written
    backwards) against finite differences in f64."""
    n, e, heads, d = 7, 18, 2, 3
    src = torch.as_tensor(rng.integers(-1, n, size=e))
    dst = torch.as_tensor(rng.integers(0, n - 1, size=e))
    ei = T.edge_index(src, dst, n)
    h = torch.tensor(rng.normal(size=(n, heads, d)), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.random(size=(e, heads)), dtype=torch.float64, requires_grad=True)
    a = torch.tensor(rng.normal(size=(n, heads)), dtype=torch.float64, requires_grad=True)

    def agg(h, w):
        msg = h[ei.src] * w[..., None]
        return torch.zeros((n, heads, d), dtype=h.dtype).index_add(0, ei.dst, msg)

    assert torch.allclose(T.aggregate(h, w, ei).double(), agg(h.double(), w))
    assert torch.autograd.gradcheck(lambda h, w: T.aggregate(h, w, ei), (h, w))
    assert torch.autograd.gradcheck(lambda a: T.gather_src(a, ei), (a,))
    assert torch.autograd.gradcheck(lambda a: T.gather_dst(a, ei), (a,))


def test_edge_index_orders_by_destination_stably():
    src = torch.tensor([5, 1, -1, 2, 0, 3], dtype=torch.int32)
    dst = torch.tensor([2, 0, 2, -1, 2, 0], dtype=torch.int32)
    ei = T.edge_index(src, dst, 6)
    assert ei.dst.tolist() == [0, 0, 0, 2, 2, 2]
    assert ei.src.tolist() == [1, 2, 3, 5, 0, 0]          # -1 ends clamped to node 0
    assert ei.valid.tolist() == [True, False, True, True, False, True]
    assert ei.by_dst.tolist() == [3, 0, 3, 0, 0, 0]
    assert ei.by_src.tolist() == [2, 1, 1, 1, 0, 1]
    assert ei.src[ei.src_order].tolist() == sorted(ei.src.tolist())


def test_two_steps_from_one_state_are_bit_identical(rng):
    cfg, extra = CASES["graph-readout"]
    b = {k: torch.as_tensor(v) for k, v in graph_batch(rng, 24, 70, 12, 3, pad=4,
                                                        **extra).items()}
    out = []
    for _ in range(2):
        gat = model(cfg)[1]
        (loss, _), grads = value_and_grad(lambda p, bt: T.loss_fn(p, bt, cfg), gat, b)
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(x, y) for x, y in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_specs_and_conversion(case):
    """``param_specs`` (meta) has the reference's shapes and dtypes in its
    leaf order; ``convert`` carries a GAT both ways bit for bit; the init
    is seeded."""
    cfg, _ = CASES[case]
    tree, gat = model(cfg)
    want = jax.eval_shape(lambda k: RGNN.init_params(k, rcfg(cfg)), jax.random.PRNGKey(0))
    specs = T.param_specs(cfg)
    got = [(tuple(t.shape), t.dtype, t.device.type) for _, t, _ in convert.param_leaves(specs)]
    assert got == [(w.shape, torch.float32, "meta") for w in jax.tree_util.tree_leaves(want)]
    back = convert.gnn_params_to_numpy(gat)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    a = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert ("head" in dict(a.named_parameters())) == (cfg.readout != "none")
    w0 = a["layers"][0]["w"]
    assert w0.shape == (cfg.d_in, cfg.n_heads * cfg.d_hidden)
    np.testing.assert_allclose(float(w0.std()), 1 / np.sqrt(cfg.d_in), rtol=0.3)


def test_the_chip_smoke_gnn_path_on_the_cpu(tmp_path, one_thread):
    """``chip_smoke.gnn_path`` rehearsed at tiny shapes: every cell steps
    (finite, every leaf moves), the first step equals the CPU path's, two
    forwards of the full graph are bit-identical, the sampled restart is
    bit-identical under deterministic algorithms and its root removed."""
    import chip_smoke

    shapes = {"full_graph_sm": dict(n_nodes=60, n_edges=240, d_feat=20, n_classes=7),
              "molecule": dict(n_nodes=40, n_edges=64, d_feat=8, n_classes=2, n_graphs=8,
                               readout="mean"),
              "minibatch_lg": dict(n_nodes=8 + 8 * 3 + 8 * 6, n_edges=72, d_feat=16,
                                   n_classes=5, n_targets=8),
              "ogb_products": dict(n_nodes=128, n_edges=512, d_feat=12, n_classes=7)}
    rep = chip_smoke.gnn_path(torch, np, 0, {}, device="cpu", shapes=shapes, fanouts=(3, 6),
                              ckpt_parent=tmp_path)
    for shape in shapes:
        r = rep[shape]
        assert len(r["step_ms"]) == chip_smoke.GNN_WARM + chip_smoke.GNN_TIMED
        assert set(r["split"]) == {"forward_ms", "backward_ms", "adamw_ms"}
        assert r["make_s"] >= 0 and r["edges"] > 0
    for shape in chip_smoke.GNN_CPU_CHECK:
        assert rep[shape]["first_step"]["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert rep["ogb_products"]["forward_bit_identical"]
    assert rep["restart"]["leaves"] == 1 + 3 * 6 and rep["restart"]["checkpoint_bytes"] > 0
    assert list(tmp_path.iterdir()) == []
    assert rep["reduced"] == {}
