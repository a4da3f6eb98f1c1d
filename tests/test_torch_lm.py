"""Port vs reference for the LM family (``repro_torch.models.layers``'
rotary, attention and MoE; ``repro_torch.models.transformer``): the same
numpy inputs from a seed through both packages, the reference's params
carried over by ``convert.lm_params_from_numpy``.

Tolerances: f32 ``rtol = atol = 1e-5`` (sums in another order; the
reference's MoE ``gate_idx`` equal); gradients ``1e-4`` relative to each
leaf's largest value; bf16 logits within ``3e-2 · max|logits|`` (both
packages round every bf16 product and residual add to 8 bits, but JAX's
CPU matmul and PyTorch's accumulate in another order and round at other
steps, so two bf16 paths may differ by a few units of 2^-8 at each of the
two layers; the f32 head then carries that to the logits).  The port's own
prefill/decode consistency at f32 holds at ``1e-5``.  The remat (each
layer and each KV chunk checkpointed under autograd) changes no bit of
the loss or a gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_7b as RDS, granite_20b as RG20, qwen15_110b as RQW
from repro.configs import granite_moe_1b_a400m as RGM, phi35_moe_42b_a6_6b as RPHI
from repro.models import layers as RL, transformer as RT
from repro_torch import convert
from repro_torch.configs import deepseek_7b, granite_20b, granite_moe_1b_a400m
from repro_torch.configs import phi35_moe_42b_a6_6b, qwen15_110b
from repro_torch.models import layers as TL, transformer as TT
from repro_torch.train.optimizer import value_and_grad

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
BF16_REL = 3e-2
# the reference's and the port's config module of each arch
ARCHS = {"deepseek-7b": (RDS, deepseek_7b), "granite-20b": (RG20, granite_20b),
         "qwen1.5-110b": (RQW, qwen15_110b), "granite-moe-1b-a400m": (RGM, granite_moe_1b_a400m),
         "phi3.5-moe-42b-a6.6b": (RPHI, phi35_moe_42b_a6_6b)}
# the smoke configs the model tests run: dense MHA, MQA, GQA + QKV bias, two MoEs
SMOKES = {arch: mods[1].SMOKE for arch, mods in ARCHS.items()}
_JIT: dict = {}


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many tiny ops: a pool of threads
    per op costs more than the op here, the more so beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_fn(name):
    """The reference's ``transformer.<name>``, compiled once (its config static)."""
    if name not in _JIT:
        fn = getattr(RT, name)
        _JIT[name] = jax.jit(fn, static_argnums=(fn.__code__.co_argcount - 1,))
    return _JIT[name]


def rcfg(cfg):
    return RT.LMConfig(**dataclasses.asdict(cfg))


def model(cfg, seed=0):
    """``(reference params as a numpy tree, the port's LM over them on the CPU)``."""
    tree = jax.tree_util.tree_map(np.asarray, RT.init_params(jax.random.PRNGKey(seed), rcfg(cfg)))
    return tree, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------- layers -----------------------------------

@pytest.mark.parametrize("pos_shape,d,theta,max_pos", [
    ((16,), 8, 10000.0, 64), ((2, 16), 16, 10000.0, 64), ((24,), 64, 500000.0, 64),
    ((2, 8), 64, 10000.0, 32768),          # decode_32k's positions
])
def test_rope_matches_the_reference(rng, pos_shape, d, theta, max_pos):
    """At the smoke's positions within 1e-5.  Past them the bound grows
    with the position: XLA's and PyTorch's f32 ``exp`` are not correctly
    rounded and may give a frequency one ulp apart (held below), which
    moves the angle by ``pos · ulp``."""
    x = rng.normal(size=(2, pos_shape[-1], 3, d)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=pos_shape).astype(np.int32)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    atol = 1e-5 if max_pos <= 64 else 1e-5 + 2 * max_pos * 2.0 ** -23 * np.abs(x).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
    half = d // 2
    r_freqs = np.asarray(jnp.exp(-np.log(theta) * jnp.arange(0, half, dtype=jnp.float32) / half))
    t_freqs = torch.exp(-np.log(theta) * torch.arange(0, half, dtype=torch.float32) / half)
    assert np.abs(t_freqs.numpy().view(np.int32) - r_freqs.view(np.int32)).max() <= 1


@pytest.mark.parametrize("b,sq,skv,h,kh,d,causal", [
    (2, 16, 16, 4, 4, 8, True),
    (2, 16, 16, 4, 2, 8, True),    # GQA
    (1, 8, 32, 4, 1, 16, False),   # MQA cross
    (2, 32, 32, 8, 4, 16, True),
    (2, 20, 20, 4, 2, 8, True),    # K and V padded to the chunk
])
def test_chunked_attention_matches_the_reference(rng, b, sq, skv, h, kh, d, causal):
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    want = jax.jit(lambda q, k, v: (RL.chunked_attention(q, k, v, causal=causal, kv_chunk=8),
                                    RL.full_attention_ref(q, k, v, causal=causal)))(jq, jk, jv)
    got = TL.chunked_attention(tq, tk, tv, causal=causal, kv_chunk=8).numpy()
    np.testing.assert_allclose(got, np.asarray(want[0]), **F32)
    np.testing.assert_allclose(TL.full_attention_ref(tq, tk, tv, causal=causal).numpy(),
                               np.asarray(want[1]), **F32)
    np.testing.assert_allclose(got, TL.full_attention_ref(tq, tk, tv, causal=causal).numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_chunked_attention_valid_len(rng, as_tensor):
    b, s, h, d = 1, 1, 2, 8
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, 16, h, d)).astype(np.float32)
    v = rng.normal(size=(b, 16, h, d)).astype(np.float32)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                kv_chunk=4, kv_valid_len=jnp.asarray(5), q_offset=jnp.asarray(4))
    arg = (lambda x: torch.tensor(x)) if as_tensor else (lambda x: x)
    got = TL.chunked_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               causal=False, kv_chunk=4, kv_valid_len=arg(5), q_offset=arg(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    only5 = TL.full_attention_ref(torch.as_tensor(q), torch.as_tensor(k[:, :5]),
                                  torch.as_tensor(v[:, :5]), causal=False)
    np.testing.assert_allclose(got.numpy(), only5.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.25])
def test_moe_matches_the_reference(rng, capacity_factor):
    """Ample capacity (4.0: no drop, equal to the naive loop too) and
    dropping capacity (0.25): the same gates, kept slots, output and aux."""
    params = jax.tree_util.tree_map(np.asarray, RL.init_moe(jax.random.PRNGKey(0), 16, 32,
                                                            n_experts=4, dtype=jnp.float32))
    x = rng.normal(size=(64, 16)).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tx = torch.as_tensor(x)
    want, want_aux = jax.jit(lambda p, x: RL.moe(p, x, top_k=2, capacity_factor=capacity_factor)
                             )(params, jnp.asarray(x))
    got, aux = TL.moe(tp, tx, top_k=2, capacity_factor=capacity_factor)
    _, r_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1), 2)
    assert np.array_equal(TL.moe_gates(tp, tx, 2)[2].numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    assert float(aux) > 0 and torch.isfinite(got).all()
    r_ref = jax.jit(lambda p, x: RL.moe_ref(p, x, top_k=2))(params, jnp.asarray(x))
    np.testing.assert_allclose(TL.moe_ref(tp, tx, top_k=2).numpy(), np.asarray(r_ref), **F32)
    if capacity_factor >= 4.0:
        np.testing.assert_allclose(got.numpy(), TL.moe_ref(tp, tx, top_k=2).numpy(),
                                   rtol=1e-3, atol=1e-4)
    else:
        dropped = np.abs(got.numpy() - TL.moe_ref(tp, tx, top_k=2).numpy()).max(axis=1) > 1e-4
        assert dropped.any()


def test_moe_gates_break_ties_toward_the_lower_expert():
    params = {"router": torch.zeros((4, 6))}
    probs, vals, idx = TL.moe_gates(params, torch.ones((3, 4)), 3)
    assert idx.tolist() == [[0, 1, 2]] * 3
    assert torch.allclose(vals, torch.full((3, 3), 1 / 3))


# ------------------------------- the LM -----------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-110b", "granite-moe-1b-a400m"])
def test_loss_and_grads_match_the_reference(arch):
    cfg = SMOKES[arch]
    tree, lm = model(cfg)
    toks = tokens(cfg, 2, 24)
    labels = toks.copy()
    labels[:, -3:] = -1                                  # ignored positions
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (want, wm), rg = jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, b, rcfg(cfg)),
                                                has_aux=True))(tree, jb)
    (got, gm), grads = value_and_grad(lambda p, b: TT.loss_fn(p, b, cfg), lm,
                                      {"tokens": torch.as_tensor(toks),
                                       "labels": torch.as_tensor(labels)})
    np.testing.assert_allclose(float(got), float(want), **F32)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **F32)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), **F32)
    leaves = convert.param_leaves(lm)
    rleaves = jax.tree_util.tree_leaves(rg)
    assert len(leaves) == len(rleaves) == len(grads)
    for (path, _, _), g, r in zip(leaves, grads, rleaves):
        r = np.asarray(r)
        assert g.shape == r.shape, path
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(r).max(), 1e-30), err_msg=str(path))


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-110b", "granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_remat_on_and_off_give_the_same_bits(arch):
    """``loss_fn`` with each layer checkpointed (``remat``) and without:
    the loss and every gradient bit-identical (the recomputation is the
    same arithmetic), over several KV chunks with padding; and with the
    remat still the reference's ``jax.grad`` within the tolerance above."""
    cfg = SMOKES[arch]
    tree, _ = model(cfg)
    toks = tokens(cfg, 2, 2 * cfg.kv_chunk + 5)
    labels = toks.copy()
    labels[:, :2] = -1
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        lm = convert.lm_params_from_numpy(tree, c, device="cpu")
        out[remat] = value_and_grad(lambda p, b, c=c: TT.loss_fn(p, b, c), lm, batch)
    (l_on, m_on), g_on = out[True]
    (l_off, m_off), g_off = out[False]
    assert torch.equal(l_on, l_off) and torch.equal(m_on["aux"], m_off["aux"])
    assert len(g_on) == len(g_off) and all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (want, _), rg = jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, b, rcfg(cfg)),
                                                has_aux=True))(tree, jb)
    np.testing.assert_allclose(float(l_on), float(want), **F32)
    for g, r in zip(g_on, jax.tree_util.tree_leaves(rg)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(r).max(), 1e-30))


def _saved_bytes(fn):
    """Bytes of the tensors autograd keeps for the backward while ``fn``
    runs, outside any checkpointed region (what the step holds)."""
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen)


def test_the_remat_keeps_less_for_the_backward(monkeypatch, one_thread):
    """What autograd saves outside the checkpointed regions: a checkpointed
    layer keeps its input, not its activations; a checkpointed KV chunk
    keeps its running statistics, not its ``(B, KH, G·Sq, C)`` f32 score
    tile and softmax, against the same chunks run without the checkpoint."""
    cfg = dataclasses.replace(SMOKES["deepseek-7b"], n_layers=3)
    _, lm = model(cfg)
    toks = torch.as_tensor(tokens(cfg, 2, 4 * cfg.kv_chunk))
    batch = {"tokens": toks, "labels": toks}
    kept = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        (loss, _), kept[remat] = _saved_bytes(lambda c=c: TT.loss_fn(lm, batch, c))
        loss.backward()
    assert kept[True] < kept[False] / 2, kept
    b, s, h, d = 2, 256, 4, 8
    q, k, v = (torch.randn(b, s, h, d, requires_grad=True) for _ in range(3))
    out, chunked = _saved_bytes(lambda: TL.chunked_attention(q, k, v, causal=True, kv_chunk=64))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    monkeypatch.setattr(TL, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain, unchecked = _saved_bytes(lambda: TL.chunked_attention(q, k, v, causal=True,
                                                                 kv_chunk=64))
    assert torch.equal(out, plain)
    assert all(torch.equal(x, y) for x, y in zip(grads, torch.autograd.grad(plain.sum(),
                                                                            (q, k, v))))
    tiles = (s // 64) * b * h * s * 64 * 4                # every chunk's f32 score tile
    assert chunked * 4 < unchecked and chunked < tiles < unchecked, (chunked, tiles, unchecked)


def test_serving_checkpoints_nothing(monkeypatch):
    """``prefill`` and ``decode_step`` run without grad: no chunk or layer
    goes through ``checkpoint`` (the serving numbers do not move), while a
    training loss does."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return fn(*args)

    monkeypatch.setattr(TL, "checkpoint", counting)
    monkeypatch.setattr(TT, "checkpoint", counting)
    cfg = SMOKES["granite-moe-1b-a400m"]
    _, lm = model(cfg)
    toks = torch.as_tensor(tokens(cfg, 2, 3 * cfg.kv_chunk))
    logits, cache = TT.prefill(lm, toks, cfg)
    TT.decode_step(lm, cache, toks[:, -1], toks.shape[1] - 1, cfg)
    assert calls == []
    value_and_grad(lambda p, b: TT.loss_fn(p, b, cfg), lm, {"tokens": toks, "labels": toks})
    assert calls.count("_layer_remat") == cfg.n_layers
    assert calls.count("_chunk_step") == 3 * cfg.n_layers


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_prefill_and_decode_match_the_reference(arch):
    """``prefill`` over 12 tokens (logits and cache), then ``decode_step``
    of token 12 on the cache padded to 16, both against the reference's."""
    cfg = SMOKES[arch]
    tree, lm = model(cfg)
    toks = tokens(cfg, 2, 13)
    want, rcache = ref_fn("prefill")(tree, jnp.asarray(toks[:, :12]), rcfg(cfg))
    got, cache = TT.prefill(lm, torch.as_tensor(toks[:, :12]), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for name in ("k", "v"):
        assert cache[name].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]), **F32)

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    rc = {k: jnp.pad(v, pad) for k, v in rcache.items()}
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in cache.items()}
    want, rc = ref_fn("decode_step")(tree, rc, jnp.asarray(toks[:, 12]), jnp.asarray(12, jnp.int32),
                                     rcfg(cfg))
    k_before = tc["k"]
    got, tc2 = TT.decode_step(lm, tc, torch.as_tensor(toks[:, 12]),
                              torch.tensor(12, dtype=torch.int32), cfg)
    assert tc2 is tc and tc2["k"] is k_before                    # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **F32)


def test_decode_clamps_a_position_past_the_cache():
    """``pos`` = the cache length writes the last slot, as the reference's
    ``dynamic_update_slice`` clamps it."""
    cfg = SMOKES["granite-20b"]
    tree, lm = model(cfg)
    toks = tokens(cfg, 2, 9)
    _, rcache = ref_fn("prefill")(tree, jnp.asarray(toks[:, :8]), rcfg(cfg))
    _, cache = TT.prefill(lm, torch.as_tensor(toks[:, :8]), cfg)
    want, rc = ref_fn("decode_step")(tree, rcache, jnp.asarray(toks[:, 8]),
                                     jnp.asarray(8, jnp.int32), rcfg(cfg))
    got, tc = TT.decode_step(lm, cache, torch.as_tensor(toks[:, 8]), 8, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(rc["k"]), **F32)


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_port_decode_equals_a_longer_prefill(arch):
    """Decode at position S equals the prefill over S + 1 tokens (the
    reference's ``test_lm_prefill_decode_consistency``; the MoE's capacity
    is ample at this size: 2 tokens a step)."""
    cfg = dataclasses.replace(SMOKES[arch], capacity_factor=8.0)
    lm = TT.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    toks = torch.as_tensor(tokens(cfg, 2, 21, seed=1))
    full, _ = TT.prefill(lm, toks, cfg)
    _, cache = TT.prefill(lm, toks[:, :20], cfg)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
    dec, _ = TT.decode_step(lm, cache, toks[:, 20], 20, cfg)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **F32)


def test_bf16_prefill_matches_the_reference():
    """granite-moe's smoke in bf16 (GQA, MoE, a router in f32): logits
    within ``BF16_REL · max|logits|``, the cache within 2^-6 relative."""
    cfg = dataclasses.replace(SMOKES["granite-moe-1b-a400m"], dtype="bfloat16", vocab=250)
    tree, lm = model(cfg)
    assert lm.layers.moe.router.dtype == torch.float32 and lm.embed.dtype == torch.bfloat16
    toks = tokens(cfg, 2, 24)
    want, rcache = ref_fn("prefill")(tree, jnp.asarray(toks), rcfg(cfg))
    got, cache = TT.prefill(lm, torch.as_tensor(toks), cfg)
    want = np.asarray(want)
    assert (got[:, 250:] == -1e30).all() and (want[:, 250:] == -1e30).all()
    live = want[:, :250]
    assert np.abs(got[:, :250].numpy() - live).max() <= BF16_REL * np.abs(live).max()
    k = np.asarray(rcache["k"]).astype(np.float32)
    assert np.abs(f32(cache["k"]) - k).max() <= 2 ** -6 * np.abs(k).max()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_specs_match_the_reference(arch):
    ref_mod, mod = ARCHS[arch]
    cfg = mod.CONFIG
    specs = TT.param_specs(cfg)
    assert all(p.device.type == "meta" for p in specs.parameters())
    rspec = RT.param_specs(ref_mod.CONFIG)
    got = [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t, _ in convert.param_leaves(specs)]
    want = [(tuple(getattr(k, "key", None) for k in path), tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(rspec)[0]]
    assert got == want
    bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd if cfg.qkv_bias else 0
    assert sum(p.numel() for p in specs.parameters()) == cfg.n_params + bias
    assert (cfg.n_params, cfg.n_active_params) == (ref_mod.CONFIG.n_params,
                                                   ref_mod.CONFIG.n_active_params)


def test_params_cross_both_ways_and_init_is_seeded():
    cfg = dataclasses.replace(SMOKES["phi3.5-moe-42b-a6.6b"], dtype="bfloat16")
    tree, lm = model(cfg)
    back = convert.lm_params_to_numpy(lm)
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                convert.tree_paths(back)):
        assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), p1
    g = lambda: torch.Generator().manual_seed(5)                   # noqa: E731
    a, b = (TT.init_params(g(), cfg, device="cpu") for _ in range(2))
    for (pa, ta, _), (pb, tb, _) in zip(convert.param_leaves(a), convert.param_leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
    assert a.layers.wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    assert not torch.equal(a.layers.wq[0], a.layers.wq[1])          # each layer its own draw
    with pytest.raises(TypeError):
        convert.lm_params_from_numpy({**tree, "embed": np.asarray(tree["embed"], np.float32)},
                                     cfg, device="cpu")


def test_the_chip_smoke_lm_path_on_the_cpu(tmp_path, one_thread):
    """``chip_smoke.lm_path`` rehearsed at small widths: its prefill
    bit-identity, decode, consistency and card-vs-CPU checks all run (the
    card is the CPU here), with the report's fields filled; then its
    training part, ``chip_smoke.lm_train_path``."""
    import chip_smoke

    moe = dataclasses.replace(granite_moe_1b_a400m.CONFIG, n_layers=3, d_model=128, n_heads=4,
                              n_kv_heads=2, d_ff=64, n_experts=8, moe_top_k=2, vocab=1000,
                              kv_chunk=32)
    dense = dataclasses.replace(deepseek_7b.CONFIG, n_layers=4, d_model=128, n_heads=4,
                                n_kv_heads=4, d_ff=256, vocab=1024, kv_chunk=32)
    rep = chip_smoke.lm_path(torch, np, 0, {}, device="cpu",
                             configs={chip_smoke.LM_MOE: moe, chip_smoke.LM_DENSE: dense},
                             prefill=dict(batch=2, seq=96), decode=dict(batch=4, seq=64), steps=3,
                             consist=dict(batch=2, seq=40), cpu=dict(layers=2, batch=1, seq=24))
    m = rep[chip_smoke.LM_MOE]
    assert m["prefill"]["bit_identical"] and m["prefill"]["tokens_per_s"] > 0
    assert set(m["prefill"]["layer0"]) == {"attention_ms", "ffn_ms", "rest_ms"}
    assert m["decode"]["steps"] == 3 and not m["decode"]["sync_free"]
    assert rep[chip_smoke.LM_DENSE]["decode_vs_prefill_rel_err"] <= chip_smoke.LM_CONSIST_REL
    cut = rep["card_vs_cpu"][chip_smoke.LM_MOE]
    assert cut["moe_layers"] == 2 and cut["gate_idx_differ"] == 0
    assert set(rep["reduced"]) == {f"{chip_smoke.LM_MOE}/prefill_32k",
                                   f"{chip_smoke.LM_MOE}/decode_32k", chip_smoke.LM_DENSE,
                                   "card_vs_cpu"}
    # the training part (bf16 as granite-moe's CONFIG): train_4k steps, the
    # first step against the CPU, remat on against off, the restart
    # (bit-identical, its root removed)
    tiny = dataclasses.replace(moe, n_layers=2, d_model=64, d_ff=32, n_experts=4, vocab=256,
                               kv_chunk=16)
    train = chip_smoke.lm_train_path(
        torch, np, 0, {}, device="cpu", cfg=tiny, batch=2, seq=40,
        cpu=dict(layers=2, batch=1, seq=24), remat=dict(layers=2, batch=2, seq=40),
        restart=dict(layers=2, batch=2, seq=24, steps=4), ckpt_parent=tmp_path)
    full = train["train_4k"]
    assert len(full["step_ms"]) == chip_smoke.LM_TRAIN_WARM + chip_smoke.LM_TRAIN_TIMED
    assert set(full["split"]) == {"forward_ms", "backward_ms", "adamw_ms"}
    assert full["tokens_per_s"] > 0 and full["peak_bytes"] is None
    assert train["card_vs_cpu"]["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert train["remat"]["remat_on"]["loss"] == train["remat"]["remat_off"]["loss"]
    assert train["restart"]["steps"] == 4 and train["restart"]["checkpoint_bytes"] > 0
    assert list(tmp_path.iterdir()) == []
    assert set(train["reduced"]) == {f"{chip_smoke.LM_MOE}/train_4k", "card_vs_cpu", "remat",
                                     "restart"}
