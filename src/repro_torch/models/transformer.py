"""Decoder-only GQA transformer LM, dense and MoE (the reference's
``models/transformer.py``), on PyTorch.

Covers the five LM architectures of the registry (granite-20b,
deepseek-7b, qwen1.5-110b with QKV bias, granite-moe-1b-a400m with 32
experts top-8, phi3.5-moe with 16 experts top-2).  Three entry points:

  * ``loss_fn``     — next-token cross entropy (+ the MoE aux loss) for
    ``make_train_step``;
  * ``prefill``     — the prompt pass: last-position logits and the KV cache;
  * ``decode_step`` — one token against the KV cache, written in place.

The parameters are one ``LM`` (a ``layers.ParamTree``) under the
reference's tree names; its ``layers`` leaves are stacked ``(L, …)``
tensors, as the reference's ``vmap`` makes them, so a checkpoint and
``convert`` see the reference's tree.  The forward loops over the layers'
slices.  The reference's nested remat is here: under autograd each KV
chunk of ``chunked_attention`` is checkpointed, and with ``cfg.remat``
``loss_fn`` checkpoints each layer (``torch.utils.checkpoint``, as
``jax.checkpoint(body)``), so a training step keeps one ``(B, S, d)``
input a layer and recomputes the rest in its backward.  The recomputation
is the same arithmetic: the loss and every gradient are the same bits
with ``remat`` on or off.  Serving (``prefill``, ``decode_step``) runs
without grad and checkpoints nothing.  The reference's ``act_constraint``
is a sharding hint for a mesh (the identity on one card) and has no
counterpart.  Logits are the f32 product of
the final hidden state and ``lm_head`` (the reference's
``preferred_element_type=f32``); columns at or past ``vocab`` are
``-1e30``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import torch_dtype


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    vocab: int = 32000
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    head_dim: int | None = None
    qkv_bias: bool = False
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    kv_chunk: int = 1024
    remat: bool = True
    aux_loss_weight: float = 0.01
    # the reference's scan-over-layers unroll factor (read by its dry run)
    scan_unroll: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding and head tables padded to a multiple of 256 (e.g.
        granite's 49,155); logit columns ``>= vocab`` are masked."""
        return ((self.vocab + 255) // 256) * 256

    def _per_layer(self, experts: int) -> int:
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        ffn = experts * 3 * d * self.d_ff + d * self.n_experts if self.moe else 3 * d * self.d_ff
        return attn + ffn + 2 * d

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting; without
        the QKV biases, as the reference counts)."""
        return (self.n_layers * self._per_layer(self.n_experts)
                + 2 * self.vocab_padded * self.d_model + self.d_model)

    @property
    def n_active_params(self) -> int:
        """Parameters a token activates (MoE: its ``top_k`` experts)."""
        if not self.moe:
            return self.n_params
        return (self.n_layers * self._per_layer(self.moe_top_k)
                + 2 * self.vocab_padded * self.d_model + self.d_model)


class LM(L.ParamTree):
    """``{"embed" (Vp, d), "layers": {"ln1", "ln2" (L, d), "wq" (L, d, H·hd),
    "wk", "wv" (L, d, KH·hd), "wo" (L, H·hd, d), ["bq", "bk", "bv"],
    "mlp" | "moe": {...}}, "final_norm" (d,), "lm_head" (d, Vp)}``."""

    def __init__(self, cfg: LMConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator | None, cfg: LMConfig, *, device) -> dict:
    dt = torch_dtype(cfg.dtype)
    d, hd = cfg.d_model, cfg.hd
    p = {
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, dt, device=device),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dt, device=device),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dt, device=device),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
    if cfg.moe:
        p["moe"] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, dt, device=device)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dt, device=device)
    return p


def _stacked_like(tree: dict, n: int) -> dict:
    return {k: _stacked_like(v, n) if isinstance(v, dict)
            else v.new_empty((n, *v.shape)) for k, v in tree.items()}


def _store_layer(stacked: dict, tree: dict, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _store_layer(stacked[k], v, i)
        else:
            stacked[k][i] = v


def init_params(gen: torch.Generator | None, cfg: LMConfig, *, device="cuda") -> LM:
    """The LM's parameters on ``device``, drawn from ``gen`` in the order
    embed, layer 0 … L-1, head.  Each layer is drawn on its own and
    written into the preallocated ``(L, …)`` stack.  ``gen=None`` on the
    ``meta`` device gives the shapes alone (:func:`param_specs`)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    embed = L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, device=dev)
    layers = None
    for i in range(cfg.n_layers):
        lp = _init_layer(gen, cfg, device=dev)
        if layers is None:
            layers = _stacked_like(lp, cfg.n_layers)
        if dev.type == "meta":
            break                       # shapes only: nothing to draw or store
        _store_layer(layers, lp, i)
        del lp
    return LM(cfg, {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt, device=dev),
    })


def param_specs(cfg: LMConfig) -> LM:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return init_params(None, cfg, device="meta")


def layer_params(params: LM, i: int) -> dict:
    """Layer ``i``'s parameters: a tree of views into the stacked leaves."""
    def take(node):
        if isinstance(node, torch.Tensor):
            return node[i]
        return {k: take(v) for k, v in [*node.named_parameters(recurse=False),
                                        *node.named_children()]}
    return take(params["layers"])


# ---------------------------------------------------------------------------
# Layer body (shared by train, prefill and decode)
# ---------------------------------------------------------------------------

def _qkv(lp: dict, h: torch.Tensor, cfg: LMConfig):
    b, s, _ = h.shape
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.hd), k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def _ffn(lp: dict, x2: torch.Tensor, cfg: LMConfig):
    if cfg.moe:
        b, s, d = x2.shape
        y, aux = L.moe(lp["moe"], x2.reshape(b * s, d), top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor)
        return y.reshape(b, s, d), aux
    return L.mlp(lp["mlp"], x2), torch.zeros((), dtype=torch.float32, device=x2.device)


def _layer_train(x: torch.Tensor, lp: dict, cfg: LMConfig, positions: torch.Tensor):
    """One layer over the whole sequence: ``(out, aux, k, v)``, ``k`` and
    ``v`` rotated, for the cache."""
    h = L.rms_norm(x, lp["ln1"])
    q, k, v = _qkv(lp, h, cfg)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    att = L.chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
    b, s, _, _ = att.shape
    x = x + att.reshape(b, s, -1) @ lp["wo"]
    y, aux = _ffn(lp, L.rms_norm(x, lp["ln2"]), cfg)
    return x + y, aux, k, v


def _layer_remat(x: torch.Tensor, lp: dict, cfg: LMConfig, positions: torch.Tensor):
    """:func:`_layer_train`'s ``(out, aux)``, the body ``loss_fn``
    checkpoints."""
    x, aux, _, _ = _layer_train(x, lp, cfg, positions)
    return x, aux


def _mask_pad_vocab(logits: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab, -1e30)


def _logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """``rms_norm(x) @ lm_head`` as an f32 product of the parameters'
    values (exact in f32 for bf16), the padded vocab masked."""
    x = L.rms_norm(x, params["final_norm"])
    return _mask_pad_vocab(x.float() @ params["lm_head"].float(), cfg)


def _tokens(tokens, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tokens, device=like.device).long()


# ---------------------------------------------------------------------------
# Train loss
# ---------------------------------------------------------------------------

def loss_fn(params, batch: dict, cfg: LMConfig):
    """Next-token cross entropy: ``batch["tokens"] (B, S)``,
    ``batch["labels"] (B, S)`` with -1 = ignore.  Returns ``(loss,
    {"ce", "aux"})``, ``loss = ce + aux_loss_weight · aux / n_layers``."""
    tokens = _tokens(batch["tokens"], params["embed"])
    labels = _tokens(batch["labels"], params["embed"])
    s = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if remat:
            x, a = checkpoint(_layer_remat, x, lp, cfg, positions, use_reentrant=False)
        else:
            x, a, _, _ = _layer_train(x, lp, cfg, positions)
        aux = aux + a
    logits = _logits(params, x, cfg)                                  # (B, S, Vp) f32
    mask = (labels >= 0).float()
    safe = torch.clamp_min(labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    loss = ce + cfg.aux_loss_weight * aux / cfg.n_layers
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """``{"k", "v"}``, each ``(L, B, max_len, KH, hd)`` zeros in the
    parameters' dtype."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.no_grad()
def prefill(params, tokens, cfg: LMConfig):
    """The prompt pass over ``tokens (B, S)``: ``(last-position logits
    (B, Vp) f32, {"k", "v"} (L, B, S, KH, hd))``, each layer's rotated K and
    V written into the preallocated cache."""
    tokens = _tokens(tokens, params["embed"])
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
    cache = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    for i in range(cfg.n_layers):
        x, _, k, v = _layer_train(x, layer_params(params, i), cfg, positions)
        cache["k"][i] = k
        cache["v"][i] = v
    return _logits(params, x[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, cache: dict, tokens, pos, cfg: LMConfig):
    """One decode step at position ``pos`` (an int or a 0-d int tensor)
    over ``tokens (B,)``: attends to ``cache[:pos]`` and the new token;
    writes the token's K and V at ``pos`` in place (clamped into the cache,
    as the reference's ``dynamic_update_slice`` clamps) and returns
    ``(logits (B, Vp) f32, cache)``.  Reads nothing back to the host."""
    tokens = _tokens(tokens, params["embed"])
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None, :]                          # (B, 1, d)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos.reshape(1)
    s_max = cache["k"].shape[2]
    at = torch.clamp(pos, 0, s_max - 1).reshape(1).long()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, lp["ln1"])
        q, k_new, v_new = _qkv(lp, h, cfg)
        q = L.rope(q, positions, cfg.rope_theta)
        k_new = L.rope(k_new, positions, cfg.rope_theta)
        kc.index_copy_(1, at, k_new.to(kc.dtype))
        vc.index_copy_(1, at, v_new.to(vc.dtype))
        # one chunk over the whole cache: a plain softmax
        att = L.chunked_attention(q, kc, vc, causal=False, q_offset=pos, kv_chunk=s_max,
                                  kv_valid_len=pos + 1)
        x = x + att.reshape(b, 1, -1) @ lp["wo"]
        y, _ = _ffn(lp, L.rms_norm(x, lp["ln2"]), cfg)
        x = x + y
    return _logits(params, x[:, 0], cfg), cache
