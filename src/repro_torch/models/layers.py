"""Layers shared by the models (the reference's ``models/layers.py``):
the initialisers, ``ParamTree`` (parameters under the reference's tree
names), a deterministic segment sum, the norms, rotary embeddings, GQA
attention over KV chunks with an online softmax, the SwiGLU MLP and the
capacity-dispatched top-k MoE.

Compute follows the reference's dtypes: attention scores, the softmax
statistics, norms and the router are f32 whatever the parameters' dtype;
a result is cast back to its input's dtype where the reference casts it.

``dense_init`` and ``embed_init`` draw from an explicit ``torch.Generator``
on an explicit device, as the reference's draw from an explicit PRNG key:
one generator state gives one set of parameters (``None`` on the ``meta``
device: shapes only).  ``counter_normal`` is a
draw that the CPU and the card give bit for bit: every value is a hash of
``(seed, stream, row, column)``, so any rows of a table can be made
anywhere, in any order, without the rest of it.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distance import stable_topk

_M32 = 0xFFFFFFFF
# standard deviation of the sum of four uniform 16-bit integers
_SUM4_STD = math.sqrt((65536.0 ** 2 - 1.0) / 3.0)
_SUM4_MEAN = 2 * 65535
_ROWS_PER_CHUNK = 1 << 16


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, dtype, *,
               device) -> torch.Tensor:
    """``(d_in, d_out)`` normal values of standard deviation
    ``1 / sqrt(d_in)``, drawn in f32, then cast to ``dtype``."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator | None, vocab: int, dim: int, dtype, *,
               device) -> torch.Tensor:
    """``(vocab, dim)`` normal values of standard deviation 0.02."""
    t = torch.randn((vocab, dim), generator=gen, device=device, dtype=torch.float32)
    return (t * 0.02).to(dtype)


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` and ``c`` in ``[0, 2^32)``,
    in 16-bit halves so that no product passes 2^48."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32, a bijection of the 32-bit integers (tensors or ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_normal(seed: int, stream: int, n_rows: int, dim: int, *, scale: float,
                   dtype, device) -> torch.Tensor:
    """The first ``n_rows`` rows of a ``(·, dim)`` table of approximately
    normal values of standard deviation ``scale``: each the sum of four
    uniform 16-bit integers of two hashes of its ``(seed, stream, row,
    column)``, centred, scaled in f32 and cast to ``dtype``.  Integer and
    correctly rounded float arithmetic only, so every device gives the same
    bits.  Made ``_ROWS_PER_CHUNK`` rows at a time."""
    if n_rows * dim > 1 << 32:
        raise ValueError(f"a counter table holds at most 2^32 values, not {n_rows} x {dim}")
    out = torch.empty((n_rows, dim), dtype=dtype, device=device)
    salt = _mix32((seed * 0x10001 + stream) & _M32)
    salt_a, salt_b = _mix32(salt ^ 0x68E31DA4), _mix32(salt ^ 0xB5297A4D)
    c = torch.tensor(scale / _SUM4_STD, dtype=torch.float32, device=device)
    cols = torch.arange(dim, dtype=torch.int64, device=device)
    for r0 in range(0, n_rows, _ROWS_PER_CHUNK):
        rows = torch.arange(r0, min(r0 + _ROWS_PER_CHUNK, n_rows), dtype=torch.int64,
                            device=device)
        k = _mix32(rows[:, None] * dim + cols[None, :])
        h1, h2 = _mix32(k ^ salt_a), _mix32(k ^ salt_b)
        s = (h1 & 0xFFFF) + (h1 >> 16) + (h2 & 0xFFFF) + (h2 >> 16) - _SUM4_MEAN
        out[r0:r0 + rows.shape[0]] = (s.to(torch.float32) * c).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

NEG_INF = -1.0e30


class ParamTree(nn.Module):
    """Parameters held under the reference's tree names: a dict's tensors
    become parameters, its dicts sub-modules and its lists
    ``nn.ModuleList``s, so ``named_parameters`` gives the reference's
    paths (``"mlp.0.w"``).  ``tree["name"]`` reads an entry as the
    reference reads its dict, so one function body serves this module and
    a plain dict of tensors."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``segment_sum(x, seg, num_segments=n)`` and each segment's row count
    ``(n,)``.  A row whose segment is outside ``[0, n)`` goes to a scratch
    segment and counts nowhere, as the reference drops it.  The rows are
    sorted by segment (stably) and each segment's rows summed in row order
    by ``torch.segment_reduce``: no float atomics, the same bits on every
    run."""
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)               # scratch segment
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=n + 1)
    sums = torch.segment_reduce(x[order], "sum", lengths=lengths, unsafe=True)
    return sums[:n], lengths[:n]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of ``x (..., S, H, D)`` at ``positions (..., S)``,
    half-split: ``x[..., :D/2]`` rotates against ``x[..., D/2:]``.  The
    frequencies are ``exp(-log(theta) * i / (D/2))`` in f32, as the
    reference computes them; the rotation is f32, cast back to ``x``'s
    dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = torch.as_tensor(positions, device=x.device)[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (online-softmax) attention
# ---------------------------------------------------------------------------

def _attention_mask(q_pos, kv_pos, causal: bool, kv_valid_len):
    """``(Sq, C)``: which keys each query may attend to."""
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=kv_pos.device)
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if kv_valid_len is not None:
        mask = mask & (kv_pos[None, :] < kv_valid_len)
    return mask


def _grouped_queries(q: torch.Tensor, kh: int) -> torch.Tensor:
    """``q (B, Sq, H, D)`` scaled by ``D**-0.5`` in f32, as ``(B, KH, G·Sq,
    D)``: query head ``i`` reads KV head ``i // G``."""
    b, sq, h, d = q.shape
    qr = (q.float() * d ** -0.5).reshape(b, sq, kh, h // kh, d)
    return qr.permute(0, 2, 3, 1, 4).reshape(b, kh, (h // kh) * sq, d)


def _heads_out(o: torch.Tensor, sq: int, dtype) -> torch.Tensor:
    """``(B, KH, G·Sq, D)`` back to ``(B, Sq, H, D)`` in ``dtype``."""
    b, kh, _, d = o.shape
    return o.reshape(b, kh, -1, sq, d).permute(0, 3, 1, 2, 4).reshape(b, sq, -1, d).to(dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      q_offset=0, kv_chunk: int = 1024, kv_valid_len=None) -> torch.Tensor:
    """GQA attention of ``q (B, Sq, H, D)`` over ``k, v (B, Skv, KH, D)``
    with an online softmax over KV chunks; ``(B, Sq, H, D)`` in ``q``'s
    dtype.

    ``q_offset`` shifts the query positions (decode: the cache position);
    ``kv_valid_len`` masks KV positions ``>= len``; either may be an int or
    a 0-d tensor (read on the device: no host sync).  K and V are padded to
    a multiple of ``kv_chunk`` (the padding masked).  Scores and the
    softmax statistics are f32, a masked score ``NEG_INF``, and the sum is
    divided by ``max(l, 1e-30)`` at the end.  Memory: ``O(B·Sq·H·D +
    B·H·Sq·kv_chunk)``, under autograd too: each chunk's step is
    checkpointed (:func:`_chunk_step`); without grad it runs as it is."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, skv)
    pad = (-skv) % kv_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = skv
        skv += pad
    nc = skv // kv_chunk

    dev = q.device
    qr = _grouped_queries(q, kh)                                   # (B, KH, G·Sq, D)
    q_pos = (q_offset + torch.arange(sq, device=dev)).repeat(h // kh)
    m = torch.full(qr.shape[:3], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(qr.shape[:3], dtype=torch.float32, device=dev)
    acc = torch.zeros(qr.shape, dtype=torch.float32, device=dev)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for ci in range(nc):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kv_pos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = _attention_mask(q_pos, kv_pos, causal, kv_valid_len)
        args = (qr, k[:, sl], v[:, sl], mask, m, l, acc)
        if remat:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return _heads_out(out, sq, q.dtype)


def _chunk_step(qr, k, v, mask, m, l, acc):
    """One KV chunk of the online softmax: the chunk's f32 scores, the mask,
    the running max, ``exp``, ``l`` and ``acc`` updated.  Under autograd it
    runs inside ``checkpoint`` (the reference's ``jax.checkpoint(body)``),
    so the backward recomputes one chunk's score tile at a time instead of
    keeping every tile."""
    kc = k.permute(0, 2, 3, 1).to(torch.float32,                   # (B, KH, D, C)
                                  memory_format=torch.contiguous_format)
    vc = v.transpose(1, 2).to(torch.float32,                       # (B, KH, C, D)
                              memory_format=torch.contiguous_format)
    s = torch.matmul(qr, kc)                                       # (B, KH, G·Sq, C)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.matmul(p, vc)
    return m_new, l, acc


def full_attention_ref(q, k, v, *, causal: bool, q_offset=0, kv_valid_len=None):
    """Naive attention (the oracle of :func:`chunked_attention`): every
    score at once, softmax in f32."""
    sq, kh = q.shape[1], k.shape[2]
    dev = q.device
    qr = _grouped_queries(q, kh)
    s = torch.matmul(qr, k.float().permute(0, 2, 3, 1))
    q_pos = (q_offset + torch.arange(sq, device=dev)).repeat(q.shape[2] // kh)
    mask = _attention_mask(q_pos, torch.arange(k.shape[1], device=dev), causal, kv_valid_len)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return _heads_out(torch.matmul(p, v.float().transpose(1, 2)), sq, q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int, dtype, *, device) -> dict:
    """``{"wi_gate", "wi_up", "wo"}``, each from ``dense_init``."""
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator | None, d_model: int, d_ff: int, n_experts: int, dtype, *,
             device) -> dict:
    """``{"router" (d, E) f32, "wi_gate", "wi_up" (E, d, f), "wo" (E, f, d)}``:
    the router from ``dense_init``, the experts normal of standard deviation
    ``1 / sqrt(fan_in)`` drawn in f32, then cast to ``dtype``."""
    def experts(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    return {
        "router": dense_init(gen, d_model, n_experts, torch.float32, device=device),
        "wi_gate": experts((n_experts, d_model, d_ff), d_model),
        "wi_up": experts((n_experts, d_model, d_ff), d_model),
        "wo": experts((n_experts, d_ff, d_model), d_ff),
    }


def moe_gates(params, x: torch.Tensor, top_k: int):
    """``(probs (T, E), gate_vals (T, K), gate_idx (T, K))``: the router's
    softmax in f32, its top-k (ties to the lower expert, as
    ``jax.lax.top_k``) and the top-k values renormalised to sum to 1."""
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    gate_vals, gate_idx = stable_topk(probs, top_k, largest=True)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
    """Top-k token-choice MoE with a capacity per expert (GShard-style) over
    ``x (T, d)``; returns ``(out (T, d), aux)``.

    Each (token, k) assignment takes the next slot of its expert in
    token-major order (an int32 cumsum of the one-hot); past ``capacity``
    it is dropped to the scratch row ``E·capacity``.  Token ids are
    scattered into the slots, then the rows gathered once.  ``aux`` is the
    Switch load-balancing loss ``E · sum(me · ce)``."""
    t, d = x.shape
    e = params["router"].shape[1]
    probs, gate_vals, gate_idx = moe_gates(params, x, top_k)

    experts = torch.arange(e, device=x.device)
    me = probs.mean(dim=0)
    ce = (gate_idx[..., None] == experts).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce)

    capacity = max(1, int(capacity_factor * t * top_k / e))
    flat_e = gate_idx.reshape(-1)                                  # (T·K,) token-major
    # the one-hot expert-major, (E, T·K), so that one flat int32 cumsum (a
    # parallel scan) counts each expert's assignments in token order; the
    # count before each expert's row is taken off
    onehot = (experts[:, None] == flat_e[None, :]).to(torch.int32)
    running = torch.cumsum(onehot.reshape(-1), dim=0, dtype=torch.int32).reshape(e, -1)
    rank = running - (running[:, -1] - onehot.sum(dim=1, dtype=torch.int32))[:, None] - 1
    my_rank = rank.gather(0, flat_e[None, :])[0]                   # rank within the expert
    keep = my_rank < capacity
    slot = flat_e * capacity + torch.clamp_max(my_rank, capacity - 1)
    slot = torch.where(keep, slot, e * capacity)                   # overflow: the scratch row

    token_of = torch.arange(t * top_k, device=x.device) // top_k
    buf_tok = torch.full((e * capacity + 1,), t, dtype=torch.int64, device=x.device)
    buf_tok[slot] = token_of
    x_aug = torch.cat([x, x.new_zeros((1, d))], dim=0)
    buf = x_aug[buf_tok[:-1]].reshape(e, capacity, d)

    gate_h = torch.nn.functional.silu(torch.bmm(buf, params["wi_gate"]))
    up_h = torch.bmm(buf, params["wi_up"])
    out_e = torch.bmm(gate_h * up_h, params["wo"])

    out_flat = out_e.reshape(e * capacity, d)
    per_k = out_flat[torch.clamp_max(slot, e * capacity - 1)] * keep.to(x.dtype)[:, None]
    per_k = per_k * gate_vals.reshape(-1)[:, None].to(x.dtype)
    return per_k.reshape(t, top_k, d).sum(dim=1), aux


def moe_ref(params, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Naive per-token MoE (no capacity drops): the oracle of :func:`moe`."""
    _, gate_vals, gate_idx = moe_gates(params, x, top_k)
    out = torch.zeros_like(x)
    for ki in range(top_k):
        e_idx = gate_idx[:, ki]
        h = (torch.nn.functional.silu(torch.einsum("td,tdf->tf", x, params["wi_gate"][e_idx]))
             * torch.einsum("td,tdf->tf", x, params["wi_up"][e_idx]))
        out = out + (torch.einsum("tf,tfd->td", h, params["wo"][e_idx])
                     * gate_vals[:, ki:ki + 1].to(x.dtype))
    return out
