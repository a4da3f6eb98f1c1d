"""The recommendation models of the reference's ``models/recsys.py`` on
PyTorch: the embedding bags, DeepFM, two-tower retrieval, BERT4Rec and
MIND, with their losses.

``TwoTower`` holds the two-tower parameters: the user and item embedding
tables (``(rows, embed_dim)``, as the reference's) and each tower's MLP as
``nn.Linear`` layers, whose weight is ``(out, in)``, the transpose of the
reference's ``w``.  Its ``user_tower`` and ``item_tower`` compute the
reference's functions: ids clipped to ``[0, vocab - 1]`` (user fields
offset by field), ReLU on every layer but the last, each layer's product
and bias add rounded apart in the parameters' dtype, and the output
divided by its norm clipped at 1e-6, the norm taken in the parameters'
dtype (its squares summed in f32, as JAX sums a bf16 reduction).  The
methods take gradients (``twotower_loss`` trains through them); the
functions of the reference's names (``user_tower``, ``item_tower``,
``twotower_score_pairs``, ``twotower_retrieval``) are the serving forms
and build no graph.

``DeepFM``, ``Bert4Rec`` and ``MIND`` are ``layers.ParamTree``s: their
parameters sit under the reference's tree names and layout (each dense
``w`` is ``(in, out)``), and the functions of the reference's names read
them as the reference reads its dict.  Every loss returns ``(loss,
metrics)`` as the reference's does; the f32 parts (attention, logits,
softmax) are f32 as there.

The ragged bag's segment sum adds each segment's rows in row order
(``torch.segment_reduce`` over the rows sorted by segment), so the card
gives the same bits on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_items: int = 10_000_000
    n_user_fields: int = 8
    user_vocab_per_field: int = 100_000
    embed_dim: int = 256
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    temperature: float = 0.05
    dtype: str = "float32"
    serve_dtype: str | None = None  # the bf16 serving path


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _linear(w_out_in: torch.Tensor, b: torch.Tensor) -> nn.Linear:
    """An ``nn.Linear`` holding ``w_out_in (out, in)`` and ``b (out,)``."""
    lin = nn.Linear(w_out_in.shape[1], w_out_in.shape[0], device="meta")
    lin.weight = nn.Parameter(w_out_in)
    lin.bias = nn.Parameter(b)
    return lin


def _mlp_init(gen: torch.Generator, dims: Sequence[int], dtype, *, device) -> nn.ModuleList:
    """Layers ``dims[i] -> dims[i + 1]``: weights from ``dense_init`` (drawn
    ``(in, out)`` as the reference's, held transposed), zero biases."""
    return nn.ModuleList(
        _linear(L.dense_init(gen, dims[i], dims[i + 1], dtype, device=device).T.contiguous(),
                torch.zeros((dims[i + 1],), dtype=dtype, device=device))
        for i in range(len(dims) - 1))


def _mlp_apply(layers, x: torch.Tensor, *, final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer (an ``nn.Linear``, or a ``{"w", "b"}``
    entry whose ``w`` is ``(in, out)``), the product and the add each
    rounded to the parameters' dtype; ReLU between layers (and after the
    last with ``final_act``)."""
    for i, lin in enumerate(layers):
        if isinstance(lin, nn.Linear):
            x = torch.matmul(x, lin.weight.T) + lin.bias
        else:
            x = torch.matmul(x, lin["w"]) + lin["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-6)`` along the last axis, the norm in ``x``'s
    dtype: squares rounded, summed in f32, the sum rounded, its root."""
    sq = torch.sum(x * x, dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)
    return x / torch.sqrt(sq).clamp_min(1e-6)


class TwoTower(nn.Module):
    """The two towers' parameters and their forward functions."""

    def __init__(self, cfg: TwoTowerConfig, user_embed: torch.Tensor, item_embed: torch.Tensor,
                 user_mlp: nn.ModuleList, item_mlp: nn.ModuleList):
        super().__init__()
        self.cfg = cfg
        self.user_embed = nn.Parameter(user_embed)
        self.item_embed = nn.Parameter(item_embed)
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp

    @property
    def device(self) -> torch.device:
        return self.item_embed.device

    def user_tower(self, user_fields: torch.Tensor) -> torch.Tensor:
        """``user_fields (B, n_user_fields)`` ids → unit ``(B, D)``."""
        cfg = self.cfg
        f = torch.as_tensor(user_fields, device=self.device).to(torch.int64)
        offsets = torch.arange(cfg.n_user_fields, device=self.device) * cfg.user_vocab_per_field
        flat = f.clamp(0, cfg.user_vocab_per_field - 1) + offsets[None, :]
        v = self.user_embed[flat]                                   # (B, F, E)
        return _unit(_mlp_apply(self.user_mlp, v.reshape(v.shape[0], -1)))

    def item_tower(self, item_ids: torch.Tensor) -> torch.Tensor:
        """``item_ids (B,)`` → unit ``(B, D)``."""
        ids = torch.as_tensor(item_ids, device=self.device).to(torch.int64)
        v = self.item_embed[ids.clamp(0, self.cfg.n_items - 1)]
        return _unit(_mlp_apply(self.item_mlp, v))


def twotower_init(gen: torch.Generator, cfg: TwoTowerConfig, *, device="cuda") -> TwoTower:
    """Parameters drawn from ``gen`` (a generator on ``device``) in the
    reference's order: the user table, the item table, the user tower,
    the item tower."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    user_rows = cfg.n_user_fields * cfg.user_vocab_per_field
    user_embed = L.embed_init(gen, user_rows, cfg.embed_dim, dt, device=device)
    item_embed = L.embed_init(gen, cfg.n_items, cfg.embed_dim, dt, device=device)
    user_mlp = _mlp_init(gen, [cfg.n_user_fields * cfg.embed_dim, *cfg.tower_dims], dt,
                         device=device)
    item_mlp = _mlp_init(gen, [cfg.embed_dim, *cfg.tower_dims], dt, device=device)
    return TwoTower(cfg, user_embed, item_embed, user_mlp, item_mlp)


def twotower_init_counter(seed: int, cfg: TwoTowerConfig, *, device="cuda") -> TwoTower:
    """Parameters of ``twotower_init``'s shapes and scales from
    ``layers.counter_normal``: the same bits on every device, and the first
    rows of the item table are the same whatever ``cfg.n_items`` is.
    Streams: 0 the user table, 1 the item table, 2 + i the user tower's
    layer i, 34 + i the item tower's."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def mlp(dims, stream0):
        return nn.ModuleList(
            _linear(L.counter_normal(seed, stream0 + i, dims[i], dims[i + 1],
                                     scale=dims[i] ** -0.5, dtype=dt, device=device)
                    .T.contiguous(), torch.zeros((dims[i + 1],), dtype=dt, device=device))
            for i in range(len(dims) - 1))

    user_rows = cfg.n_user_fields * cfg.user_vocab_per_field
    return TwoTower(
        cfg,
        L.counter_normal(seed, 0, user_rows, cfg.embed_dim, scale=0.02, dtype=dt, device=device),
        L.counter_normal(seed, 1, cfg.n_items, cfg.embed_dim, scale=0.02, dtype=dt,
                         device=device),
        mlp([cfg.n_user_fields * cfg.embed_dim, *cfg.tower_dims], 2),
        mlp([cfg.embed_dim, *cfg.tower_dims], 34),
    )


# the reference's function names, over ``TwoTower``; the serving forms
# build no graph
@torch.no_grad()
def user_tower(params: TwoTower, user_fields, cfg: TwoTowerConfig | None = None) -> torch.Tensor:
    return params.user_tower(user_fields)


@torch.no_grad()
def item_tower(params: TwoTower, item_ids, cfg: TwoTowerConfig | None = None) -> torch.Tensor:
    return params.item_tower(item_ids)


def twotower_loss(params: TwoTower, batch: dict, cfg: TwoTowerConfig | None = None):
    """In-batch sampled softmax with logQ correction.

    batch: user_fields (B, Fu), item_ids (B,), item_logq (B,), the log
    sampling probability of each in-batch negative.  Logits ``u @ i.T``
    in f32 over ``temperature``, minus ``item_logq[None, :]``; the loss is
    ``mean(logsumexp - diag)``."""
    cfg = cfg or params.cfg
    u = params.user_tower(batch["user_fields"])             # (B, D)
    i = params.item_tower(batch["item_ids"])                # (B, D)
    logits = torch.matmul(u, i.T).float() / cfg.temperature
    logits = logits - batch["item_logq"][None, :]           # logQ correction
    diag = torch.arange(logits.shape[0], device=logits.device)
    loss = torch.mean(torch.logsumexp(logits, dim=-1) - logits[diag, diag])
    return loss, {"softmax": loss}


@torch.no_grad()
def twotower_score_pairs(params: TwoTower, batch: dict, cfg: TwoTowerConfig | None = None
                         ) -> torch.Tensor:
    """``sum(u * i)`` per pair, in the parameters' dtype (summed in f32)."""
    u = params.user_tower(batch["user_fields"])
    i = params.item_tower(batch["item_ids"])
    return torch.sum(u * i, dim=-1, dtype=torch.float32).to(u.dtype)


@torch.no_grad()
def twotower_retrieval(params: TwoTower, batch: dict, cfg: TwoTowerConfig | None = None
                       ) -> torch.Tensor:
    """One query batch against ``candidate_ids`` → ``(Q, C)`` f32 scores:
    the towers' outputs widened to f32 (a bf16 product is exact there) and
    one f32 product, the brute-force path the index replaces."""
    u = params.user_tower(batch["user_fields"])
    c = params.item_tower(batch["candidate_ids"])
    return torch.matmul(u.float(), c.float().T)


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def bag_lookup(table: torch.Tensor, ids: torch.Tensor, *, combiner: str = "sum") -> torch.Tensor:
    """Fixed-size bags: ``ids (..., L)`` with -1 padding → ``(..., dim)``."""
    emb = table[ids.long().clamp_min(0)]                    # (..., L, dim)
    mask = (ids >= 0).to(emb.dtype)[..., None]
    emb = emb * mask
    if combiner == "sum":
        return torch.sum(emb, dim=-2)
    if combiner == "mean":
        denom = torch.clamp_min(torch.sum(mask, dim=-2), 1.0)
        return torch.sum(emb, dim=-2) / denom
    raise ValueError(combiner)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor, segment_ids: torch.Tensor,
                         n_segments: int, *, combiner: str = "sum") -> torch.Tensor:
    """Ragged bags: ``flat_ids (T,)`` (-1 padding) summed into the bag of
    ``segment_ids (T,)``, ``(n_segments, dim)`` out (the torch EmbeddingBag
    analogue).  An id that is padding or whose segment is outside
    ``[0, n_segments)`` adds nothing, as the reference's scratch segment
    and ``segment_sum`` drop it (``layers.segment_sum``: no float atomics,
    the same bits on every run)."""
    flat_ids = flat_ids.long()
    emb = table[flat_ids.clamp_min(0)]
    valid = flat_ids >= 0
    emb = emb * valid[:, None].to(emb.dtype)
    out, cnt = L.segment_sum(emb, torch.where(valid, segment_ids.long(), -1), n_segments)
    if combiner == "mean":
        out = out / torch.clamp_min(cnt.to(emb.dtype), 1.0)[:, None]
    elif combiner != "sum":
        raise ValueError(combiner)
    return out


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _ids(x, like: torch.Tensor) -> torch.Tensor:
    """Ids as int64 on ``like``'s device."""
    return torch.as_tensor(x, device=like.device).long()


def _dense(gen: torch.Generator, dims, dtype, *, device) -> list[dict]:
    """The reference's ``_mlp_init``: ``{"w" (in, out), "b"}`` per layer."""
    return [{"w": L.dense_init(gen, dims[i], dims[i + 1], dtype, device=device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


# ---------------------------------------------------------------------------
# DeepFM (arXiv:1703.04247)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    dtype: str = "float32"


class DeepFM(L.ParamTree):
    """``{"embed" (F·V, E), "linear" (F·V, 1), "bias" (), "mlp": [{"w",
    "b"}, ...]}``."""

    def __init__(self, cfg: DeepFMConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def deepfm_init(gen: torch.Generator, cfg: DeepFMConfig, *, device="cuda") -> DeepFM:
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    rows = cfg.n_fields * cfg.vocab_per_field
    return DeepFM(cfg, {
        "embed": L.embed_init(gen, rows, cfg.embed_dim, dt, device=device),
        "linear": L.embed_init(gen, rows, 1, dt, device=device),
        "bias": torch.zeros((), dtype=dt, device=device),
        "mlp": _dense(gen, [cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1], dt, device=device),
    })


def deepfm_forward(params, batch: dict, cfg: DeepFMConfig) -> torch.Tensor:
    """batch: fields (B, n_fields) per-field categorical ids → logits (B,)."""
    ids = _ids(batch["fields"], params["embed"])
    offsets = torch.arange(cfg.n_fields, device=ids.device) * cfg.vocab_per_field
    flat = ids.clamp(0, cfg.vocab_per_field - 1) + offsets[None, :]
    v = params["embed"][flat]                               # (B, F, dim)
    first = params["linear"][flat][..., 0].sum(-1)          # (B,)
    s = torch.sum(v, dim=1)
    fm = 0.5 * torch.sum(s * s - torch.sum(v * v, dim=1), dim=-1)
    deep = _mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return params["bias"] + first + fm + deep


def deepfm_loss(params, batch: dict, cfg: DeepFMConfig):
    loss = _bce(deepfm_forward(params, batch, cfg), batch["labels"])
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690): a bidirectional encoder over item sequences
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    d_ff: int = 256
    seq_len: int = 200
    dtype: str = "float32"

    @property
    def mask_id(self) -> int:
        return self.n_items  # vocab row n_items = [MASK]


class Bert4Rec(L.ParamTree):
    """``{"item_embed" (V + 1, d), "pos_embed" (S, d), "blocks": [{"ln1",
    "ln2", "wq", "wk", "wv", "wo", "mlp": {"wi_gate", "wi_up", "wo"}}],
    "final_norm"}``."""

    def __init__(self, cfg: Bert4RecConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def bert4rec_init(gen: torch.Generator, cfg: Bert4RecConfig, *, device="cuda") -> Bert4Rec:
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    d = cfg.embed_dim
    item_embed = L.embed_init(gen, cfg.n_items + 1, d, dt, device=device)
    pos_embed = L.embed_init(gen, cfg.seq_len, d, dt, device=device)
    blocks = [{
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
        **{w: L.dense_init(gen, d, d, dt, device=device) for w in ("wq", "wk", "wv", "wo")},
        "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, device=device),
    } for _ in range(cfg.n_blocks)]
    return Bert4Rec(cfg, {"item_embed": item_embed, "pos_embed": pos_embed, "blocks": blocks,
                          "final_norm": torch.ones((d,), dtype=dt, device=device)})


def bert4rec_encode(params, items, cfg: Bert4RecConfig) -> torch.Tensor:
    """items (B, S) with -1 padding → hidden (B, S, d).  Bidirectional:
    a padded key gets the additive mask ``-1e30``; attention in f32."""
    items = _ids(items, params["item_embed"])
    b, s = items.shape
    x = params["item_embed"][items.clamp(0, cfg.n_items)] + params["pos_embed"][None, :s]
    pad = items < 0
    x = torch.where(pad[..., None], 0.0, x)
    h = cfg.embed_dim // cfg.n_heads
    for blk in params["blocks"]:
        y = L.rms_norm(x, blk["ln1"])
        q = (y @ blk["wq"]).reshape(b, s, cfg.n_heads, h)
        k = (y @ blk["wk"]).reshape(b, s, cfg.n_heads, h)
        v = (y @ blk["wv"]).reshape(b, s, cfg.n_heads, h)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (h ** 0.5)
        logits = torch.where(pad[:, None, None, :], L.NEG_INF, logits)
        p = torch.softmax(logits, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(x.dtype)
        x = x + att.reshape(b, s, -1) @ blk["wo"]
        x = x + L.mlp(blk["mlp"], L.rms_norm(x, blk["ln2"]))
    return L.rms_norm(x, params["final_norm"])


def bert4rec_loss(params, batch: dict, cfg: Bert4RecConfig):
    """Masked-item prediction.  batch: items (B, S) with ``mask_id`` at the
    masked slots, mask_pos (B, M) positions, mask_label (B, M) with -1
    ignored.  Only the masked positions are scored, against the tied item
    embedding: the logits are (B, M, V), not (B, S, V)."""
    hidden = bert4rec_encode(params, batch["items"], cfg)  # (B, S, d)
    pos = _ids(batch["mask_pos"], hidden).clamp_min(0)
    labels = _ids(batch["mask_label"], hidden)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    picked = hidden[rows, pos]                              # (B, M, d)
    logits = torch.matmul(picked.float(), params["item_embed"][: cfg.n_items].float().T)
    mask = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    ce = torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce, {"ce": ce}


@torch.no_grad()
def bert4rec_score(params, batch: dict, cfg: Bert4RecConfig) -> torch.Tensor:
    """Next-item scores from the last position: (B, V) in f32."""
    hidden = bert4rec_encode(params, batch["items"], cfg)[:, -1]
    return torch.matmul(hidden.float(), params["item_embed"][: cfg.n_items].float().T)


# ---------------------------------------------------------------------------
# MIND (arXiv:1904.08030): multi-interest capsule routing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    label_pow: float = 2.0
    dtype: str = "float32"


class MIND(L.ParamTree):
    """``{"item_embed" (V, d), "bilinear" (d, d), "routing_init" (K, S)
    f32}``: the routing logits' start (the paper's fixed B2I init) is a
    parameter, as in the reference."""

    def __init__(self, cfg: MINDConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def mind_init(gen: torch.Generator, cfg: MINDConfig, *, device="cuda") -> MIND:
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return MIND(cfg, {
        "item_embed": L.embed_init(gen, cfg.n_items, cfg.embed_dim, dt, device=device),
        "bilinear": L.dense_init(gen, cfg.embed_dim, cfg.embed_dim, dt, device=device),
        "routing_init": torch.randn((cfg.n_interests, cfg.seq_len), generator=gen,
                                    device=device, dtype=torch.float32),
    })


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(params, items, cfg: MINDConfig) -> torch.Tensor:
    """Behavior sequence (B, S) → K interest capsules (B, K, d), after
    ``capsule_iters`` routing iterations (softmax over the interests per
    behavior; a padded behavior routes nothing)."""
    items = _ids(items, params["item_embed"])
    valid = items >= 0
    e = params["item_embed"][items.clamp(0, cfg.n_items - 1)]
    e = torch.where(valid[..., None], e, 0.0)
    u = e @ params["bilinear"]                              # (B, S, d)
    b_logits = params["routing_init"][None].expand(items.shape[0], cfg.n_interests, cfg.seq_len)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(valid[:, None, :], b_logits, L.NEG_INF), dim=1)
        z = torch.einsum("bks,bsd->bkd", w.to(u.dtype), u)
        caps = _squash(z.float()).to(u.dtype)               # (B, K, d)
        b_logits = b_logits + torch.einsum("bkd,bsd->bks", caps.float(), u.float())
    return caps


def mind_loss(params, batch: dict, cfg: MINDConfig):
    """Label-aware attention, then the in-batch sampled softmax.

    batch: items (B, S), target (B,) target item id."""
    caps = mind_interests(params, batch["items"], cfg)     # (B, K, d)
    target = _ids(batch["target"], caps)
    t = params["item_embed"][target.clamp(0, cfg.n_items - 1)]
    att = torch.einsum("bkd,bd->bk", caps.float(), t.float())
    att = torch.softmax(cfg.label_pow * att, dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(caps.dtype), caps)  # (B, d)
    logits = torch.matmul(user, t.T).float()
    diag = torch.arange(logits.shape[0], device=logits.device)
    loss = torch.mean(torch.logsumexp(logits, dim=-1) - logits[diag, diag])
    return loss, {"softmax": loss}


@torch.no_grad()
def mind_serve(params, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """Interest capsules for retrieval: (B, K, d), each an ANN query."""
    return mind_interests(params, batch["items"], cfg)
