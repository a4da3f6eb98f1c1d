"""Two-tower retrieval (YouTube RecSys'19 style): the towers of the
reference's ``models/recsys.py`` on PyTorch.

``TwoTower`` holds the parameters: the user and item embedding tables
(``(rows, embed_dim)``, as the reference's) and each tower's MLP as
``nn.Linear`` layers, whose weight is ``(out, in)``, the transpose of the
reference's ``w``.  Its ``user_tower`` and ``item_tower`` compute the
reference's functions: ids clipped to ``[0, vocab - 1]`` (user fields
offset by field), ReLU on every layer but the last, each layer's product
and bias add rounded apart in the parameters' dtype, and the output
divided by its norm clipped at 1e-6, the norm taken in the parameters'
dtype (its squares summed in f32, as JAX sums a bf16 reduction).  The
reference's function names are thin functions over it.

Left for later: the training loss (``twotower_loss``), DeepFM, BERT4Rec,
MIND and the embedding-bag lookups.
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
    lin.weight = nn.Parameter(w_out_in, requires_grad=False)
    lin.bias = nn.Parameter(b, requires_grad=False)
    return lin


def _mlp_init(gen: torch.Generator, dims: Sequence[int], dtype, *, device) -> nn.ModuleList:
    """Layers ``dims[i] -> dims[i + 1]``: weights from ``dense_init`` (drawn
    ``(in, out)`` as the reference's, held transposed), zero biases."""
    return nn.ModuleList(
        _linear(L.dense_init(gen, dims[i], dims[i + 1], dtype, device=device).T.contiguous(),
                torch.zeros((dims[i + 1],), dtype=dtype, device=device))
        for i in range(len(dims) - 1))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor, *, final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, the product and the add each rounded to the
    parameters' dtype; ReLU between layers (and after the last with
    ``final_act``)."""
    for i, lin in enumerate(layers):
        x = torch.matmul(x, lin.weight.T) + lin.bias
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-6)`` along the last axis, the norm in ``x``'s
    dtype: squares rounded, summed in f32, the sum rounded, its root."""
    sq = torch.sum(x * x, dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)
    return x / torch.sqrt(sq).clamp_min(1e-6)


class TwoTower(nn.Module):
    """The two towers' parameters and their forward functions (no
    gradients: the port serves them)."""

    def __init__(self, cfg: TwoTowerConfig, user_embed: torch.Tensor, item_embed: torch.Tensor,
                 user_mlp: nn.ModuleList, item_mlp: nn.ModuleList):
        super().__init__()
        self.cfg = cfg
        self.user_embed = nn.Parameter(user_embed, requires_grad=False)
        self.item_embed = nn.Parameter(item_embed, requires_grad=False)
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp

    @property
    def device(self) -> torch.device:
        return self.item_embed.device

    @torch.no_grad()
    def user_tower(self, user_fields: torch.Tensor) -> torch.Tensor:
        """``user_fields (B, n_user_fields)`` ids → unit ``(B, D)``."""
        cfg = self.cfg
        f = torch.as_tensor(user_fields, device=self.device).to(torch.int64)
        offsets = torch.arange(cfg.n_user_fields, device=self.device) * cfg.user_vocab_per_field
        flat = f.clamp(0, cfg.user_vocab_per_field - 1) + offsets[None, :]
        v = self.user_embed[flat]                                   # (B, F, E)
        return _unit(_mlp_apply(self.user_mlp, v.reshape(v.shape[0], -1)))

    @torch.no_grad()
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


# the reference's function names, over ``TwoTower``
def user_tower(params: TwoTower, user_fields, cfg: TwoTowerConfig | None = None) -> torch.Tensor:
    return params.user_tower(user_fields)


def item_tower(params: TwoTower, item_ids, cfg: TwoTowerConfig | None = None) -> torch.Tensor:
    return params.item_tower(item_ids)


def twotower_score_pairs(params: TwoTower, batch: dict, cfg: TwoTowerConfig | None = None
                         ) -> torch.Tensor:
    """``sum(u * i)`` per pair, in the parameters' dtype (summed in f32)."""
    u = params.user_tower(batch["user_fields"])
    i = params.item_tower(batch["item_ids"])
    return torch.sum(u * i, dim=-1, dtype=torch.float32).to(u.dtype)


def twotower_retrieval(params: TwoTower, batch: dict, cfg: TwoTowerConfig | None = None
                       ) -> torch.Tensor:
    """One query batch against ``candidate_ids`` → ``(Q, C)`` f32 scores:
    the towers' outputs widened to f32 (a bf16 product is exact there) and
    one f32 product, the brute-force path the index replaces."""
    u = params.user_tower(batch["user_fields"])
    c = params.item_tower(batch["candidate_ids"])
    return torch.matmul(u.float(), c.float().T)
