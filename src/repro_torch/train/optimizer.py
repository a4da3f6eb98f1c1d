"""AdamW, gradient clipping and the learning-rate schedule, written out as
the reference's ``train/optimizer.py`` writes them (no ``torch.optim``:
its AdamW decays the weights in another order, so it rounds otherwise).

``params`` is a model (an ``nn.Module``) or a tree of tensors; its leaves
are taken in the reference's order (``convert.param_leaves``).  The
optimiser state is ``{"count": () int32, "m": [...], "v": [...]}``, the
moments f32 lists in that order, each in its parameter's layout.

``count``, ``lr`` and the clip scale stay tensors on the parameters'
device, so a step asks the host for nothing.  The update runs in place
under ``torch.no_grad()`` (the counterpart of the reference's
``donate_argnums=(0, 1)``): a step returns the objects it was given.  A
leaf larger than ``_CHUNK`` values is updated a chunk at a time, so the
update's temporaries stay small beside an embedding table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.convert import param_leaves

# values of a leaf one pass of the update (or of the norm) holds at once
_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, in f32, rounded
    as the reference's compiled step rounds it: XLA turns each division by
    a config constant into a product by its f32 reciprocal and folds
    ``min + (1 - min) * 0.5 * (1 + cos)`` into ``(cos + 1) * (0.5 * (1 -
    min)) + min``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step * (1.0 / max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       * (1.0 / max(cfg.decay_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = torch.cos(prog * math.pi)
    ratio = (cos + 1.0) * (0.5 * (1 - cfg.min_lr_ratio)) + cfg.min_lr_ratio
    return warm * cfg.lr * ratio


def adamw_init(params: Any) -> dict:
    leaves = [t for _, t, _ in param_leaves(params)]
    return {
        "m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves],
        "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves],
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[s:s + _CHUNK] for s in range(0, flat.numel(), _CHUNK)]


def global_norm(leaves) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's squares in f32, the leaves
    added in order."""
    total = 0
    for x in leaves:
        sq = 0
        for c in _chunks(x.contiguous()):
            sq = sq + torch.sum(torch.square(c.float()))
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params: Any, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step in place; returns ``(params, opt_state, metrics)``.
    ``grads`` is a list in the parameters' leaf order."""
    leaves = [t for _, t, _ in param_leaves(params)]
    grads = list(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    opt_state["count"].add_(1)
    count = opt_state["count"].float()
    lr = schedule(cfg, opt_state["count"])
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=count.device) for b in (cfg.b1, cfg.b2))
    bc1 = 1 - torch.pow(b1, count)
    bc2 = 1 - torch.pow(b2, count)
    for p, g, m, v in zip(leaves, grads, opt_state["m"], opt_state["v"]):
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()), _chunks(m), _chunks(v)):
            gs = gc.float() * scale
            mc.mul_(cfg.b1).add_((1 - cfg.b1) * gs)
            vc.mul_(cfg.b2).add_((1 - cfg.b2) * gs * gs)
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps) + cfg.weight_decay * pc.float()
            pc.copy_((pc.float() - lr * delta).to(p.dtype))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """``((loss, metrics), grads)``: ``loss_fn(params, batch)`` and its
    gradient for every leaf in the reference's order (zeros for a leaf the
    loss does not reach, as ``jax.grad`` gives).  A leaf that does not
    require grad is switched to require it."""
    leaves = [t for _, t, _ in param_leaves(params)]
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(loss_fn: Callable[[Any, dict], tuple[torch.Tensor, dict]],
                    opt_cfg: AdamWConfig):
    """A fused train step: gradients by autograd, clip, AdamW in place.

    ``loss_fn(params, batch) -> (loss, metrics)``; the step returns
    ``(params, opt_state, metrics)`` with ``loss``, ``grad_norm``, ``lr``
    and the loss's own metrics, all tensors on the device."""

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
