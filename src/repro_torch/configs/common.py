"""Cell registry, the LM and recsys parts: every ported (architecture ×
input shape) combination becomes a ``Cell`` with a step function and
smoke-scale inputs — consumed by the smoke tests and the training
launcher.

A ``Cell`` keeps the reference's field names for what the port fills.
The reference's ``input_specs``, ``in_shardings``, ``out_shardings``,
``make_for_cfg`` and ``make_mesh_step`` wait for the dry run and the
sharding rules (``ROADMAP.md`` queue 1 item 10); ``gnn_cells`` waits for
its model (item 9).

``make_smoke_inputs(scfg, rng, device=...)`` makes the parameters from a
generator seeded 0 on ``device`` (the card unless the caller asks for the
CPU) and draws the batch from ``rng`` as the reference's batch maker
draws it: a seed gives both packages the same batch.  A train cell's
inputs are ``(params, opt_state, batch)``; its step updates the first two
in place and returns them with the metrics.  An LM prefill cell's inputs
are ``(params, tokens)``; a decode cell's ``(params, cache, tokens, pos)``,
its step writing the cache in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import AdamWConfig, adamw_init, make_train_step


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    family: str
    kind: str                        # train | prefill | decode | serve
    model_cfg: Any
    step_fn: Callable                # fn(*inputs)
    make_smoke_inputs: Callable[..., tuple] | None = None
    smoke_cfg: Any = None
    skip_reason: str | None = None
    donate_argnums: tuple = ()
    smoke_step_fn: Callable | None = None   # step built against smoke_cfg

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


OPT = AdamWConfig()


def _sds(shape, dtype) -> torch.Tensor:
    """An input's shape and dtype, allocating nothing (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _ids(arr: np.ndarray, device) -> torch.Tensor:
    """A drawn id array as an int32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr, np.int32)).to(device)


# ===========================================================================
# LM family
# ===========================================================================

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

LM_SMOKE_SHAPES = {
    "train_4k": dict(kind="train", seq=32, batch=2),
    "prefill_32k": dict(kind="prefill", seq=64, batch=2),
    "decode_32k": dict(kind="decode", seq=64, batch=4),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}

LONG_500K_SKIP = ("pure full-attention arch: long_500k requires sub-quadratic "
                  "attention (assignment rule; see DESIGN.md §5)")


def lm_step(kind: str, cfg: tf.LMConfig):
    """The step of an LM cell of ``kind`` built for ``cfg`` (the reference
    builds the same for a variant config through ``make_for_cfg``)."""
    if kind == "train":
        return make_train_step(lambda p, b, _cfg=cfg: tf.loss_fn(p, b, _cfg), OPT)
    if kind == "prefill":
        return lambda params, tokens, _cfg=cfg: tf.prefill(params, tokens, _cfg)
    return lambda params, cache, tokens, pos, _cfg=cfg: tf.decode_step(params, cache, tokens,
                                                                       pos, _cfg)


def _lm_smoke_inputs(kind: str, ssh: dict):
    """The reference's smoke inputs of an LM cell: params from a generator
    seeded 0; tokens drawn from ``rng`` in ``[0, vocab)``; a decode cell's
    cache zeros at ``pos = seq // 2``."""
    def smoke_inputs(scfg, rng, *, device="cuda"):
        dev = resolve_device(device)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), scfg, device=dev)
        if kind == "decode":
            cache = tf.init_cache(scfg, ssh["batch"], ssh["seq"], device=dev)
            toks = _ids(rng.integers(0, scfg.vocab, size=(ssh["batch"],)), dev)
            return (params, cache, toks, torch.tensor(ssh["seq"] // 2, dtype=torch.int32,
                                                      device=dev))
        toks = _ids(rng.integers(0, scfg.vocab, size=(ssh["batch"], ssh["seq"])), dev)
        if kind == "train":
            return (params, adamw_init(params), {"tokens": toks, "labels": toks})
        return (params, toks)
    return smoke_inputs


def lm_cells(arch: str, cfg: tf.LMConfig, smoke: tf.LMConfig) -> list[Cell]:
    cells = []
    for shape_name, sh in LM_SHAPES.items():
        kind = sh["kind"]
        cells.append(Cell(
            arch=arch, shape=shape_name, family="lm", kind=kind, model_cfg=cfg,
            smoke_cfg=smoke, step_fn=lm_step(kind, cfg),
            make_smoke_inputs=_lm_smoke_inputs(kind, LM_SMOKE_SHAPES[shape_name]),
            skip_reason=LONG_500K_SKIP if shape_name == "long_500k" else None,
            donate_argnums={"train": (0, 1), "prefill": (), "decode": (1,)}[kind],
            smoke_step_fn=lm_step(kind, smoke),
        ))
    return cells


# ===========================================================================
# Recsys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_000),
}

RECSYS_SMOKE_SHAPES = {
    "train_batch": dict(kind="train", batch=32),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=64),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=256),
}


def _recsys_cell(
    arch: str,
    shape_name: str,
    cfg,
    smoke_cfg,
    kind: str,
    make_step,          # cfg -> step_fn
    init_fn,            # (gen, cfg, device=) -> params
    make_batch_fn,      # (cfg, shape, rng, device) -> batch
    donate=(),
) -> Cell:
    def smoke_inputs(scfg, rng, *, device="cuda"):
        dev = resolve_device(device)
        params = init_fn(torch.Generator(device=dev).manual_seed(0), scfg, device=dev)
        b = make_batch_fn(scfg, RECSYS_SMOKE_SHAPES[shape_name], rng, dev)
        if kind == "train":
            return (params, adamw_init(params), b)
        return (params, b)

    return Cell(
        arch=arch, shape=shape_name, family="recsys", kind=kind,
        model_cfg=cfg, smoke_cfg=smoke_cfg, step_fn=make_step(cfg),
        make_smoke_inputs=smoke_inputs, donate_argnums=donate,
        smoke_step_fn=make_step(smoke_cfg),
    )


def _serve_step(fn):
    """A serving step: ``fn(params, batch, cfg)`` with no graph."""
    def make_step(cfg):
        @torch.no_grad()
        def step(params, batch, _cfg=cfg):
            return fn(params, batch, _cfg)
        return step
    return make_step
