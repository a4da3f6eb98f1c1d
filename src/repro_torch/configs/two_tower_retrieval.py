"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 (YouTube)].

The flagship of the reference: ``retrieval_cand`` is the ANN query the
SPFresh index serves (``repro_torch.serve.retrieval``).  ``SERVE_CONFIG``
is the bf16 checkpoint the serving cells read; ``ann_index_cfg`` the
index over the item tower's embeddings.  ``cells()`` gives
``retrieval_cand_ann`` first, then ``train_batch``, ``serve_p99``,
``serve_bulk`` and ``retrieval_cand``.  ``retrieval_cand_ann`` serves
``retrieval_cand`` from the index instead of the brute-force GEMM over
the candidates: the user tower on ``SERVE_CONFIG``, then a sharded search
at ``ann_index_cfg()`` with nprobe 16 over a document-sharded corpus, one
shard a device.  Its step is ``(params, user_fields, states, shard_alive)
-> (dists (B, 10), handles (B, 10))``.
"""
import dataclasses

import torch

from repro_torch.configs.common import (OPT, RECSYS_SHAPES, Cell, _ids, _recsys_cell, _sds,
                                        _serve_step)
from repro_torch.core.types import LireConfig
from repro_torch.models import recsys as R
from repro_torch.models.recsys import TwoTowerConfig
from repro_torch.train.optimizer import make_train_step

CONFIG = TwoTowerConfig(
    name="two-tower-retrieval",
    n_items=10_000_000,
    n_user_fields=8,
    user_vocab_per_field=100_000,
    embed_dim=256,
    tower_dims=(1024, 512, 256),
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", n_items=512, n_user_fields=4,
    user_vocab_per_field=64, embed_dim=16, tower_dims=(32, 16),
)

# the serving cells read a bf16-cast checkpoint
SERVE_CONFIG = dataclasses.replace(CONFIG, dtype="bfloat16")


def ann_index_cfg() -> LireConfig:
    """The item corpus's index: dim 256, bf16 payload, BS 32 × MB 4,
    sized per shard of a 256-way document-sharded 10M-item corpus
    (~40k items and replica headroom)."""
    return LireConfig(
        dim=256, block_size=32, max_blocks_per_posting=4,   # cap 128
        num_blocks=4096, num_postings_cap=2048,
        num_vectors_cap=131072, vector_dtype="bfloat16",
        split_limit=96, merge_limit=12, reassign_range=16,
        reassign_budget=128, replica_count=2, nprobe=16,
    )


def _batch_struct(cfg, sh, kind, shape_name):
    b = sh["batch"]
    out = {"user_fields": _sds((b, cfg.n_user_fields), torch.int32)}
    if shape_name == "retrieval_cand":
        out["candidate_ids"] = _sds((sh["n_candidates"],), torch.int32)
        return out
    out["item_ids"] = _sds((b,), torch.int32)
    if kind == "train":
        out["item_logq"] = _sds((b,), torch.float32)
    return out


def _make_batch(cfg, sh, rng, kind, shape_name, device):
    b = sh["batch"]
    out = {"user_fields": _ids(rng.integers(0, cfg.user_vocab_per_field,
                                            size=(b, cfg.n_user_fields)), device)}
    if shape_name == "retrieval_cand":
        out["candidate_ids"] = _ids(rng.integers(0, cfg.n_items, size=sh["n_candidates"]),
                                    device)
        return out
    out["item_ids"] = _ids(rng.integers(0, cfg.n_items, size=b), device)
    if kind == "train":
        out["item_logq"] = torch.zeros((b,), dtype=torch.float32, device=device)
    return out


ANN_NPROBE = 16


@torch.no_grad()
def ann_step(params, user_fields, states, shard_alive):
    """``retrieval_cand_ann``: the user tower, then the sharded search."""
    from repro_torch.distributed.sharded_index import sharded_search

    u = R.user_tower(params, user_fields)
    return sharded_search(states, u.float(), shard_alive, k=10, nprobe=ANN_NPROBE)


def _ann_make_mesh_step(mesh, multi_pod: bool):
    """One device's program: the bf16 serving params under the recsys
    rules (the tables row-sharded over ``model``), one user replicated,
    its shard's state at ``ann_index_cfg()``."""
    from repro_torch.core.types import make_empty_state
    from repro_torch.distributed.sharding import recsys_param_specs

    params = R.twotower_init(None, SERVE_CONFIG, device="meta")
    args = (params, _sds((1, CONFIG.n_user_fields), torch.int32),
            [make_empty_state(ann_index_cfg(), device="meta")], _sds((1,), torch.bool))
    specs = (recsys_param_specs(params, multi_pod=multi_pod), None, None, None)
    return ann_step, args, specs


def cells() -> list[Cell]:
    out = [Cell(arch="two-tower-retrieval", shape="retrieval_cand_ann", family="recsys",
                kind="serve", model_cfg=CONFIG, smoke_cfg=SMOKE, step_fn=ann_step,
                make_mesh_step=_ann_make_mesh_step)]
    for shape_name, sh in RECSYS_SHAPES.items():
        kind = sh["kind"]
        if kind == "train":
            def make_step(cfg):
                return make_train_step(lambda p, b, _cfg=cfg: R.twotower_loss(p, b, _cfg), OPT)
            donate = (0, 1)
        elif shape_name == "retrieval_cand":
            make_step, donate = _serve_step(R.twotower_retrieval), ()
        else:
            make_step, donate = _serve_step(R.twotower_score_pairs), ()
        # the serving cells read a bf16-cast checkpoint
        cell_cfg = SERVE_CONFIG if shape_name == "retrieval_cand" else CONFIG
        out.append(_recsys_cell(
            "two-tower-retrieval", shape_name, cell_cfg, SMOKE, kind, make_step,
            R.twotower_init,
            lambda cfg, s, _k=kind, _n=shape_name: _batch_struct(cfg, s, _k, _n),
            lambda cfg, s, rng, dev, _k=kind, _n=shape_name: _make_batch(cfg, s, rng, _k, _n, dev),
            donate=donate,
        ))
    return out
