"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030]."""
import torch

from repro_torch.configs.common import (OPT, RECSYS_SHAPES, Cell, _ids, _recsys_cell, _sds,
                                        _serve_step)
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import make_train_step

CONFIG = R.MINDConfig(
    name="mind", n_items=1_000_000, embed_dim=64, n_interests=4,
    capsule_iters=3, seq_len=50,
)

SMOKE = R.MINDConfig(
    name="mind-smoke", n_items=128, embed_dim=16, n_interests=4,
    capsule_iters=3, seq_len=10,
)


def _batch_struct(cfg, sh, kind, shape_name):
    b = sh["batch"]
    out = {"items": _sds((b, cfg.seq_len), torch.int32)}
    if kind == "train":
        out["target"] = _sds((b,), torch.int32)
    elif shape_name == "serve_bulk":
        out["pair_items"] = _sds((b,), torch.int32)
    elif shape_name == "retrieval_cand":
        out["candidate_ids"] = _sds((sh["n_candidates"],), torch.int32)
    return out


def _make_batch(cfg, sh, rng, kind, shape_name, device):
    b = sh["batch"]
    out = {"items": _ids(rng.integers(0, cfg.n_items, size=(b, cfg.seq_len)), device)}
    if kind == "train":
        out["target"] = _ids(rng.integers(0, cfg.n_items, size=b), device)
    elif shape_name == "serve_bulk":
        out["pair_items"] = _ids(rng.integers(0, cfg.n_items, size=b), device)
    elif shape_name == "retrieval_cand":
        out["candidate_ids"] = _ids(rng.integers(0, cfg.n_items, size=sh["n_candidates"]),
                                    device)
    return out


def _pair_score(params, batch, cfg):
    """Bulk scoring: max over interests of capsule·item."""
    caps = R.mind_interests(params, batch["items"], cfg)  # (B, K, d)
    cand = params["item_embed"][batch["pair_items"].long().clamp(0, cfg.n_items - 1)]
    return torch.amax(torch.einsum("bkd,bd->bk", caps, cand), dim=-1)


def _cand_score(params, batch, cfg):
    """Retrieval: every interest queries the candidates; max-combine."""
    caps = R.mind_interests(params, batch["items"], cfg)  # (1, K, d)
    cand = params["item_embed"][batch["candidate_ids"].long().clamp(0, cfg.n_items - 1)]
    return torch.amax(torch.einsum("bkd,cd->bkc", caps, cand), dim=1)  # (1, C)


def cells() -> list[Cell]:
    out = []
    for shape_name, sh in RECSYS_SHAPES.items():
        kind = sh["kind"]
        if kind == "train":
            def make_step(cfg):
                return make_train_step(lambda p, b, _cfg=cfg: R.mind_loss(p, b, _cfg), OPT)
            donate = (0, 1)
        else:
            make_step = _serve_step({"serve_p99": R.mind_serve, "serve_bulk": _pair_score,
                                     "retrieval_cand": _cand_score}[shape_name])
            donate = ()
        out.append(_recsys_cell(
            "mind", shape_name, CONFIG, SMOKE, kind, make_step,
            R.mind_init,
            lambda cfg, s, _k=kind, _n=shape_name: _batch_struct(cfg, s, _k, _n),
            lambda cfg, s, rng, dev, _k=kind, _n=shape_name: _make_batch(cfg, s, rng, _k, _n, dev),
            donate=donate,
        ))
    return out
