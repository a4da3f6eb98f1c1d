"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq [arXiv:1904.06690; paper]."""
import numpy as np
import torch

from repro_torch.configs.common import (OPT, RECSYS_SHAPES, Cell, _ids, _recsys_cell, _sds,
                                        _serve_step)
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import make_train_step

CONFIG = R.Bert4RecConfig(
    # 2^20 - 1 so the (n_items + 1 [MASK]) table rows shard 16-way
    name="bert4rec", n_items=1_048_575, embed_dim=64, n_blocks=2, n_heads=2,
    d_ff=256, seq_len=200,
)

SMOKE = R.Bert4RecConfig(
    name="bert4rec-smoke", n_items=128, embed_dim=16, n_blocks=2, n_heads=2,
    d_ff=32, seq_len=12,
)


N_MASK = 4  # masked positions scored per sequence (BERT4Rec masks ~2%)


def _batch_struct(cfg, sh, kind, shape_name):
    b = sh["batch"]
    out = {"items": _sds((b, cfg.seq_len), torch.int32)}
    if kind == "train":
        out["mask_pos"] = _sds((b, N_MASK), torch.int32)
        out["mask_label"] = _sds((b, N_MASK), torch.int32)
    elif shape_name == "serve_bulk":
        out["pair_items"] = _sds((b,), torch.int32)
    elif shape_name == "retrieval_cand":
        out["candidate_ids"] = _sds((sh["n_candidates"],), torch.int32)
    return out


def _make_batch(cfg, sh, rng, kind, shape_name, device):
    """The reference's draws in its order: the items, then (train) one
    ``rng.choice`` of masked positions per row."""
    b = sh["batch"]
    items = rng.integers(0, cfg.n_items, size=(b, cfg.seq_len)).astype(np.int32)
    out = {"items": _ids(items, device)}
    if kind == "train":
        n_mask = min(N_MASK, cfg.seq_len)
        pos = np.stack([
            rng.choice(cfg.seq_len, size=n_mask, replace=False)
            for _ in range(b)
        ]).astype(np.int32)
        labels = items[np.arange(b)[:, None], pos].copy()
        items2 = items.copy()
        items2[np.arange(b)[:, None], pos] = cfg.mask_id
        if n_mask < N_MASK:
            pad = N_MASK - n_mask
            pos = np.pad(pos, ((0, 0), (0, pad)))
            labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
        out = {"items": _ids(items2, device), "mask_pos": _ids(pos, device),
               "mask_label": _ids(labels, device)}
    elif shape_name == "serve_bulk":
        out["pair_items"] = _ids(rng.integers(0, cfg.n_items, size=b), device)
    elif shape_name == "retrieval_cand":
        out["candidate_ids"] = _ids(rng.integers(0, cfg.n_items, size=sh["n_candidates"]),
                                    device)
    return out


def _pair_score(params, batch, cfg):
    hidden = R.bert4rec_encode(params, batch["items"], cfg)[:, -1]
    ids = batch["pair_items"].long().clamp(0, cfg.n_items - 1)
    return torch.sum(hidden * params["item_embed"][ids], dim=-1)


def _cand_score(params, batch, cfg):
    hidden = R.bert4rec_encode(params, batch["items"], cfg)[:, -1]  # (1, d)
    cand = params["item_embed"][batch["candidate_ids"].long().clamp(0, cfg.n_items - 1)]
    return hidden @ cand.T  # (1, C)


def cells() -> list[Cell]:
    out = []
    for shape_name, sh in RECSYS_SHAPES.items():
        kind = sh["kind"]
        if kind == "train":
            def make_step(cfg):
                return make_train_step(lambda p, b, _cfg=cfg: R.bert4rec_loss(p, b, _cfg), OPT)
            donate = (0, 1)
        else:
            make_step = _serve_step({"serve_p99": R.bert4rec_score, "serve_bulk": _pair_score,
                                     "retrieval_cand": _cand_score}[shape_name])
            donate = ()
        out.append(_recsys_cell(
            "bert4rec", shape_name, CONFIG, SMOKE, kind, make_step,
            R.bert4rec_init,
            lambda cfg, s, _k=kind, _n=shape_name: _batch_struct(cfg, s, _k, _n),
            lambda cfg, s, rng, dev, _k=kind, _n=shape_name: _make_batch(cfg, s, rng, _k, _n, dev),
            donate=donate,
        ))
    return out
