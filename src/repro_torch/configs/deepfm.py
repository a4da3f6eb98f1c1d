"""deepfm [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247; paper]."""
import torch

from repro_torch.configs.common import (OPT, RECSYS_SHAPES, Cell, _ids, _recsys_cell, _sds,
                                        _serve_step)
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import make_train_step

CONFIG = R.DeepFMConfig(
    name="deepfm", n_fields=39, vocab_per_field=1_000_000, embed_dim=10,
    mlp_dims=(400, 400, 400),
)

SMOKE = R.DeepFMConfig(
    name="deepfm-smoke", n_fields=6, vocab_per_field=64, embed_dim=4,
    mlp_dims=(16, 16),
)


def _batch_struct(cfg, sh):
    b = sh["batch"] * sh.get("n_candidates", 1)
    out = {"fields": _sds((b, cfg.n_fields), torch.int32)}
    if sh.get("kind") == "train":
        out["labels"] = _sds((b,), torch.int32)
    return out


def _make_batch(cfg, sh, rng, device):
    b = sh["batch"] * sh.get("n_candidates", 1)
    out = {"fields": _ids(rng.integers(0, cfg.vocab_per_field, size=(b, cfg.n_fields)), device)}
    if sh.get("kind") == "train":
        out["labels"] = _ids(rng.integers(0, 2, size=b), device)
    return out


def cells() -> list[Cell]:
    out = []
    for shape_name, sh in RECSYS_SHAPES.items():
        kind = "train" if sh["kind"] == "train" else "serve"
        if kind == "train":
            def make_step(cfg):
                return make_train_step(lambda p, b, _cfg=cfg: R.deepfm_loss(p, b, _cfg), OPT)
            donate = (0, 1)
        else:
            # retrieval_cand for a ranking model = bulk-score 1M candidates
            make_step, donate = _serve_step(R.deepfm_forward), ()
        out.append(_recsys_cell(
            "deepfm", shape_name, CONFIG, SMOKE, kind, make_step,
            R.deepfm_init,
            lambda cfg, s, _k=kind: _batch_struct(cfg, {**s, "kind": _k}),
            lambda cfg, s, rng, dev, _k=kind: _make_batch(cfg, {**s, "kind": _k}, rng, dev),
            donate=donate,
        ))
    return out
