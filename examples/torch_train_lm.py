"""LM training on the PyTorch/CUDA port: train a GQA transformer LM
with the fault-tolerant Trainer (checkpoint/restart, straggler
accounting) on synthetic tokens — the reference example's flow, configs
and batch stream (``examples/train_lm.py``).

The default config is small (~1.5M params, 200 steps); ``--large`` switches
to a ~110M-param config.  Runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--large] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_batch_fn(cfg, batch, seq):
    """Deterministic synthetic pipeline: step -> batch (replay-exact on
    restart).  A Zipfian unigram stream with local repetition so the loss
    has structure to learn."""

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng(1234 + step)
        probs = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
        probs /= probs.sum()
        toks = rng.choice(cfg.vocab, size=(batch, seq), p=probs)
        # repetition structure: second half mirrors the first
        toks[:, seq // 2:] = toks[:, : seq - seq // 2]
        t = toks.astype(np.int32)
        labels = np.concatenate([t[:, 1:], -np.ones((batch, 1), np.int32)], 1)
        return {"tokens": t, "labels": labels}

    return batch_fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.large:
        cfg = tf.LMConfig(name="lm-110m", vocab=32000, n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                          dtype="float32", kv_chunk=256)
        batch, seq = 8, 512
    else:
        cfg = tf.LMConfig(name="lm-8m", vocab=2048, n_layers=4, d_model=128,
                          n_heads=4, n_kv_heads=2, d_ff=512,
                          dtype="float32", kv_chunk=64)
        batch, seq = 8, 128

    ckpt_dir = args.ckpt or os.path.join(tempfile.mkdtemp(), "ckpt")

    def trainer():
        return Trainer(
            loss_fn=lambda p, b: tf.loss_fn(p, b, cfg),
            init_params_fn=lambda: tf.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
            batch_fn=make_batch_fn(cfg, batch, seq),
            opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=args.steps),
            trainer_cfg=TrainerConfig(total_steps=args.steps, checkpoint_every=50, log_every=10),
            ckpt_dir=ckpt_dir, device=dev,
        )

    print(f"model: {cfg.name}  params={cfg.n_params / 1e6:.1f}M  ckpt={ckpt_dir}  on {dev}")
    # first half
    first = trainer()
    first.run(steps=args.steps // 2)
    print(f"[mid] step={first.step} loss={first.history[-1]['loss']:.3f}")

    # simulate a failure + restart: a fresh Trainer resumes from checkpoint
    result = trainer().run()
    print(f"[restart] resumed at step "
          f"{result['history'][0]['step'] if result['history'] else '?'} → "
          f"finished step={result['final_step']} "
          f"loss={result['final_loss']:.3f} "
          f"stragglers={result['straggler_steps']}")
    for h in result["history"]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.3f}  {h['dt'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
