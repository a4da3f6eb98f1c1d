"""Fault-tolerant training loop (the reference's ``train/trainer.py``).

  * periodic atomic checkpoints (params + optimizer + step); a restart
    resumes from the latest complete one;
  * a step-time watchdog (straggler detection): steps slower than
    ``straggler_factor ×`` the median of the last 50 are counted;
  * the data pipeline is a deterministic cursor (step → batch), so a
    restart replays the exact batches.

Each step is synchronised on the device before its time is taken, as the
reference blocks on its loss.  The step itself asks the host for nothing;
the history reads the step's metrics every ``log_every`` steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.train.checkpoint import CheckpointStore
from repro_torch.train.optimizer import AdamWConfig, adamw_init, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0


class Trainer:
    """``init_params_fn()`` makes the parameters (on ``device``);
    ``batch_fn(step)`` gives a step's batch, whose arrays are moved to
    ``device``.  The card unless ``device="cpu"``.  The reference's
    ``jit_step`` has no counterpart: the step runs eagerly.  ``history``
    holds every metric of a logged step, besides its ``step`` and ``dt``."""

    def __init__(
        self,
        *,
        loss_fn: Callable[[Any, dict], tuple[Any, dict]],
        init_params_fn: Callable[[], Any],
        batch_fn: Callable[[int], dict],
        opt_cfg: AdamWConfig,
        trainer_cfg: TrainerConfig,
        ckpt_dir: str | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = trainer_cfg
        self.batch_fn = batch_fn
        self.step_fn = make_train_step(loss_fn, opt_cfg)
        self.store = (
            CheckpointStore(ckpt_dir, keep=trainer_cfg.keep_checkpoints)
            if ckpt_dir else None
        )
        self._init_params_fn = init_params_fn
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: list[dict] = []
        self.straggler_steps = 0

    # ------------------------------------------------------------------
    def _initialize(self) -> None:
        template_p = self._init_params_fn()
        template_o = adamw_init(template_p)
        if self.store is not None:
            restored = self.store.restore_latest((template_p, template_o))
            if restored is not None:
                (self.params, self.opt_state), self.step, _ = restored
                return
        self.params, self.opt_state = template_p, template_o
        self.step = 0

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, steps: int | None = None) -> dict:
        if self.params is None:
            self._initialize()
        target = self.step + steps if steps is not None else self.cfg.total_steps
        target = min(target, self.cfg.total_steps)
        durations: list[float] = []
        while self.step < target:
            batch = self._on_device(self.batch_fn(self.step))
            self._sync()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            self._sync()
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > self.cfg.straggler_factor * med:
                self.straggler_steps += 1
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == target:
                self.history.append(
                    {"step": self.step, "dt": dt,
                     **{k: float(v) for k, v in metrics.items()}}
                )
            if self.store is not None and (
                self.step % self.cfg.checkpoint_every == 0
                or self.step == self.cfg.total_steps
            ):
                self.store.save(
                    self.step, (self.params, self.opt_state),
                    extra={"straggler_steps": self.straggler_steps},
                )
        return {
            "final_step": self.step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "straggler_steps": self.straggler_steps,
            "history": self.history,
        }
