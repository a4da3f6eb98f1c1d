"""Training substrate: in-house AdamW, schedules, trainer with
checkpoint/restart."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    make_train_step,
)
