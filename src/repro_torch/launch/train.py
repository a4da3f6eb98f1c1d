"""Training launcher: ``--arch`` selects a ported architecture's training
cell and trains its smoke-scale config, each step's batch drawn from
``np.random.default_rng(step)``, checkpointing every 25 steps and at the
last, resuming from the newest checkpoint under ``--ckpt``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch mind --steps 3 \\
        --device cpu --ckpt DIR
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --steps 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora \\
        --shape minibatch_lg --device cpu

It runs on the card; ``--device cpu`` runs on the CPU.  An unknown arch,
or one without a train cell (spfresh-1b), exits saying so.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

CHECKPOINT_EVERY = 25


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="training shape cell (default: the arch's train cell)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_cells
    from repro_torch.core.types import resolve_device
    from repro_torch.train.checkpoint import CheckpointStore

    try:
        cells = [c for c in get_cells(args.arch) if c.kind == "train"]
    except KeyError as e:
        raise SystemExit(f"no cells for {args.arch}: {e.args[0]}") from None
    if args.shape:
        cells = [c for c in cells if c.shape == args.shape]
    if not cells:
        raise SystemExit(f"no train cell for {args.arch}/{args.shape}")
    cell = cells[0]
    device = resolve_device(args.device)
    print(f"training {cell.name} (smoke-scale config on {device})")

    step_fn = cell.smoke_step_fn
    params, opt, _ = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(0),
                                            device=device)
    store = CheckpointStore(args.ckpt) if args.ckpt else None
    start = 0
    if store is not None:
        restored = store.restore_latest((params, opt))
        if restored is not None:
            (params, opt), start, _ = restored
            print(f"resumed from step {start}")

    for step in range(start, args.steps):
        batch = cell.make_smoke_inputs(cell.smoke_cfg, np.random.default_rng(step),
                                       device=device)[-1]
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"{1e3 * (time.perf_counter() - t0):.0f} ms")
        if store is not None and ((step + 1) % CHECKPOINT_EVERY == 0 or step + 1 == args.steps):
            store.save(step + 1, (params, opt))
    print("done")


if __name__ == "__main__":
    main()
