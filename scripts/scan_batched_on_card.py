#!/usr/bin/env python3
"""Time kernel #3 ``scan_batched`` and its wrapper ``ops.scan_unique_blocks``
on the card, for the port in one source tree.

    python3 scripts/scan_batched_on_card.py [--src SRC] [--seed 0] [--reps 5]

``SRC`` is the ``src`` directory of a checkout of the port (default: this
checkout's), so one call can time two commits on one card in turns: unpack
the other commit with ``git archive <commit> | tar -x -C build/parent``
(``build/`` is listed in ``.gitignore``) and run this script with
``--src build/parent/src`` and without, parent, change, change, parent.
Each tree builds its kernels into its own ``build/kernels``.

At the spfresh-1b shapes (Q = 1024, BS = 32, d = 100, a 262,144-block
pool), for each payload (int8, bf16, f32):

* ``kernel_ms``: ``kernel.scan_batched`` over the full 32,768-page budget
  (distinct random pages);
* ``wrapper_mix_ms``: ``ops.scan_unique_blocks`` on the batched main
  path's page mix (10,393 real pages, the rest of the budget -1 padding).

Each time is the mean of back-to-back calls between two CUDA events,
after two warm-up calls.  Prints the card's name and power limit, then
one JSON line.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BUDGET = 32_768
MIX_PAGES = 10_393
Q_N, BS, D, N_BLOCKS = 1024, 32, 100, 262_144


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scan_batched_on_card: no CUDA device available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    from repro_torch.kernels.posting_scan import kernel as K
    from repro_torch.kernels.posting_scan import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    dev = "cuda"
    q = torch.randn(Q_N, D, device=dev, generator=gen) * 32
    ids = torch.sort(torch.randperm(N_BLOCKS, device=dev, generator=gen)[:BUDGET]).values
    ids = ids.to(torch.int32).contiguous()
    mix = torch.full((BUDGET,), -1, dtype=torch.int32, device=dev)
    mix[:MIX_PAGES] = torch.sort(
        torch.randperm(N_BLOCKS, device=dev, generator=gen)[:MIX_PAGES]).values.to(torch.int32)
    out = {"src": str(src), "card": card, "reps": args.reps}
    for name, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16), ("f32", torch.float32)):
        if dtype == torch.int8:
            blocks = torch.randint(-127, 128, (N_BLOCKS, BS, D), device=dev, generator=gen,
                                   dtype=torch.int8)
        else:
            blocks = (torch.randn(N_BLOCKS, BS, D, device=dev, generator=gen) * 4).to(dtype)
        out[name] = {
            "kernel_ms": cuda_ms(torch, lambda: K.scan_batched(ids, q, blocks), args.reps),
            "wrapper_mix_ms": cuda_ms(torch, lambda: ops.scan_unique_blocks(q, mix, blocks),
                                      args.reps),
        }
        del blocks
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
