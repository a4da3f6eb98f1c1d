"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones under the profiler.  The run
needs as many CUDA devices as the cell asks for, and exits non-zero with
no result where they are missing, where the JAX package or JAX is loaded,
or where the answers cannot be checked.  The numbers compared, each with
its limit, are the last lines on standard error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent
# the harness's modules are imported as ``cardbench.<name>``, never from
# this directory by their bare names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
# every build and kernel cache of the program lives at a fixed path inside
# the checkout (the kernels' own: build/kernels)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from cardbench import bench, guard, spec

    cell = spec.Benchmark(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bench.log(f"[card] {power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        out = bench.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START)
    except bench.GuardError as e:
        print(str(e), file=sys.stderr)
        return 3
    found = guard.loaded()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
