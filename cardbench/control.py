"""The control: the plain reference computed in TF32, the precision below
the float32 that the configurations state, put in the program's place and
judged by the same comparison as the program.  It has to come out as not
correct.  Not run by the benchmark's own runs.

    python3 cardbench/control.py --workload <name> --seeds 11,12,13 --seconds 5

runs the cell once a seed (set-up and a short window at the cell's own
load) and prints, a seed a line, the program's numbers and the control's
on the same sample.  ``--fault <name>`` plants one of ``faults.py``'s under
the timed path instead and prints its numbers.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def tf32_answers(k: int, device: str):
    from cardbench import reference

    def answers(live, queries, seqnos):
        return reference.exact_topk(live, queries, seqnos, k, device=device, tf32=True)
    return answers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    from cardbench import bench, spec

    cfg = spec.Benchmark(ROOT)
    k = cfg.config(cfg.cell(args.workload)["config"])["serve"]["search_k"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = bench.run(ROOT, args.workload, seed, args.seconds, False, t_start=t0,
                        fault=args.fault,
                        controls=None if args.fault else {"tf32": tf32_answers(k, "cuda")})
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": out["correct"],
                "program": {n: c["value"] for n, c in out["checks"].items()},
                "control": out.get("controls", {}).get("tf32"),
                "metrics": {n: m["value"] for n, m in out["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        print("CONTROL " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
