#!/usr/bin/env python3
"""Measure the card's `mma.sync` tensor-core rate, the instruction the
batched scans (#3, #6, #7) and the centroid navigation (#1) are built on.

    python3 scripts/mma_sync_rate_on_card.py

Builds a small CUDA source with nvcc (sm_90a) into ``build/kernels/``,
then, at 8 and 16 warps an SM, times a loop in which every warp issues
8 independent ``mma.sync`` into 8 accumulators per step, for
``m16n8k8`` TF32 (2,048 FLOP an instruction, what the kernels issue) and
``m16n8k16`` bf16 (4,096).  Prints the card's name and power limit, then
one JSON line with each rate in TFLOP/s beside the data sheet's dense
peak (495 TF32, 989 bf16).  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int KIND>
__global__ void __launch_bounds__(256) loop(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, b0 = a0 ^ 9u, b1 = a0 ^ 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int kind, int blocks, int iters, float* out, void* stream) {
  if (kind == 0) loop<0><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  else loop<1><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_sync_rate_on_card: no CUDA device available", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(SRC)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20_000
    res = {"card": card, "sms": sms, "iters": iters}
    for kind, name, flop in ((0, "tf32_m16n8k8", 2048), (1, "bf16_m16n8k16", 4096)):
        for per_sm in (1, 2):                       # blocks of 8 warps an SM
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(2):
                assert so.run(kind, blocks, iters, out.data_ptr(), stream) == 0
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            assert so.run(kind, blocks, iters, out.data_ptr(), stream) == 0
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            n_mma = blocks * 8 * iters * 8
            res[f"{name}_{8 * per_sm}_warps_per_sm"] = {
                "ms": ms, "tflop_per_s": n_mma * flop / ms / 1e9,
                "cycles_per_mma_per_smsp_at_1755mhz": ms * 1e-3 * 1.755e9 / (n_mma / (sms * 4)),
            }
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
