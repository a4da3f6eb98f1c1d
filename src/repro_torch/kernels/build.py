"""Build and load the CUDA kernels of ``kernels/csrc`` (Hopper, ``sm_90a``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``; ``csrc/*.cuh`` are
headers the sources share.  Libraries go into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of their
source and the shared headers, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built at import time: :func:`library`
builds on first use, and :func:`build_all` builds every source at once,
one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}

_C = ctypes.c_int
_P = ctypes.c_void_p
_S = ctypes.POINTER(ctypes.c_int)    # the four ints of a shape query
# argtypes of every C entry point, by library.  Each launch entry has an
# ``<entry>_smem_bytes`` query: its shape arguments (the dtype code where
# it takes one), then the shape out-array; it returns the bytes of
# dynamic shared memory the launcher asks for (a CUDA error negated).
SIGNATURES = {
    "l2_topk": {
        # q, c, csq, out_d, out_i, Q, P, d, k, block_p, stream
        "l2_topk_tiles_f32": [_P, _P, _P, _P, _P, _C, _C, _C, _C, _C, _P],
        # d, k, shape
        "l2_topk_tiles_f32_smem_bytes": [_C, _C, _S],
    },
    "posting_scan": {
        # table, q, blocks, dtype, bias, out_d, out_i, Q, NB, BS, d, k, stream
        "scan_per_query_topk": [_P, _P, _P, _C, _P, _P, _P, _C, _C, _C, _C, _C, _P],
        # table, q, blocks, dtype, out_d, Q, NB, BS, d, stream
        "scan_per_query": [_P, _P, _P, _C, _P, _C, _C, _C, _C, _P],
        # table, q, codes, bias, sz, out_d, out_i, Q, NB, BS, d, k, stream
        "scan_per_query_topk_q8": [_P, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _C, _P],
        # dtype, BS, d, k, shape / dtype, BS, d, shape / BS, d, k, shape
        "scan_per_query_topk_smem_bytes": [_C, _C, _C, _C, _S],
        "scan_per_query_smem_bytes": [_C, _C, _C, _S],
        "scan_per_query_topk_q8_smem_bytes": [_C, _C, _C, _S],
    },
    "scan_batched_topk": {
        # ids, q, blocks, dtype, out_d, NB, Q, BS, d, stream
        "scan_batched": [_P, _P, _P, _C, _P, _C, _C, _C, _C, _P],
        # ids, q, blocks, dtype, bias, out_d, out_i, NB, Q, BS, d, k, pos, nbq, stream
        "scan_batched_topk": [_P, _P, _P, _C, _P, _P, _P, _C, _C, _C, _C, _C, _P, _C, _P],
        # ids, q, codes, bias, sz, out_d, out_i, NB, Q, BS, d, k, pos, nbq, stream
        "scan_batched_topk_q8": [_P, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _C, _P, _C, _P],
        # dtype, BS, d, shape / dtype, BS, d, k, shape / BS, d, k, shape
        "scan_batched_smem_bytes": [_C, _C, _C, _S],
        "scan_batched_topk_smem_bytes": [_C, _C, _C, _C, _S],
        "scan_batched_topk_q8_smem_bytes": [_C, _C, _C, _S],
    },
}


def smem_query(entry: str, *args: int) -> tuple[int, tuple[int, int, int, int]]:
    """``(bytes, (variant, warps, stages, blocks an SM))`` that launch
    entry ``entry`` asks for at the shape ``args`` (its
    ``<entry>_smem_bytes`` query; raises on a CUDA error)."""
    lib = next(name for name, fns in SIGNATURES.items() if entry in fns)
    shape = (ctypes.c_int * 4)()
    got = getattr(library(lib), f"{entry}_smem_bytes")(*args, shape)
    if got < 0:
        raise RuntimeError(f"{entry}_smem_bytes{args}: CUDA error {-got}")
    return got, tuple(shape)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    """Keyed by the source and every shared header it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    rc = proc.wait()
    log = (BUILD_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns each library's
    ``nvcc`` log (``-Xptxas -v``: registers, shared memory, spills)."""
    started = {name: _start(name) for name in SIGNATURES}
    for name, s in started.items():
        _finish(name, s)
    logs = {}
    for name in SIGNATURES:
        log = BUILD_DIR / f"{name}.log"
        logs[name] = log.read_text() if log.exists() else "(cached build)"
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
