#!/usr/bin/env bash
# The port's local gate (src/repro_torch), the twin of tools/check.sh:
# byte-compile, spflint's passes in their CUDA forms, the port's tests on
# the CPU (the card tests in tests/test_torch_cuda.py skip without one).
#
#   tools/check_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "== compileall (src/repro_torch) =="
python -m compileall -q src/repro_torch

echo "== spflint for the port (replay / lock / shared-memory invariants) =="
python -m repro_torch.analysis src

echo "== the port's tests (tests/test_torch_*.py) =="
python -m pytest -q tests/test_torch_*.py

echo "check_torch.sh: ALL GREEN"
