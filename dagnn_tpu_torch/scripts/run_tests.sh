#!/usr/bin/env bash
# The port's test suite on the CPU, in one process: every
# tests/test_torch_*.py (each holds the port against the JAX package,
# which runs on the CPU in Pallas interpret mode). Extra args go to
# pytest, e.g. run_tests.sh -n 4 --dist loadfile. The card's tests are
# tests/test_torch_cuda.py, run on the GPU machine with
#   python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
set -e
cd "$(dirname "$0")/../.."
export JAX_PLATFORMS=cpu
exec python -m pytest tests/test_torch_*.py -q -p no:cacheprovider "$@"
