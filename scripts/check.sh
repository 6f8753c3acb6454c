#!/usr/bin/env bash
# Static + test gate (the reference's L5 CI analogue: build matrix, unit
# tests, clang-tidy/format checks — here: byte-compile, import, full pytest).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== lint =="
python scripts/lint.py

echo "== byte-compile =="
python -m compileall -q ogl_tpu bench.py __graft_entry__.py

echo "== import check =="
JAX_PLATFORMS=cpu python -c "
import jax; jax.config.update('jax_platforms', 'cpu')
import ogl_tpu, ogl_tpu.foam, ogl_tpu.dist, ogl_tpu.precond, ogl_tpu.kernels
import ogl_tpu.kernels.gdia, ogl_tpu.kernels.xell, ogl_tpu.kernels.roofline
print('imports ok; native lib available:', __import__('ogl_tpu.native', fromlist=['x']).available())
"

echo "== tests =="
python -m pytest tests/ -x -q
