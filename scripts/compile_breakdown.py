#!/usr/bin/env python
"""Per-program XLA compile-time breakdown for a cold first solve.

Runs one foam solve configuration in THIS process with a throwaway
compilation cache (so every program compiles) and `jax_log_compiles`
capture, then prints the programs sorted by compile seconds plus the
end-to-end first-solve wall time.

Usage:
  PYTHONPATH=. python scripts/compile_breakdown.py \
      [--dims 128x128x64] [--solver GKOGMRES] [--precond GISAI]

The reference has no compile step (Ginkgo kernels are precompiled); this
cost is XLA-specific debt, so the fix is measured here, not assumed:
variant reduction only where the breakdown shows a variant that matters.
"""

import argparse
import logging
import re
import sys
import tempfile
import time


class _CompileLog(logging.Handler):
    """Capture 'Finished XLA compilation of <name> in <sec> sec' records."""

    PAT = re.compile(r"Finished XLA compilation of (.+?) in ([0-9.eE+-]+) sec")

    def __init__(self):
        super().__init__()
        self.events = []

    def emit(self, record):
        m = self.PAT.search(record.getMessage())
        if m:
            self.events.append((m.group(1), float(m.group(2))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="128x128x64")
    ap.add_argument("--solver", default="GKOGMRES")
    ap.add_argument("--precond", default="GISAI")
    ap.add_argument("--controls-json", default=None,
                    help="extra controls dict entries as JSON")
    args = ap.parse_args()
    dims = tuple(int(v) for v in args.dims.split("x"))

    import jax

    # throwaway cache: force every program to actually compile
    jax.config.update("jax_compilation_cache_dir",
                      tempfile.mkdtemp(prefix="ogl_compile_bd_"))
    jax.config.update("jax_log_compiles", True)
    cap = _CompileLog()
    # jax_log_compiles emits at WARNING — just attach the capture handler,
    # and silence the records from propagating to stderr
    for name in ("jax._src.interpreters.pxla", "jax._src.dispatch"):
        lg = logging.getLogger(name)
        lg.addHandler(cap)
        lg.propagate = False

    import numpy as np

    from ogl_tpu import foam
    from ogl_tpu import testing as problems

    m = problems.poisson_ldu(dims)
    rng = np.random.default_rng(0)
    b = rng.normal(size=m.n).astype(np.float32)
    controls = {"solver": args.solver, "tolerance": 1e-6, "relTol": 0,
                "maxIter": 2000}
    if args.precond != "none":
        controls["preconditioner"] = {"preconditioner": args.precond}
        if args.precond == "GISAI":
            controls["preconditioner"].update(
                {"sparsityPower": 1, "caching": 30})
    if args.controls_json:
        import json

        controls.update(json.loads(args.controls_json))

    slv = foam.FoamSolver("bd", controls)
    t0 = time.perf_counter()
    _, perf = slv.solve(m, b)
    wall = time.perf_counter() - t0
    total = sum(s for _, s in cap.events)
    print(f"\nfirst solve: {wall:.1f} s wall, {perf.n_iterations} iters, "
          f"converged={perf.converged}")
    print(f"XLA compiles: {len(cap.events)} programs, {total:.1f} s total "
          f"({100 * total / max(wall, 1e-9):.0f}% of wall)\n")
    print(f"{'seconds':>8}  program")
    for name, sec in sorted(cap.events, key=lambda e: -e[1]):
        print(f"{sec:8.2f}  {name[:90]}")

    # a second solve shows the steady state pays none of this
    t0 = time.perf_counter()
    slv.solve(m, b)
    print(f"\nsecond solve: {time.perf_counter() - t0:.2f} s "
          f"(compiles: {len(cap.events)} total, unchanged ="
          " no recompilation)")


if __name__ == "__main__":
    sys.exit(main())
