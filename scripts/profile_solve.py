#!/usr/bin/env python
"""Capture a jax.profiler trace of a foam solve — the equivalent of
the reference's NVTX ranges (common.H:54-65, nvtxRangePushA under CUDA).

Writes a TensorBoard-compatible trace directory; each solve phase is
wrapped in a jax.profiler.TraceAnnotation (common.TraceAnnotation), so the
timeline shows setup / coefficient-update / solve spans alongside the
XLA kernel rows.

Usage:
  python scripts/profile_solve.py [--dims 128x128x64] [--out /tmp/ogl_trace]
  tensorboard --logdir /tmp/ogl_trace   # or xprof
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="128x128x64")
    ap.add_argument("--out", default="/tmp/ogl_trace")
    ap.add_argument("--solver", default="GKOCG")
    ap.add_argument("--precond", default="none")
    args = ap.parse_args()
    dims = tuple(int(v) for v in args.dims.split("x"))

    import jax

    from ogl_tpu import foam
    from ogl_tpu import testing as problems

    m = problems.poisson_ldu(dims)
    rng = np.random.default_rng(0)
    b = rng.normal(size=m.n).astype(np.float32)
    controls = {"solver": args.solver, "tolerance": 1e-6, "relTol": 0,
                "maxIter": 2000}
    if args.precond != "none":
        controls["preconditioner"] = {"preconditioner": args.precond}

    slv = foam.FoamSolver("profiled", controls)
    # warm: compile + first coefficient upload outside the trace
    x, perf = slv.solve(m, b)
    print(f"warm solve: {perf.n_iterations} iters, converged={perf.converged}",
          file=sys.stderr)

    import dataclasses as dc

    m2 = dc.replace(m, diag=m.diag * (1.0 + 1e-7))
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        x, perf = slv.solve(m2, b)  # steady-state step: update + solve
        jax.block_until_ready(x) if hasattr(x, "block_until_ready") else None
        dt = time.perf_counter() - t0
    print(f"traced steady step: {dt * 1e3:.1f} ms, "
          f"{perf.n_iterations} iters -> {args.out}", file=sys.stderr)
    print(f"trace written to {args.out}")


if __name__ == "__main__":
    main()
