#!/usr/bin/env python
"""Multi-field cold-start: wall-clock to the FIRST completed time step of a
4-field transient case (p + U x 3) from a fresh process — the number an
OpenFOAM user actually feels when they launch a case on a new machine
(reference analogue: per-field persistent init, lduLduBase.H:141-160,
which pays no compile step but re-converts per field).

One "time step" = 3 momentum component solves (GKOBiCGStab+BJ on a
convection-diffusion operator, icoFoam-style) followed by a pressure solve
(GKOCG+BJ on the Poisson operator).  The U components share one operator
STRUCTURE (and therefore one compiled program + one format conversion —
only values differ), exactly like Ux/Uy/Uz in a segregated solver.

Run it on its own (one process per card), choosing the cache regime:
  PYTHONPATH=. JAX_COMPILATION_CACHE_DIR=<fresh dir> python scripts/cold_start.py
      -> cold machine (XLA compiles everything)
  the same command again with the same directory
      -> warm machine (process restart, cache hit)
COLD_DIMS=NXxNYxNZ sets the mesh (default 128x128x64).

Prints one JSON line on stdout:
  {"import_s": .., "setup_s": .., "fields_s": {"Ux": .., "Uy": .., "Uz": ..,
   "p": ..}, "first_step_s": .., "second_step_s": .., "iters": {...}}
"""

import json
import os
import sys
import time


def main():
    t_start = time.perf_counter()
    dims = tuple(int(v) for v in
                 os.environ.get("COLD_DIMS", "128x128x64").split("x"))

    import dataclasses as dc

    import numpy as np

    from ogl_tpu import foam
    from ogl_tpu import testing as problems

    t_import = time.perf_counter() - t_start

    t0 = time.perf_counter()
    mp = problems.poisson_ldu(dims)
    mu = problems.convection_diffusion_ldu(dims, peclet=0.5)
    rng = np.random.default_rng(0)
    b_u = [rng.normal(size=mu.n).astype(np.float32) for _ in range(3)]
    b_p = rng.normal(size=mp.n).astype(np.float32)
    u_ctl = {"solver": "GKOBiCGStab", "tolerance": 1e-7, "relTol": 1e-2,
             "maxIter": 1000, "preconditioner": "BJ"}
    p_ctl = {"solver": "GKOCG", "tolerance": 1e-7, "relTol": 1e-3,
             "maxIter": 2000, "preconditioner": "BJ"}
    solvers = {c: foam.FoamSolver(f"U{c}", u_ctl) for c in "xyz"}
    solvers["p"] = foam.FoamSolver("p", p_ctl)
    t_setup = time.perf_counter() - t0

    def step(mu_s, mp_s):
        out, its = {}, {}
        for i, c in enumerate("xyz"):
            t0 = time.perf_counter()
            _, perf = solvers[c].solve(mu_s, b_u[i])
            out[f"U{c}"] = time.perf_counter() - t0
            its[f"U{c}"] = perf.n_iterations
            assert perf.converged, f"U{c} did not converge"
        t0 = time.perf_counter()
        _, perf = solvers["p"].solve(mp_s, b_p)
        out["p"] = time.perf_counter() - t0
        its["p"] = perf.n_iterations
        assert perf.converged, "p did not converge"
        return out, its

    fields_s, iters = step(mu, mp)
    first_step_s = time.perf_counter() - t_start

    # one steady-state step: same structure, nudged values (transient terms)
    f = np.float32(1.0 + 1e-6)
    mu2 = dc.replace(mu, diag=mu.diag * f)
    mp2 = dc.replace(mp, diag=mp.diag * f)
    t0 = time.perf_counter()
    step(mu2, mp2)
    second_step_s = time.perf_counter() - t0

    print(json.dumps({
        "import_s": round(t_import, 3),
        "setup_s": round(t_setup, 3),
        "fields_s": {k: round(v, 3) for k, v in fields_s.items()},
        "first_step_s": round(first_step_s, 3),
        "second_step_s": round(second_step_s, 3),
        "iters": iters,
    }))


if __name__ == "__main__":
    sys.exit(main())
