"""Double-precision solves in a default (non-x64) process: host-f64 defect
correction around the f32 device path.

OpenFOAM's default scalar is double and the reference serves it natively —
Ginkgo solvers run whatever `gko::` value type the build picked
(GKOCG.H:45-61).  In a JAX process that has not enabled `jax_enable_x64`,
every jnp array is float32, so "just run the solver in f64" is not
available without switching the whole process to x64.

The answer here is mixed-precision defect correction (iterative
refinement, Wilkinson 1963; Carson & Higham 2018 for the Krylov-inner
form): keep the OUTER state (x, r = b − A·x, the stopping criterion) in
float64 on the host and solve each correction equation A·dx = r on the
device in float32 through the ordinary FoamSolver.  Each outer sweep
multiplies the residual by the inner relative tolerance, so digits accrue
geometrically: with the default inner relTol 1e-4, four sweeps reach
~1e-16.

Cost model: CG iteration counts scale with target digits, so a 1e-12
target costs a few times the inner work of a 1e-6 f32 solve; each sweep
also pays one host round trip (stats+dx fetched in ONE batched
device_get), the f64 RHS upload and the host CSR SpMV.  The H100 computes
f64 natively, so a native-f64 device path may beat this route (ROADMAP
reach item 1; not measured yet).

The outer work per sweep is one host CSR f64 SpMV plus vector ops (~60 MB
of host traffic at 1M rows / 7 nnz per row) — microseconds-class per cell,
overlapped against nothing because it IS the accuracy step.  The host
operator shares the assembly path (`ldu_to_coo_host`) with the device
formats, and the inner FoamSolver's delta-upload machinery sees identical
coefficients every sweep, so only the new RHS crosses the wire after the
first sweep.

Spelled in the fvSolution dictionary as `dtype float64` on any solver in a
normal (non-x64) process; `GKOIR` + an `inner` sub-dict is the canonical
form (the reference's create_default inner-CG shape, GKOIR.H:58-78), other
solver names use themselves as the inner solver.  Processes that DID
enable x64 keep the existing native-f64 XLA route.
"""

from __future__ import annotations

import time
from typing import Any

import jax
import numpy as np

from ogl_tpu import common
from ogl_tpu.config import SolverConfig, parse_controls
from ogl_tpu.core import ldu as ldu_mod
from ogl_tpu.foam.solver import FoamSolver, SolverPerformance
from ogl_tpu.solve.stopping import small_of

__all__ = ["F64DefectSolver", "wants_host_f64"]


def wants_host_f64(cfg: SolverConfig) -> bool:
    """True when a solve configured `dtype float64` should route through
    the host-outer defect correction: the process has NOT enabled x64
    (jnp arrays would silently truncate to f32 — worse than either real
    choice) — regardless of backend, so tests on CPU exercise the same
    code path that runs on the GPU."""
    return cfg.dtype == "float64" and not jax.config.jax_enable_x64


def _inner_config(cfg: SolverConfig) -> SolverConfig:
    """The device-side correction solver: the user's solver in f32.  An
    `inner` sub-dict (GKOIR spelling) supplies the stopping criterion;
    otherwise each sweep runs the outer tolerance knobs with a 1e-4 floor
    on relTol (tighter is wasted — f32 stagnates near 1e-7, and digits
    beyond the sweep gain cost extra inner iterations linearly)."""
    import dataclasses

    inner_stop = cfg.inner_stopping
    if inner_stop is None:
        inner_stop = dataclasses.replace(
            cfg.stopping,
            tolerance=0.0,
            rel_tol=max(cfg.stopping.rel_tol, 1e-4),
        )
    solver = cfg.solver if cfg.solver != "GKOIR" else "GKOCG"
    return dataclasses.replace(
        cfg,
        solver=solver,
        dtype="float32",
        stopping=inner_stop,
        inner_stopping=None,
        # the outer loop owns export/debug artifacts; inner solves are
        # correction equations whose RHS changes every sweep
        export=False,
        debug=False,
    )


class F64DefectSolver:
    """Per-field persistent f64 front end (drop-in for FoamSolver where
    `dtype float64` without x64): f64 outer Richardson on host, f32 device
    inner.  Registered under the same `<field>_solver` key.

    `inner` injects the correction solver — the default is a single-device
    FoamSolver; DistFoamSolver drops in for the DISTRIBUTED f64 route
    (same defect-correction outer over the global host CSR, fused dist-f32
    inner over the mesh — reference parity: Ginkgo runs native double
    through the distributed path, GKOCG.H:45-61,
    CsrMatrixWrapper.H:163-210)."""

    def __init__(self, field_name: str, controls: dict | SolverConfig,
                 inner=None):
        cfg = controls if isinstance(controls, SolverConfig) else parse_controls(controls)
        if not wants_host_f64(cfg):
            raise ValueError("F64DefectSolver requires dtype float64 in a "
                             "non-x64 process")
        self.field = field_name
        self.cfg = cfg
        self.inner = (inner if inner is not None
                      else FoamSolver(field_name + "%f64inner",
                                      _inner_config(cfg)))
        # batch the inner's stats fetch with the correction-vector fetch:
        # one host round trip per sweep instead of two (the sweep loop is
        # bound by round trips)
        if hasattr(self.inner, "_fetch_x_with_stats"):
            self.inner._fetch_x_with_stats = True
        self._csr = None
        self._blocks_prev = None
        self.last_outer_sweeps = 0
        self.last_timings: dict[str, float] = {}

    # -- host f64 operator ------------------------------------------------
    def _update_host_operator(self, m: ldu_mod.LduMatrix):
        """Rebuild the host CSR only when coefficients changed (same delta
        contract as FoamSolver._update_matrix; the sparsity is validated by
        the inner solver, which sees the same LduMatrix)."""
        blocks = [np.asarray(m.diag), np.asarray(m.upper)]
        if not m.symmetric:
            blocks.append(np.asarray(m.lower))
        for li in m.local_interfaces:
            blocks.append(np.asarray(li.coeffs))
        prev = self._blocks_prev
        if (self._csr is not None and prev is not None
                and len(prev) == len(blocks)
                and all(p.shape == b.shape and np.array_equal(p, b)
                        for p, b in zip(prev, blocks))):
            return
        coo = ldu_mod.ldu_to_coo_host(m, scale=self.cfg.scaling,
                                      dtype=np.float64)
        vals = np.asarray(coo.vals, np.float64)
        if self._csr is not None and self._csr.nnz == len(vals):
            # coefficient-only change: the LDU sparsity emits row-major
            # (CSR-data) order, so the update is one data overwrite — no
            # structure rebuild in the steady state
            self._csr.data[:] = vals
        else:
            import scipy.sparse as sp

            self._csr = sp.csr_matrix(
                (vals, (np.asarray(coo.rows), np.asarray(coo.cols))),
                shape=coo.shape)
        self._blocks_prev = [np.array(b) for b in blocks]

    # -- OpenFOAM stopping pieces in f64 -----------------------------------
    def _norm_factor(self, b: np.ndarray, x0: np.ndarray) -> float:
        """StoppingCriterion.C:32-69 evaluated in f64: with x̄ = mean(x0)
        broadcast, nf = ‖ |A·x0 − A·x̄| + |b − A·x̄| ‖₁ + SMALL."""
        xref = np.full_like(b, float(np.mean(x0)))
        axref = self._csr @ xref
        ax0 = self._csr @ x0
        return float(np.sum(np.abs(ax0 - axref) + np.abs(b - axref))
                     + small_of(np.float64))

    # -- solve --------------------------------------------------------------
    def solve(self, m: ldu_mod.LduMatrix, b, psi=None,
              time_value: str | None = None) -> tuple[Any, SolverPerformance]:
        cfg = self.cfg
        if not isinstance(m, ldu_mod.LduMatrix):
            raise TypeError(
                "the host-f64 defect correction needs the GLOBAL LduMatrix "
                "to build its f64 outer operator; per-rank system lists "
                "(multi-process deployment) have no host-f64 route yet — "
                "enable jax_enable_x64 for native-f64 XLA on the mesh, or "
                "hand the global system to solve_distributed")
        t0 = time.perf_counter()
        self._update_host_operator(m)
        b64 = np.asarray(b, np.float64) * float(cfg.scaling)
        x = (np.asarray(psi, np.float64).copy()
             if psi is not None and cfg.update_init_guess
             else np.zeros_like(b64))

        nf = self._norm_factor(b64, x)
        r = b64 - self._csr @ x
        init_res = float(np.sum(np.abs(r))) / nf
        res = init_res
        st = cfg.stopping
        total_inner = 0
        sweeps = 0
        # each sweep gains ~|log10(inner relTol)| digits; 8 sweeps bound
        # covers tolerance 1e-16 from the 1e-4 default with slack
        max_sweeps = 8
        while (res > st.tolerance
               and (st.rel_tol <= 0 or res > st.rel_tol * init_res)
               and sweeps < max_sweeps
               and total_inner < st.max_iter):
            # correction equation on device, f32 fused path; the inner
            # FoamSolver handles scaling itself, so hand it the UNSCALED
            # residual (solution of (s·A)dx = s·r is scale-invariant)
            dx, perf = self.inner.solve(m, r / float(cfg.scaling))
            # last_x_host is the raw device solution — valid only when the
            # inner did not renumber (solve() back-permutes its return)
            dx_host = (self.inner.last_x_host
                       if getattr(self.inner, "last_x_host", None) is not None
                       and getattr(self.inner, "_reorder", None) is None
                       else jax.device_get(dx))
            x += np.asarray(dx_host, np.float64)
            r = b64 - self._csr @ x
            res = float(np.sum(np.abs(r))) / nf
            total_inner += perf.n_iterations
            sweeps += 1
            common.log(cfg.verbose, 1,
                       f"{self.field}: f64 sweep {sweeps}: inner "
                       f"{perf.n_iterations} iters, outer residual {res:.3e}")

        self.last_outer_sweeps = sweeps
        self.last_timings = dict(getattr(self.inner, "last_timings", {}))
        self.last_timings["f64_total"] = time.perf_counter() - t0
        converged = bool(res <= st.tolerance
                         or (st.rel_tol > 0 and res <= st.rel_tol * init_res))
        perf = SolverPerformance(
            solver_name=(f"{cfg.solver}_f64defect_"
                         f"{getattr(self.inner, '_fmt_used', 'dist')}"),
            field_name=self.field,
            initial_residual=init_res,
            final_residual=res,
            n_iterations=total_inner,
            converged=converged,
        )
        return x, perf

    def time_device_solve(self, reps: int = 3) -> float:
        return self.inner.time_device_solve(reps)
