"""Solver configuration — the fvSolution-dictionary surface of the reference.

Accepts exactly the keys the reference reads (with identical defaults) so a
user can paste their fvSolution solver sub-dict across:

  executor           reference ExecutorHandler.H:128: cuda -> the GPU (raises
                     without one), reference|omp|cpu -> the CPU, unset -> JAX's
                     default device (JAX_PLATFORMS decides)
  matrixFormat       lduLduBase.H:56, default "Coo"    (+ "Dia", "Sell", "Ell",
                     "Gdia", "Xell", "Hybrid")
  updateRHS          lduLduBase.H:224, default true
  updateInitGuess    lduLduBase.H:235, default false
  updateSysMatrix    (matrix coefficient re-upload), default true
  scaling            HostMatrix.C:33, default 1.0
  verbose            lduLduBase.H:49, default 0
  debug / export     lduLduBase.H:50,259
  forceHostBuffer / ranksPerGPU / reorderOnHost — accepted, no-ops
  fusedCG / fusedBiCGStab — accepted and ignored (older selectors of
      merged-kernel solvers that no longer exist)
  pipelinedCG false — single-reduction CG variant beyond the reference
      key set
  tolerance 1e-6, relTol 1e-6, minIter 0, maxIter 1000,
  adaptMinIter true, relaxationFactor 0.6, resNormEval 0.1,
  normEvalLimit 100, evalFrequency 1            StoppingCriterion.H:165-177
  (maxIter is doubled for GKOBiCGStab, StoppingCriterion.H:188)
  preconditioner     word or sub-dict, Preconditioner.H:83-351:
      BJ(maxBlockSize=1), ILU/ILUT/IRILU, IC/ICT, ISAI/GISAI(sparsityPower=1),
      Multigrid(maxLevels=9, minCoarseRows=10, cycle=v, coarseSolverIters=4
      — alias coarseMaxIters, GKOMultigrid.H:82 —, zeroGuess=true),
      caching=0, skipSorting=true

Keys the reference parses into DEAD state (never read after storage) are
accepted and ignored here too: `preconditionerCaching` (ctor member
cache_preconditioner_ is unused — the live TTL comes from the sub-dict's
`caching`, Preconditioner.H:405-417) and `PreconditionerMultigridUseIR`
(inside a comment block, Preconditioner.H:280).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["StoppingConfig", "PrecondConfig", "SolverConfig", "parse_controls"]

MATRIX_FORMATS = ("Coo", "Csr", "Ell", "Dia", "Sell", "Gdia", "Hybrid",
                  "Xell")


@dataclasses.dataclass(frozen=True)
class StoppingConfig:
    """OpenFOAM convergence controls (reference StoppingCriterion.H:135-177)."""

    tolerance: float = 1e-6
    rel_tol: float = 1e-6
    min_iter: int = 0
    max_iter: int = 1000
    adapt_min_iter: bool = True
    relaxation_factor: float = 0.6
    # parsed for drop-in compatibility but UNUSED — exactly like the
    # reference, which stores res_norm_eval_ and never reads it
    # (StoppingCriterion.H:143,169-170; the adaptMinIter formula at
    # :199-209 uses only the measured prev_rel_cost)
    res_norm_eval: float = 0.1
    norm_eval_limit: int = 100
    frequency: int = 1

    def adapted(self, prev_solve_iters: int, prev_rel_cost: float, export_res: bool):
        """adaptMinIter policy (reference StoppingCriterion.H:199-209): raise
        minIter to relaxationFactor×previous iteration count and stretch the
        residual-check frequency by the measured cost ratio of a residual
        evaluation relative to an iteration."""
        min_iter, frequency = self.min_iter, self.frequency
        if not export_res and prev_solve_iters > 0 and self.adapt_min_iter and prev_rel_cost > 0:
            # clamp: relaxationFactor >= 1 would divide by zero (or yield a
            # complex alpha) below; the policy is only meaningful in [0, 1)
            rf = min(max(self.relaxation_factor, 0.0), 0.99)
            min_iter = int(prev_solve_iters * rf)
            alpha = (
                1.0 / (prev_solve_iters * (1.0 - rf)) * prev_rel_cost
            ) ** 0.5
            frequency = min(self.norm_eval_limit, max(1, int(1.0 / alpha)))
        return dataclasses.replace(self, min_iter=min_iter, frequency=frequency)


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Preconditioner selection (reference Preconditioner.H:83-351)."""

    name: str = "none"  # none|BJ|ILU|ILUT|IRILU|IC|ICT|ISAI|GISAI|Multigrid
    max_block_size: int = 1
    sparsity_power: int = 1
    skip_sorting: bool = True
    caching: int = 0  # TTL in solves; 0 = regenerate each solve
    approximate_select: bool = False
    # Multigrid (as preconditioner) knobs
    max_levels: int = 9
    min_coarse_rows: int = 10
    zero_guess: bool = True
    cycle: str = "v"
    coarse_solver_iters: int = 4
    # sweeps for the Jacobi-style approximate triangular solve used to
    # apply ILU/IC factors (no sequential trisolve on the device).
    tri_solve_sweeps: int = 8
    # "approx" (default: triSolveSweeps-truncated Neumann) or "exact": run
    # the same sweep iteration to each factor's dependency depth, which IS
    # exact substitution (precond/ilu.py module docstring) — the
    # reference's default ILU/IC use Ginkgo's exact sparse trisolves
    # (Preconditioner.H:146-178); costs depth/sweeps x per apply
    tri_solve: str = "approx"
    # AMG aggregation: "auto" (2x-per-axis geometric block aggregation when
    # the operator is a box-grid stencil — grid-independent convergence,
    # reshape transfers, every level stays DIA; falls back to natural),
    # "grid" (same, explicit), "natural" (1-D consecutive runs — the only
    # x-semicoarsening; reshape transfers) or "pgm" (strength-based
    # matching like the reference's amgx_pgm; gather/scatter transfers)
    aggregation: str = "auto"
    # aggregate size per natural-aggregation level (coarsening rate).  The
    # cycle cost is launch-latency-bound across small levels, so a
    # shallower hierarchy (rate 8) is cheaper per cycle than pairwise
    coarsening_rate: int = 8
    # coarsest-level solve: "direct" (dense inverse, one matvec) or
    # "cg" (fixed-iteration CG, the reference's coarsest_gen)
    coarse_solver: str = "direct"
    # Jacobi smoother sweeps per pre/post smooth (reference smoother_gen:
    # 2 IR iterations, Preconditioner.H:300-312)
    smoother_sweeps: int = 2
    # storage precision of the preconditioner STATE ("default" = container
    # dtype, or "bfloat16"): a preconditioner only steers the Krylov
    # iteration, so narrowing its stored operator halves its HBM stream at
    # the cost of (at most) a few extra outer iterations.  The analogue
    # of Ginkgo's block-Jacobi storage_optimization
    # (precision_reduction::autodetect), which the reference leaves
    # commented out (GKOIR.H:92-93).
    value_precision: str = "default"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver: str = "GKOCG"
    executor: str | None = None
    matrix_format: str = "Coo"
    update_rhs: bool = True
    update_init_guess: bool = False
    update_sys_matrix: bool = True
    scaling: float = 1.0
    verbose: int = 0
    debug: bool = False
    export: bool = False
    stopping: StoppingConfig = StoppingConfig()
    precond: PrecondConfig = PrecondConfig()
    # GMRES restart (Ginkgo default krylov_dim)
    krylov_dim: int = 100
    # dtype of device compute ("float32"|"float64"|"bfloat16")
    dtype: str = "float32"
    # single-reduction (Chronopoulos–Gear) CG: fuse the per-iteration
    # <r,z>, <p,Ap> and ‖r‖₁ reductions into ONE psum — 3x fewer
    # collective latencies per distributed iteration (solve/cg_pipe.py).
    # Applies to GKOCG on the general and distributed paths
    # (beyond-reference feature, no reference analogue)
    pipelined_cg: bool = False
    # bandwidth-reducing renumbering applied at setup: "none" | "rcm"
    # (OpenFOAM renumberMesh analogue; reduces Gdia plane count)
    reorder: str = "none"
    # distributed decomposition of a GLOBAL system handed to DistFoamSolver:
    # "simple" (contiguous blocks, decomposePar simple) | "scotch"/"bisect"
    # (graph-partitioned, decomposePar scotch role; core/graph.py).  The
    # reference's integration matrix tests both (test/integration.yaml:47-57)
    decomposition: str = "simple"
    # route SAME-rank cyclic couplings through the halo exchange as paired
    # self-neighbor ProcInterfaces instead of explicit local columns
    # (ldu.decompose cyclic_via_halo).  Same operator either way; the halo
    # route executes a real ppermute round per distributed iteration even
    # on a one-device mesh — the way the halo-exchange hot path is
    # exercised on a single device
    cyclic_via_halo: bool = False
    # force full device-matrix regeneration each solve instead of the
    # in-place value overwrite (reference CsrMatrixWrapper.H:76-136)
    regenerate: bool = False
    # distributed local-block format: "auto" (Dia if the union of diagonal
    # offsets across shards is narrow, else Gdia if the union plane table
    # is bounded, else Xell for large fully-unstructured shards, else Ell
    # — with a warning when >=32768-row shards land on the Ell gather
    # tier), "Dia", "Gdia", "Xell", or "Ell"
    dist_local_format: str = "auto"
    # GKOIR `inner` sub-dictionary (reference GKOIR.H:47-52 requires
    # subDict("inner") and builds an inner CG with its OWN OpenFOAM
    # stopping criterion).  None keeps the preconditioned-Richardson
    # behaviour (gko::solver::Ir's default identity inner solver).
    inner_stopping: StoppingConfig | None = None
    # storage precision of the INNER operator ("default" = solver dtype,
    # or "bfloat16"): mixed-precision defect correction — the outer
    # Richardson computes exact f32 residuals against the full-precision
    # matrix, so the solve converges to f32 accuracy while the inner CG
    # streams a half-width operator (a memory-bandwidth lever; no
    # reference analogue — Ginkgo's storage_optimization is commented out
    # in GKOIR.H:92-93)
    inner_precision: str = "default"
    # host->device stream compression for the steady-state coefficient/RHS
    # uploads ("default" = full-width f32, or "bfloat16"): upload the
    # CHANGE against a host-mirrored copy of the device state as bf16 with
    # error feedback — the mirror tracks the device bit-exactly, so the
    # quantisation error is bounded by the bf16 quantum of the LAST delta
    # (~0.4% of the per-step CHANGE, not of the coefficients) and does not
    # accumulate.  Blocks whose delta would exceed `uploadDeltaTol`
    # relative operator error are uploaded full-width instead (automatic
    # f32 refresh).  Halves the steady-state host->device coefficient
    # stream.  No reference analogue.
    upload_precision: str = "default"
    # max relative error (inf-norm, per block) the bf16 delta encoding may
    # leave against the exact f32 coefficients before the block falls back
    # to a full-width upload.  None (the default) resolves at use to 1e-5
    # capped at min(tolerance, relTol)/10 so the reported finalResidual
    # cannot overstate accuracy against the true system (advisor r04); an
    # EXPLICIT value — via the uploadDeltaTol key OR set directly on the
    # dataclass — is honored as-is (the user accepts compressed-operand
    # residuals at that level; explicitness lives in the value itself so
    # dataclasses.replace copies carry it)
    upload_delta_tol: float | None = None
    # GMRES Krylov-basis storage precision ("default" = solver dtype, or
    # "bfloat16"): V is the dominant per-iteration HBM stream at scale
    # (~j·n·4 B read per orthogonalisation at f32) — storing it bf16
    # halves that traffic while H, the Givens chain, dots and x stay full
    # precision.  Restarts bound the accuracy cost: x accumulates across
    # cycles in full precision and the materialised OpenFOAM criterion
    # evaluates the TRUE residual, so no false convergence (solve/gmres.py;
    # no reference analogue)
    basis_precision: str = "default"


_BOOL = {"true": True, "yes": True, "on": True, "1": True,
         "false": False, "no": False, "off": False, "0": False}


def _as_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    return _BOOL[str(v).strip().lower()]


def parse_controls(controls: dict[str, Any]) -> SolverConfig:
    """Build a SolverConfig from a (parsed) fvSolution solver sub-dictionary.

    Unknown keys are ignored (OpenFOAM dictionaries carry extra keys like
    `smoother` freely); known keys use the reference defaults above.
    """
    g = controls.get

    solver = str(g("solver", "GKOCG"))
    max_iter = int(g("maxIter", 1000))
    if solver == "GKOBiCGStab":
        max_iter *= 2  # reference StoppingCriterion.H:188

    stopping = StoppingConfig(
        tolerance=float(g("tolerance", 1e-6)),
        rel_tol=float(g("relTol", 1e-6)),
        min_iter=int(g("minIter", 0)),
        max_iter=max_iter,
        adapt_min_iter=_as_bool(g("adaptMinIter", True)),
        relaxation_factor=float(g("relaxationFactor", 0.6)),
        res_norm_eval=float(g("resNormEval", 0.1)),
        norm_eval_limit=int(g("normEvalLimit", 100)),
        frequency=int(g("evalFrequency", 1)),
    )

    pc = g("preconditioner", "none")
    if isinstance(pc, dict):
        pg = pc.get
        precond = PrecondConfig(
            name=str(pg("preconditioner", pg("name", "none"))),
            max_block_size=int(pg("maxBlockSize", 1)),
            sparsity_power=int(pg("sparsityPower", 1)),
            skip_sorting=_as_bool(pg("skipSorting", True)),
            caching=int(pg("caching", 0)),
            approximate_select=_as_bool(pg("approximateSelect", False)),
            max_levels=int(pg("maxLevels", 9)),
            min_coarse_rows=int(pg("minCoarseRows", 10)),
            zero_guess=_as_bool(pg("zeroGuess", True)),
            cycle=str(pg("cycle", "v")),
            # coarseMaxIters is the (dead) GKOMultigrid-as-solver spelling
            # of the same knob (GKOMultigrid.H:82); accept both
            coarse_solver_iters=int(pg("coarseSolverIters",
                                       pg("coarseMaxIters", 4))),
            tri_solve_sweeps=int(pg("triSolveSweeps", 8)),
            tri_solve=_validated(str(pg("triSolve", "approx")),
                                 ("approx", "exact"), "triSolve"),
            aggregation=str(pg("aggregation", "auto")),
            coarsening_rate=int(pg("coarseningRate", 8)),
            coarse_solver=str(pg("coarseSolver", "direct")),
            smoother_sweeps=int(pg("smootherSweeps", 2)),
            value_precision=str(pg("precision", "default")),
        )
        if precond.value_precision not in ("default", "float32", "bfloat16"):
            raise ValueError(
                f"preconditioner precision {precond.value_precision!r}: "
                "use default|float32|bfloat16")
    else:
        precond = PrecondConfig(name=str(pc))

    fmt = str(g("matrixFormat", "Coo"))
    if fmt not in MATRIX_FORMATS:
        raise ValueError(f"matrixFormat {fmt!r} not in {MATRIX_FORMATS}")

    # GKOIR inner-solver sub-dict (reference GKOIR.H:47-52): its own full
    # stopping-key set, plus the `precision` storage override (no reference
    # analogue)
    inner = g("inner", None)
    inner_stopping = None
    inner_precision = "default"
    if isinstance(inner, dict):
        ig = inner.get
        inner_stopping = StoppingConfig(
            tolerance=float(ig("tolerance", 1e-6)),
            rel_tol=float(ig("relTol", 1e-6)),
            min_iter=int(ig("minIter", 0)),
            max_iter=int(ig("maxIter", 1000)),
            adapt_min_iter=False,  # adaptation state belongs to the outer
            relaxation_factor=float(ig("relaxationFactor", 0.6)),
            res_norm_eval=float(ig("resNormEval", 0.1)),
            norm_eval_limit=int(ig("normEvalLimit", 100)),
            frequency=int(ig("evalFrequency", 1)),
        )
        inner_precision = str(ig("precision", "default"))
        if inner_precision not in ("default", "float32", "bfloat16"):
            raise ValueError(
                f"inner precision {inner_precision!r}: use default|float32|bfloat16")

    return SolverConfig(
        solver=solver,
        executor=(str(g("executor")) if "executor" in controls else None),
        matrix_format=fmt,
        update_rhs=_as_bool(g("updateRHS", True)),
        update_init_guess=_as_bool(g("updateInitGuess", False)),
        update_sys_matrix=_as_bool(g("updateSysMatrix", True)),
        scaling=float(g("scaling", 1.0)),
        verbose=int(g("verbose", 0)),
        debug=_as_bool(g("debug", False)),
        export=_as_bool(g("export", False)),
        stopping=stopping,
        precond=precond,
        krylov_dim=int(g("krylovDim", 100)),
        dtype=str(g("dtype", "float32")),
        pipelined_cg=_as_bool(g("pipelinedCG", False)),
        reorder=str(g("reorder", "none")),
        decomposition=str(g("decomposition", "simple")),
        cyclic_via_halo=_as_bool(g("cyclicViaHalo", False)),
        regenerate=_as_bool(g("regenerate", False)),
        dist_local_format=str(g("distLocalFormat", "auto")),
        inner_stopping=inner_stopping,
        inner_precision=inner_precision,
        upload_precision=_validated(
            str(g("uploadPrecision", "default")), ("default", "bfloat16"),
            "uploadPrecision"),
        upload_delta_tol=(float(g("uploadDeltaTol", 0.0))
                          if "uploadDeltaTol" in controls else None),
        basis_precision=_validated(
            str(g("basisPrecision", "default")), ("default", "bfloat16"),
            "basisPrecision"),
    )


def _validated(v: str, allowed: tuple, key: str) -> str:
    if v not in allowed:
        raise ValueError(f"{key} {v!r}: use {'|'.join(allowed)}")
    return v
