"""Preconditioners — JAX equivalents of the reference's factory
(Preconditioner/Preconditioner.H:83-351).

Name dispatch matches the reference: none, BJ, ILU, ILUT, IRILU, IC, ICT,
ISAI, GISAI, Multigrid.  Each build_* returns an apply closure `r -> M⁻¹ r`
that is pure JAX (jit/while_loop-safe); all data-dependent setup happens
host-side once (sparsity is constant across solves).

Mapping of the Ginkgo machinery (SURVEY.md §2b):
  block Jacobi      -> batched dense inverse + batched matmul apply
  ISAI              -> batched small dense solves at setup, ELL SpMV apply
  ILU/IC triangular -> Jacobi-sweep (truncated-Neumann) approximate
                       triangular solves — the exact structure the
                       reference's IRILU uses (5 scalar-Jacobi Richardson
                       iterations per factor, Preconditioner.H:146-178)
  PGM AMG           -> host-side pairwise aggregation, per-level device
                       operators with static shapes, unrolled V/W/F cycle
"""

from __future__ import annotations

from typing import Any, Callable

import jax

from ogl_tpu.config import PrecondConfig
from ogl_tpu.core.formats import Coo

__all__ = ["PrecondOp", "build", "block_jacobi", "isai", "ilu0", "ic0", "ilut",
           "ict", "amg"]

VALID = ("none", "BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI", "Multigrid")


class PrecondOp:
    """A preconditioner as (pure apply function, state pytree).

    The split matters: `state` (inverted blocks, factor values,
    AMG level operators) is passed as a TRACED argument to the compiled
    solver, so regenerating the preconditioner for new matrix coefficients
    (the reference regenerates every solve unless `caching` is set,
    Preconditioner.H:353-431) swaps arrays WITHOUT recompiling.  Only a
    structure change (e.g. a different AMG hierarchy depth) invalidates the
    compiled program — detected via .fingerprint()."""

    def __init__(self, apply_fn: Callable[[Any, Any], Any], state: Any):
        self.apply_fn = apply_fn
        self.state = state

    def __call__(self, r):
        return self.apply_fn(self.state, r)

    def bind(self, state):
        """r -> M⁻¹r closure over a traced state (use inside jit)."""
        return lambda r: self.apply_fn(state, r)

    def fingerprint(self) -> str:
        leaves, treedef = jax.tree_util.tree_flatten(self.state)
        shapes = tuple((tuple(l.shape), str(l.dtype)) for l in leaves)
        return f"{treedef}|{shapes}"


# imports live below PrecondOp to avoid a circular import
from ogl_tpu.precond.jacobi import block_jacobi  # noqa: E402
from ogl_tpu.precond.isai import isai  # noqa: E402
from ogl_tpu.precond.ilu import ic0, ict, ilu0, ilut  # noqa: E402
from ogl_tpu.precond.amg import amg  # noqa: E402


def build(cfg: PrecondConfig, coo: Coo, verbose: int = 0) -> "PrecondOp":
    """Factory mirroring init_preconditioner_impl (Preconditioner.H:83-351).

    Knob status, matching the reference exactly:
      * skipSorting (default true) — the input is trusted to be row-major
        sorted (our LDU path always is); `skipSorting false` sorts here,
        like Ginkgo factories do under with_skip_sorting(false)
        (Preconditioner.H:88-112).
      * approximateSelect (ICT) and zeroGuess (Multigrid) — the reference
        PARSES AND LOGS these but never passes them to any factory
        (Preconditioner.H:201-214, 317-322: no with_approximate_select /
        zero-guess call); we reproduce the log-only behavior.
    """
    op = _build_impl(cfg, coo, verbose)
    if cfg.value_precision in ("float32", "bfloat16") and cfg.name != "none":
        # reduced-precision STATE (fvSolution key `precision`): every
        # floating leaf of the state pytree narrows; apply functions
        # accumulate against the f32 residual (XLA promotes bf16·f32),
        # so only the stored operator stream shrinks.  The AMG fused
        # smoothers already pack bf16 coefficient blocks; this extends
        # the same trade to every preconditioner.
        import jax.numpy as jnp

        from ogl_tpu.core.formats import cast_values

        op.state = cast_values(op.state, jnp.dtype(cfg.value_precision))
    return op


def _build_impl(cfg: PrecondConfig, coo: Coo, verbose: int) -> "PrecondOp":
    name = cfg.name
    if not cfg.skip_sorting and name != "none":
        import numpy as np

        rows = np.asarray(jax.device_get(coo.rows))
        cols = np.asarray(jax.device_get(coo.cols))
        vals = np.asarray(jax.device_get(coo.vals))
        order = np.lexsort((cols, rows))
        coo = Coo(rows=rows[order], cols=cols[order], vals=vals[order],
                  shape=coo.shape)
    if verbose > 0 and name == "ICT":
        # reference logs the knob and drops it (Preconditioner.H:201-204)
        print(f"Generate preconditioner ICT with approximate select "
              f"{int(cfg.approximate_select)} (log-only, as in the reference)")
    if verbose > 0 and name == "Multigrid":
        print(f"Generate preconditioner Multigrid MaxLevels {cfg.max_levels} "
              f"MinCoarseRows {cfg.min_coarse_rows} ZeroGuess "
              f"{int(cfg.zero_guess)} Cycle {cfg.cycle} "
              "(zeroGuess log-only, as in the reference)")
    if name == "none":
        return PrecondOp(lambda s, r: r, ())
    if name == "BJ":
        return block_jacobi(coo, cfg.max_block_size)
    if name == "ISAI":  # spd variant (Preconditioner.H:226-240)
        return isai(coo, sparsity_power=cfg.sparsity_power, spd=True)
    if name == "GISAI":  # general variant (:241-259)
        return isai(coo, sparsity_power=cfg.sparsity_power, spd=False)
    exact = cfg.tri_solve == "exact"
    if name == "ILU":
        return ilu0(coo, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if name == "ILUT":
        return ilut(coo, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if name == "IRILU":  # ILU with 5-step Richardson trisolves (:146-178)
        return ilu0(coo, sweeps=5)
    if name == "IC":
        return ic0(coo, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if name == "ICT":
        return ict(coo, sweeps=cfg.tri_solve_sweeps, exact=exact)
    if name == "Multigrid":
        return amg(
            coo,
            max_levels=cfg.max_levels,
            min_coarse_rows=cfg.min_coarse_rows,
            cycle=cfg.cycle,
            coarse_solver_iters=cfg.coarse_solver_iters,
            aggregation=cfg.aggregation,
            width=cfg.coarsening_rate,
            coarse_solver=cfg.coarse_solver,
            smooth_iters=cfg.smoother_sweeps,
        )
    raise ValueError(
        f"unsupported preconditioner: {name}\nValid choices: {', '.join(VALID)}"
    )
