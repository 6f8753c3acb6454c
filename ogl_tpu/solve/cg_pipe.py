"""Single-reduction (Chronopoulos–Gear) PCG.

Classical PCG (solve/cg.py, the reference's gko::solver::Cg as driven by
GKOCG, Solver/CG/GKOCG.H:45-61) issues two DEPENDENT global reductions per
iteration — rho = <r,z> must complete before p is formed, and <p,Ap> before
x/r update — plus the stopping criterion's ‖r‖₁.  Inside shard_map each is
a `lax.psum`, so a distributed iteration pays three sequential collective
latencies over ICI/DCN.

The Chronopoulos–Gear rearrangement (s-step methods, J. Comput. Appl.
Math. 1989; the "pipelined CG" family) produces mathematically identical
iterates while making all three inner products available simultaneously:

    u = M⁻¹ r,  w = A u
    gamma = <r, u>,  delta = <w, u>        (+ ‖r‖₁ for the criterion)
    beta  = gamma / gamma_old              (0 on the first iteration)
    alpha = gamma / (delta − beta·gamma/alpha_old)
    p = u + beta p,   s = w + beta s       (s carries A p)
    x += alpha p,     r −= alpha s

gamma, delta and ‖r‖₁ all depend only on the carried r (and u = M⁻¹r,
w = Au), so their shard-local partial sums fuse into ONE psum of a (3,)
vector per iteration: the per-iteration collective count drops 3→1.  The
matvec/preconditioner cost per iteration is unchanged; the extra cost is
one more carried vector (s) and one axpy.

In exact arithmetic the iterates equal classical PCG's; in floating point
the alpha recurrence drifts slightly, so iteration counts match classical
CG to within rounding order (pinned by tests/test_solvers.py).  This is a
scaling feature beyond reference parity — the reference has no
single-reduction variant.  Enabled with `pipelinedCG true;` in the GKOCG
fvSolution dict (single-device and distributed paths).

The OpenFOAM stopping criterion is evaluated from the fused ‖r‖₁ via
stopping.check_from_norm (same gating/tolerance/history semantics as
stopping.check); the norm factor is computed once before the loop on the
initial residual, exactly the iteration-0 state check() would see
(StoppingCriterion.C:32-69).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ogl_tpu.config import StoppingConfig
from ogl_tpu.solve import stopping
from ogl_tpu.solve.cg import SolveResult
from ogl_tpu.solve.krylov import Ops

__all__ = ["cg_pipelined"]


class _Carry(NamedTuple):
    x: Any
    r: Any
    p: Any
    s: Any  # s = A p (recurred, not re-applied)
    gamma_old: Any
    alpha_old: Any
    stop: stopping.StopState


def cg_pipelined(ops: Ops, b, x0, cfg: StoppingConfig,
                 history_len: int = 0) -> SolveResult:
    dtype = b.dtype
    x0 = jnp.asarray(x0, dtype)
    r0 = b - ops.matvec(x0)

    # norm factor up-front: check() computes it lazily at the first check
    # (iter 0), whose r/x ARE the initial ones — identical value, but
    # hoisting it out of the loop keeps the in-loop reduction count at one
    nf = stopping.initial_norm_factor(ops, r0, x0, b)
    st0 = stopping.init_state(dtype, history_len).replace(norm_factor=nf)

    one = jnp.asarray(1.0, dtype)
    init = _Carry(x=x0, r=r0, p=jnp.zeros_like(b), s=jnp.zeros_like(b),
                  gamma_old=one, alpha_old=one, stop=st0)

    hard_cap = cfg.max_iter + cfg.frequency

    def cond(c: _Carry):
        return jnp.logical_and(~c.stop.converged, c.stop.iter < hard_cap)

    def body(c: _Carry):
        u = ops.precond(c.r)
        w = ops.matvec(u)
        # THE single fused reduction: shard-local partials of <r,u>, <w,u>,
        # ‖r‖₁ stacked into one (3,) allreduce (identity single-device,
        # one psum under shard_map)
        part = ops.allreduce(jnp.stack([
            jnp.sum(c.r * u), jnp.sum(w * u), jnp.sum(jnp.abs(c.r))]))
        gamma, delta, absr = part[0], part[1], part[2]
        st = stopping.check_from_norm(cfg, c.stop, absr)
        first = st.iter == 0
        zero = jnp.asarray(0.0, dtype)
        beta = jnp.where(first, zero, gamma / c.gamma_old)
        denom = jnp.where(first, delta, delta - beta * gamma / c.alpha_old)
        # branchless convergence freeze (see cg.py): alpha := 0 on the one
        # iteration where converged flips keeps x/r bitwise intact; the
        # while cond exits next.  alpha_old is frozen too so the dead
        # iteration cannot divide by zero.
        alpha = jnp.where(st.converged, zero, gamma / denom)
        p = u + beta * c.p
        s = w + beta * c.s
        return _Carry(
            x=c.x + alpha * p,
            r=c.r - alpha * s,
            p=p,
            s=s,
            gamma_old=jnp.where(st.converged, c.gamma_old, gamma),
            alpha_old=jnp.where(st.converged, c.alpha_old, alpha),
            stop=st.replace(iter=st.iter + jnp.where(st.converged, 0, 1)),
        )

    out = jax.lax.while_loop(cond, body, init)
    return SolveResult(
        x=out.x,
        iters=out.stop.iter,
        init_res_norm=out.stop.init_res_norm,
        final_res_norm=out.stop.res_norm,
        converged=stopping.satisfied(cfg, out.stop),
        history=out.stop.history,
    )
