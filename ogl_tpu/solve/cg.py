"""Preconditioned conjugate gradients as a `lax.while_loop`.

Replacement for `gko::solver::Cg` as driven by GKOCG
(reference Solver/CG/GKOCG.H:45-61): classical PCG recurrences with the
OpenFOAM stopping criterion evaluated on-device before each update, so the
whole solve is a single compiled program with no host syncs.

Reduction grouping (distributed latency): ‖r‖₁ (criterion) and
rho = <r,z> both depend only on the carried state, so their shard-local
partials fuse into ONE psum; <p,Ap> is the second and last collective
barrier of an iteration.  Arithmetic identical to separate reductions —
iterates and iteration counts unchanged.  (The Chronopoulos–Gear variant
in solve/cg_pipe.py goes further to a single barrier by rearranging the
recurrences; this classical body keeps the textbook PCG data flow.)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ogl_tpu.config import StoppingConfig
from ogl_tpu.solve import stopping
from ogl_tpu.solve.krylov import Ops

__all__ = ["cg", "SolveResult"]


class SolveResult(NamedTuple):
    x: Any
    iters: Any  # number of solver updates performed
    init_res_norm: Any
    final_res_norm: Any  # residual at last criterion check (OpenFOAM semantics)
    converged: Any
    history: Any = None  # per-iteration residuals when requested (export)


class _CgCarry(NamedTuple):
    x: Any
    r: Any
    p: Any
    rho_old: Any
    stop: stopping.StopState


def cg(ops: Ops, b, x0, cfg: StoppingConfig, history_len: int = 0) -> SolveResult:
    dtype = b.dtype
    x0 = jnp.asarray(x0, dtype)
    r0 = b - ops.matvec(x0)

    nf = stopping.initial_norm_factor(ops, r0, x0, b)
    init = _CgCarry(
        x=x0,
        r=r0,
        p=jnp.zeros_like(b),
        rho_old=jnp.asarray(1.0, dtype),
        stop=stopping.init_state(dtype, history_len).replace(norm_factor=nf),
    )

    # hard termination guard: gating can defer the maxIter check by at most
    # one frequency window (same overrun the reference's host check has)
    hard_cap = cfg.max_iter + cfg.frequency

    def cond(c: _CgCarry):
        return jnp.logical_and(~c.stop.converged, c.stop.iter < hard_cap)

    def body(c: _CgCarry):
        # fused reduction group: criterion ‖r‖₁ + rho = <r,z> — one psum
        z = ops.precond(c.r)
        part = ops.allreduce(jnp.stack(
            [jnp.sum(jnp.abs(c.r)), jnp.sum(c.r * z)]))
        absr, rho = part[0], part[1]
        st = stopping.check_from_norm(cfg, c.stop, absr)
        # branchless: a lax.cond here copies the whole vector carry through
        # both branches every iteration (measured ~2.6x on the fused path).
        # On the single iteration where converged flips, alpha:=0 freezes
        # x and r; p/rho_old drift but are dead — the while cond exits next.
        beta = jnp.where(st.iter == 0, jnp.asarray(0.0, dtype), rho / c.rho_old)
        p = z + beta * c.p
        q = ops.matvec(p)
        alpha = jnp.where(
            st.converged, jnp.asarray(0.0, dtype), rho / ops.dot(p, q))
        return _CgCarry(
            x=c.x + alpha * p,
            r=c.r - alpha * q,
            p=p,
            rho_old=rho,
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
