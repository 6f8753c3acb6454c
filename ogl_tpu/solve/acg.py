"""Coupled-matrix CG — multi-RHS PCG for LduMatrix<vector,scalar,scalar>
systems (reference LduMatrix/GKOACG/GKOACG.H: scalar coefficients shared by
all components, a vector field — i.e. one operator, nc right-hand sides,
solved by gko::solver::Cg on the nc-column multivector).

The reference ships GKOACG excluded from the build and its coupled
HostMatrix constructor aborts (HostMatrix.C:153-156, CMakeLists.txt:174);
this is a working realisation of that surface: per-column CG recurrences
vectorised over the component axis, per-component OpenFOAM stopping
criterion, converged
components frozen exactly like Ginkgo's stopped-column semantics.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ogl_tpu.solve import stopping

__all__ = ["cg_coupled", "CoupledResult"]


class CoupledResult(NamedTuple):
    X: Any  # (n, nc)
    iters: Any  # (nc,) iteration count per component
    init_res_norm: Any  # (nc,)
    final_res_norm: Any  # (nc,)
    converged: Any  # (nc,) bool


class _Carry(NamedTuple):
    X: Any
    R: Any
    P: Any
    rho_old: Any  # (nc,)
    it: Any
    done: Any  # (nc,) bool — component frozen
    iters_at: Any  # (nc,) iteration at which the component converged
    init_rn: Any
    rn: Any  # (nc,) residual at last fired check


def cg_coupled(mv, B, X0, cfg, precond=None) -> CoupledResult:
    """mv: (n,) -> (n,) scalar-operator SpMV; B, X0: (n, nc); cfg:
    StoppingParams; precond: optional SINGLE-component r -> M^-1 r (the
    same scalar M applied per component, the reference's BJ option).

    Internal layout is (nc, n) — components as ROWS: an (n, nc) block with
    nc ~ 3 puts 3 useful lanes in every (8, 128) tile (~42x padded
    traffic/ALU), and every per-component kernel launch needs an X[:, c]
    column extract, which is a full relayout pass.  Row-major components
    make elementwise recurrences dense and component slices contiguous
    (measured ~4.1 -> ~0.5 ms/iter at 1M x 3).  The API stays (n, nc) —
    one transpose in, one out."""
    dtype = B.dtype
    n, nc = B.shape

    def mvm(X):  # X: (nc, n)
        # static unroll over the (few) components: nc separate SpMVs
        return jnp.stack([mv(X[c]) for c in range(nc)], axis=0)

    pc = (lambda R: R) if precond is None else (
        lambda R: jnp.stack([precond(R[c]) for c in range(nc)], axis=0))

    Bc = jnp.asarray(B, dtype).T
    X0 = jnp.asarray(X0, dtype).T  # (nc, n)
    R0 = Bc - mvm(X0)

    # per-component OpenFOAM norm factor (StoppingCriterion.C:32-69)
    xavg = jnp.mean(X0, axis=1)  # (nc,)
    axref = mvm(jnp.broadcast_to(xavg[:, None], (nc, n)))
    b_sub = Bc - axref
    nf = jnp.sum(jnp.abs(R0 - b_sub) + jnp.abs(b_sub), axis=1) + stopping.small_of(dtype)
    rn0 = jnp.sum(jnp.abs(R0), axis=1) / nf
    hit0 = (rn0 < cfg.tolerance) | jnp.logical_and(
        cfg.rel_tol > 0, rn0 < cfg.rel_tol * rn0)

    hard_cap = cfg.max_iter + cfg.frequency
    zero_it = jnp.zeros((nc,), jnp.int32)

    init = _Carry(
        X=X0, R=R0, P=jnp.zeros_like(Bc),
        rho_old=jnp.ones((nc,), dtype),
        it=jnp.asarray(0, jnp.int32),
        done=hit0, iters_at=zero_it,
        init_rn=rn0, rn=rn0,
    )

    def cond(c: _Carry):
        return jnp.logical_and(~jnp.all(c.done), c.it < hard_cap)

    def body(c: _Carry):
        # criterion gate (StoppingCriterion.C:77-87), shared minIter/freq.
        # Branchless (see solve/cg.py): the check reduction is cheap next
        # to the matvec, and lax.cond would copy the (n, nc) carry blocks
        # through both branches every iteration.
        fire = stopping.would_check(cfg, c.it)
        rn_now = jnp.sum(jnp.abs(c.R), axis=1) / nf
        hit = (rn_now < cfg.tolerance) | jnp.logical_and(
            cfg.rel_tol > 0, rn_now < cfg.rel_tol * c.init_rn)
        hit = (hit | (c.it >= cfg.max_iter)) & fire
        newly = hit & ~c.done
        c = c._replace(
            rn=jnp.where(fire, rn_now, c.rn),
            done=c.done | hit,
            iters_at=jnp.where(newly, c.it, c.iters_at),
        )

        # per-component freezing is already mask-based (`live`); running the
        # update on the all-done exit iteration changes nothing reported
        live = (~c.done).astype(dtype)[:, None]  # (nc, 1)
        Z = pc(c.R)
        rho = jnp.sum(c.R * Z, axis=1)
        beta = jnp.where(c.it == 0, jnp.zeros((nc,), dtype), rho / c.rho_old)
        P = jnp.where(c.done[:, None], c.P, Z + beta[:, None] * c.P)
        Q = mvm(P)
        delta = jnp.sum(P * Q, axis=1)
        alpha = (rho / jnp.where(delta == 0, 1.0, delta))[:, None] * live
        return c._replace(
            X=c.X + alpha * P,
            R=c.R - alpha * Q,
            P=P,
            rho_old=jnp.where(c.done, c.rho_old, rho),
            it=c.it + 1,
        )

    out = jax.lax.while_loop(cond, body, init)
    iters = jnp.where(out.done, out.iters_at, out.it)
    sat = (out.rn < cfg.tolerance) | jnp.logical_and(
        cfg.rel_tol > 0, out.rn < cfg.rel_tol * out.init_rn)
    return CoupledResult(
        X=out.X.T,  # back to the (n, nc) API layout
        iters=iters,
        init_res_norm=out.init_rn,
        final_res_norm=out.rn,
        converged=sat,
    )
