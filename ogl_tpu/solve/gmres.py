"""Restarted GMRES as nested `lax.while_loop`s.

Replaces `gko::solver::Gmres` as driven by GKOGMRES
(reference Solver/GMRES/GKOGMRES.H).  Design choices:

  * The Krylov basis V is a dense (m+1, n) array, so every Arnoldi
    orthogonalisation streams blocked (B,n)×(n,) matmul pairs — vector
    work instead of m sequential dot kernels (SURVEY.md §7 "GMRES
    orthogonalisation without host syncs").  Blocked MODIFIED
    Gram-Schmidt, no re-orthogonalisation: MGS-GMRES is backward stable
    (Paige/Rozložník/Strakoš 2006) and matches the reference's Ginkgo
    GMRES.
  * Right preconditioning (solve A M⁻¹ u = b, x = x0 + M⁻¹ V y): the
    Arnoldi residual estimate equals the TRUE residual 2-norm, and the
    OpenFOAM criterion (1-norm + norm factor) is evaluated on a
    materialised residual only on iterations where the frequency/minIter
    gate fires — reproducing the reference's "residual evaluation is
    expensive, so adaptMinIter stretches the check frequency" cost model
    (StoppingCriterion.H:199-209, lduLduBase.H:287-293).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ogl_tpu.config import StoppingConfig
from ogl_tpu.solve import stopping
from ogl_tpu.solve.cg import SolveResult
from ogl_tpu.solve.krylov import Ops

__all__ = ["gmres"]

_BLOCK = 8  # basis rows per block in the blocked Arnoldi access


class _Inner(NamedTuple):
    V: Any  # (m+1, n) Krylov basis
    v: Any  # (n,) the newest basis row V[j] as a flat vector — a single
    # row of the tiled (mp, n) array occupies one sublane of every (8,128)
    # tile, so reading V[j] directly costs ~8x its bytes; the flat copy
    # makes the per-iteration A·M⁻¹·v_j read dense
    H: Any  # (m+1, m) Hessenberg
    cs: Any  # (m,) Givens cosines
    sn: Any  # (m,) Givens sines
    g: Any  # (m+1,) rotated rhs; |g[j+1]| = 2-norm residual estimate
    j: Any  # inner step
    stop: stopping.StopState
    stall: Any  # bool: reduced-precision basis hit its representation
    # floor this cycle -> end the cycle early and restart from the
    # materialised residual
    chk: Any  # |g[j]| at the last fired materialised check (drives the
    # claimed-progress check cadence for reduced-precision bases)
    pj: Any  # i32: j at the last stagnation-window mark
    pest: Any  # |g[pj]| — the estimate at that mark
    beta0: Any  # cycle-start residual 2-norm (the bf16 representation
    # floor for this cycle is ~eps_bf16 * beta0; the stagnation restart
    # only fires near it — see the near-floor gate in inner_body)


class _Outer(NamedTuple):
    x: Any
    stop: stopping.StopState


def _solve_y(H, g, j, m):
    """y = H[:j,:j]^{-1} g[:j] with static shapes: mask out columns >= j by
    putting 1 on the diagonal and 0 on the rhs (upper-triangular after the
    Givens rotations)."""
    idx = jnp.arange(m)
    active = idx < j
    Hm = jnp.where(active[None, :] & active[:, None], H[:m, :m], 0.0)
    Hm = Hm + jnp.diag(jnp.where(active, 0.0, 1.0).astype(H.dtype))
    gm = jnp.where(active, g[:m], 0.0)
    return jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)


def gmres(ops: Ops, b, x0, cfg: StoppingConfig, krylov_dim: int = 100,
          history_len: int = 0, basis_dtype=None) -> SolveResult:
    """basis_dtype (e.g. jnp.bfloat16) stores the Krylov basis V at reduced
    width while H, the Givens chain, dots, and x stay full precision — the
    basis stream IS the per-iteration cost at scale (~m·n·4 B/iter at f32),
    so bf16 halves the dominant HBM traffic.  Restarts keep accuracy: x
    accumulates in full precision across cycles, so the bf16 recombination
    error of ONE cycle's correction shrinks with the correction itself
    (defect-correction argument), and the materialised OpenFOAM criterion
    always evaluates the TRUE residual — no false convergence.  No
    reference analogue."""
    dtype = b.dtype
    bdtype = dtype if basis_dtype is None else jnp.dtype(basis_dtype)
    n = b.shape[0]
    m = krylov_dim
    x0 = jnp.asarray(x0, dtype)
    hard_cap = cfg.max_iter + cfg.frequency
    tiny = stopping.small_of(dtype) ** 2
    # basis rows are stored as (R, 128) tile planes: a row of a flat
    # (mp, n) array occupies one sublane of every (8,128) tile, making
    # the per-iteration row write/read an ~8x-traffic strided RMW.  The
    # 3-D layout keeps every row a dense run of whole tiles.
    R = -(-n // 128)
    npad = R * 128

    def _plane(v):  # (n,) -> (R, 128), zero-padded
        return jnp.pad(v, (0, npad - n)).reshape(R, 128)

    def x_at(x_restart, V, H, g, j):
        y = _solve_y(H, g, j, m)
        # blocked basis access: y is zero at positions >= j, so only the
        # leading ceil(j/B) blocks of V are streamed (a full y @ V[:m]
        # would read all m rows — 400 MB at m=100, n=1M — per check)
        B = _BLOCK
        y = jnp.pad(y, (0, V.shape[0] - m))  # align with V's padded rows
        nblk = (j + B - 1) // B

        def body(k, acc):
            vb = jax.lax.dynamic_slice_in_dim(V, k * B, B, axis=0)
            yb = jax.lax.dynamic_slice_in_dim(y, k * B, B, axis=0)
            return acc + jnp.einsum("b,brl->rl", yb, vb.astype(dtype),
                                    precision=jax.lax.Precision.HIGHEST)

        yV = jax.lax.fori_loop(0, nblk, body, jnp.zeros((R, 128), dtype))
        return x_restart + ops.precond(yV.reshape(-1)[:n])

    def inner_cond(c: _Inner):
        return jnp.logical_and(
            jnp.logical_and(c.j < m, ~c.stall),
            jnp.logical_and(~c.stop.converged, c.stop.iter < hard_cap),
        )

    def outer_body(o: _Outer):
        r = b - ops.matvec(o.x)
        beta = ops.norm2(r)
        mp = -(-(m + 1) // _BLOCK) * _BLOCK  # padded to block multiple
        V = jnp.zeros((mp, R, 128), bdtype).at[0].set(
            _plane(r / jnp.maximum(beta, tiny)).astype(bdtype))
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        init = _Inner(
            V=V,
            v=r / jnp.maximum(beta, tiny),
            H=jnp.zeros((m + 1, m), dtype),
            cs=jnp.zeros((m,), dtype),
            sn=jnp.zeros((m,), dtype),
            g=g,
            j=jnp.asarray(0, jnp.int32),
            stop=o.stop,
            stall=jnp.asarray(False),
            chk=beta,
            pj=jnp.asarray(0, jnp.int32),
            pest=beta,
            beta0=beta,
        )

        def inner_body(c: _Inner):
            # --- criterion check (materialise r only when the gate fires) ---
            def do_check(st):
                xj = x_at(o.x, c.V, c.H, c.g, c.j)
                rj = b - ops.matvec(xj)
                st2 = stopping.check(ops, cfg, st, rj, xj, b)
                if bdtype != jnp.dtype(dtype):
                    # stagnation-triggered restart (reduced-precision basis
                    # only): the attainable in-cycle reduction is bounded by
                    # the basis storage eps (~4e-3 at bf16) relative to the
                    # cycle-start residual; once the TRUE 2-norm sits far
                    # above the Givens estimate, further Arnoldi steps in
                    # this cycle are wasted — restart from the materialised
                    # residual instead (defect correction across cycles
                    # restores full-precision convergence).  8x slack keeps
                    # the healthy-cycle estimate (accurate to arithmetic
                    # eps) from ever firing this.
                    r2 = ops.norm2(rj)
                    stalled = jnp.logical_and(
                        ~st2.converged,
                        jnp.logical_and(c.j >= 2,
                                        r2 > 8.0 * jnp.abs(c.g[c.j])))
                else:
                    stalled = jnp.asarray(False)
                return st2, stalled

            fire = stopping.would_check(cfg, c.stop.iter)
            est2 = jnp.abs(c.g[c.j])
            if history_len == 0:
                # 2-norm pre-gate: with right preconditioning |g[j]| IS the
                # true residual 2-norm, and ‖r‖₁ ≥ ‖r‖₂, so the normalised
                # OpenFOAM residual is ≥ |g[j]|/nf — when that bound cannot
                # pass the tolerance, the expensive materialised check
                # (basis recombination + SpMV + 1-norm) provably cannot
                # fire and is skipped.  4x safety margin absorbs the tiny
                # numerical drift of the CGS2 estimate; a drift-affected
                # skip only defers detection to the next check.  Disabled
                # when a per-iteration residual history is exported.
                nf = c.stop.norm_factor
                could_hit = (est2 < 4.0 * cfg.tolerance * nf) | jnp.logical_and(
                    cfg.rel_tol > 0,
                    est2 < 4.0 * cfg.rel_tol * c.stop.init_res_norm * nf)
                if bdtype != jnp.dtype(dtype):
                    # reduced-precision basis: additionally materialise a
                    # TRUE-residual check every ~1.5 claimed decades (est2
                    # vs its value at the last fired check), so a cycle that
                    # hit the bf16 representation floor is detected within
                    # a bounded number of wasted Arnoldi steps rather than
                    # at the claimed convergence point.  ~4 extra checks per
                    # cycle, each ~one iteration's cost.
                    could_hit = could_hit | (est2 < 0.03 * c.chk)
                fire = fire & ((c.stop.iter == 0) | could_hit
                               | (c.stop.iter >= cfg.max_iter))
            st, stalled = jax.lax.cond(
                fire, do_check, lambda s: (s, jnp.asarray(False)), c.stop)
            chk = jnp.where(fire, est2, c.chk)
            pj, pest = c.pj, c.pest
            if bdtype != jnp.dtype(dtype):
                # estimate-stagnation restart: with single-pass MGS against
                # a bf16-stored basis the Givens estimate TRACKS the true
                # residual onto its representation floor (measured: both
                # plateau together from ~eps_bf16 reduction onward), so the
                # floor shows up as the free estimate failing to halve over
                # a window — no residual materialisation needed.  The
                # decoupled failure mode (estimate keeps claiming progress)
                # is covered by the ratio check in do_check above.  A
                # healthy f32 cycle that genuinely stagnates 8 iterations
                # would restart too — acceptable for the opt-in bf16 mode:
                # the restart preserves x and re-derives the true residual.
                window = (c.j - c.pj) >= 8
                # <30% estimate reduction in 8 Arnoldi steps — but ONLY
                # near the cycle's bf16 representation floor
                # (~eps_bf16 x the cycle-start residual, 32x slack).  An
                # ill-conditioned operator makes HEALTHY cycles reduce
                # slower than 30%/8 steps far above the floor; without
                # this gate the window heuristic restarted those cycles
                # over and over, discarding the Krylov subspace each time
                # (1516 vs 96 iterations at 1000:1 anisotropy — pinned by
                # tests/test_gmres_bf16_basis.py's ill-conditioned case)
                near_floor = est2 < (32.0 * float(jnp.finfo(bdtype).eps)
                                     * c.beta0)
                stagnant = jnp.logical_and(
                    jnp.logical_and(window, near_floor),
                    jnp.logical_and(est2 > 0.7 * c.pest, ~st.converged))
                stalled = stalled | stagnant
                pj = jnp.where(window, c.j, c.pj)
                pest = jnp.where(window, est2, c.pest)

            # BRANCHLESS update: wrapping the update in lax.cond would make
            # XLA copy the whole carry — V alone is m·n·4 bytes (416 MB at
            # m=100, n=1M), and that copy per iteration dominated the
            # steady state (~2.3 ms/iter fixed cost measured).  Instead the
            # Arnoldi step always runs and `live` freezes every output once
            # converged; the single extra post-convergence evaluation is
            # numerically inert (outputs discarded through the freeze).
            live = ~st.converged
            j = c.j
            # Arnoldi: w = A M^-1 v_j, orthogonalise vs V[:j+1] (MGS).
            # BLOCKED basis access: only the ceil((j+2)/B) leading
            # B-row blocks of V are read — a full-V masked matmul would
            # stream all m+1 rows every iteration (O(m·n) bytes) even
            # at j = 0.  Average traffic halves; early iterations cost
            # O(j·n).
            w = _plane(ops.matvec(ops.precond(c.v)))
            mp = c.V.shape[0]
            B = _BLOCK
            nblk = (j + 2 + B - 1) // B  # blocks covering rows 0..j+1
            mask = (jnp.arange(mp) <= j).astype(dtype)

            def mgs_pass(V, w):
                """Blocked MODIFIED Gram-Schmidt: each B-row block is
                projected out of w before the next block's dots, so the
                dots and the subtraction share ONE stream over the live
                basis prefix (CGS needed two, and its always-on second
                pass two more — 4x the traffic of this pass; the basis
                stream IS the GMRES iteration cost at 1M).  MGS is also
                what the reference's Ginkgo GMRES uses.  The per-block
                dots are allreduced, so every rank steps its collectives
                identically."""
                def body(k, carry):
                    w, h = carry
                    vb = jax.lax.dynamic_slice_in_dim(
                        V, k * B, B, axis=0).astype(dtype)
                    mb = jax.lax.dynamic_slice_in_dim(mask, k * B, B, axis=0)
                    hb = ops.allreduce(jnp.einsum(
                        "brl,rl->b", vb, w,
                        precision=jax.lax.Precision.HIGHEST)) * mb
                    return (w - jnp.einsum(
                        "b,brl->rl", hb, vb,
                        precision=jax.lax.Precision.HIGHEST),
                            jax.lax.dynamic_update_slice_in_dim(
                                h, hb, k * B, axis=0))
                return jax.lax.fori_loop(
                    0, nblk, body, (w, jnp.zeros((mp,), dtype)))

            # No re-orthogonalisation pass: MGS-GMRES is backward stable
            # without one (Paige, Rozložník & Strakoš, SIMAX 2006 — the
            # least-squares residual stays accurate even as the basis
            # loses orthogonality), and the reference's Ginkgo GMRES also
            # runs plain MGS.  A DGKS ω-test would fire on nearly every
            # Arnoldi step (the projection removes most of w's mass by
            # construction), doubling the dominant basis traffic for no
            # observed iteration change.
            w, h = mgs_pass(c.V, w)
            wnorm = ops.norm2(w.reshape(-1))
            h = h.at[j + 1].set(wnorm)
            vrow = jnp.where(live, w / jnp.maximum(wnorm, tiny),
                             c.V[j + 1].astype(dtype))
            # storage cast: V holds bdtype (bf16 when basisPrecision is
            # set); the RUNNING vector v below stays full precision
            V = c.V.at[j + 1].set(vrow.astype(bdtype))

            # apply previous Givens rotations to the new column.  The chain
            # (h[k], h[k+1]) <- rot_k is a first-order affine recurrence in
            # t_k := h[k]-before-rot_k (t_{k+1} = -sn_k t_k + cs_k h0[k+1]),
            # so the j sequential scalar steps of the naive fori_loop —
            # ~j tiny device ops per iteration — collapse into one
            # associative_scan over m affine maps.
            kidx = jnp.arange(m)
            live_rot = kidx < j
            sn_e = jnp.where(live_rot, c.sn, 0.0)
            cs_e = jnp.where(live_rot, c.cs, 1.0)
            a_seq = -sn_e
            b_seq = cs_e * h[1 : m + 1]

            def comb(l, r):
                return (l[0] * r[0], r[0] * l[1] + r[1])

            A, Bc = jax.lax.associative_scan(comb, (a_seq, b_seq))
            t = jnp.concatenate([h[:1], A * h[0] + Bc])  # t_k, k = 0..m
            h = jnp.where(
                jnp.arange(m + 1) < j,
                cs_e[jnp.minimum(jnp.arange(m + 1), m - 1)] * t
                + sn_e[jnp.minimum(jnp.arange(m + 1), m - 1)]
                * jnp.pad(h[1 : m + 1], (0, 1)),
                jnp.where(jnp.arange(m + 1) == j, t, h[: m + 1]))
            # new rotation annihilating h[j+1]
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            csj = jnp.where(denom > tiny, h[j] / jnp.maximum(denom, tiny), 1.0)
            snj = jnp.where(denom > tiny, h[j + 1] / jnp.maximum(denom, tiny), 0.0)
            h = h.at[j].set(csj * h[j] + snj * h[j + 1]).at[j + 1].set(0.0)
            g = c.g.at[j + 1].set(-snj * c.g[j]).at[j].set(csj * c.g[j])
            return _Inner(
                V=V,
                v=jnp.where(live, vrow.reshape(-1)[:n], c.v),
                H=jnp.where(live, c.H.at[:, j].set(h[: m + 1]), c.H),
                cs=jnp.where(live, c.cs.at[j].set(csj), c.cs),
                sn=jnp.where(live, c.sn.at[j].set(snj), c.sn),
                g=jnp.where(live, g, c.g),
                j=j + live.astype(j.dtype),
                stop=st.replace(iter=st.iter + live.astype(st.iter.dtype)),
                stall=stalled,
                chk=chk,
                pj=pj,
                pest=pest,
                beta0=c.beta0,
            )

        out = jax.lax.while_loop(inner_cond, inner_body, init)
        x = x_at(o.x, out.V, out.H, out.g, out.j)
        return _Outer(x=x, stop=out.stop)

    def outer_cond(o: _Outer):
        return jnp.logical_and(~o.stop.converged, o.stop.iter < hard_cap)

    out = jax.lax.while_loop(outer_cond, outer_body, _Outer(x=x0, stop=stopping.init_state(dtype, history_len)))
    # exact exit residual: checks may have been pre-gate-skipped, so the
    # carried res_norm can be stale — one materialised evaluation restores
    # reference-exact reporting (solverPerformance finalResidual)
    rn_fin = ops.norm1(b - ops.matvec(out.x)) / out.stop.norm_factor
    fin = out.stop.replace(res_norm=rn_fin)
    return SolveResult(
        x=out.x,
        iters=out.stop.iter,
        init_res_norm=out.stop.init_res_norm,
        final_res_norm=rn_fin,
        converged=stopping.satisfied(cfg, fin),
        history=out.stop.history,
    )
