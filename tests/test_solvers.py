"""Krylov solver tests: convergence on SPD Poisson systems, OpenFOAM
stopping-criterion semantics (norm factor, minIter/frequency gating,
relTol), solver cross-consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import testing as problems
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels import spmv
from ogl_tpu.solve import bicgstab, cg, gmres, ir
from ogl_tpu.solve import stopping
from ogl_tpu.solve.krylov import single_device_ops


def _setup(dims=(8, 8), fmt=formats.coo_to_csr, rng_seed=3):
    m = problems.poisson_ldu(dims)
    a = problems.poisson_dense(dims)
    mat = fmt(ldu.ldu_to_coo(m))
    rng = np.random.default_rng(rng_seed)
    x_true = rng.normal(size=m.n)
    b = jnp.asarray(a @ x_true)
    return mat, a, b, x_true


TOL = StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=500)


@pytest.mark.parametrize(
    "solver,kwargs",
    [(cg, {}), (bicgstab, {}), (gmres, {"krylov_dim": 30}), (ir, {"relaxation": 0.2})],
)
def test_solvers_converge_poisson(solver, kwargs):
    mat, a, b, x_true = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = TOL if solver is not ir else StoppingConfig(tolerance=1e-8, rel_tol=0.0, max_iter=5000)
    res = solver(ops, b, jnp.zeros_like(b), cfg, **kwargs)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    # final residual (as reported) consistent with the true residual
    r = b - jnp.asarray(a) @ res.x
    assert float(jnp.abs(r).sum()) < 1e-7 * float(jnp.abs(b).sum()) + 1e-7


def test_norm_factor_matches_openfoam_definition():
    mat, a, b, _ = _setup()
    n = b.shape[0]
    ops = single_device_ops(spmv.matvec(mat), n)
    x0 = jnp.zeros_like(b)
    r0 = b - jnp.asarray(a) @ x0
    st = stopping.check(ops, TOL, stopping.init_state(b.dtype), r0, x0, b)
    # manual: xavg = mean(x0)=0 -> Axref = 0; nf = || |r-(b-Axref)| + |b-Axref| ||_1 + SMALL
    axref = a @ np.zeros(n)
    b_np = np.asarray(b)
    nf_manual = (
        np.abs(np.asarray(r0) - (b_np - axref)) + np.abs(b_np - axref)
    ).sum() + stopping.small_of(b.dtype)
    np.testing.assert_allclose(float(st.norm_factor), nf_manual, rtol=1e-12)
    np.testing.assert_allclose(
        float(st.init_res_norm), np.abs(np.asarray(r0)).sum() / nf_manual, rtol=1e-12
    )


def test_min_iter_enforced():
    mat, _, b, _ = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    # huge tolerance: converges at the iter-0 check (the reference gate is
    # iter>0, so the very first check always fires)
    cfg = StoppingConfig(tolerance=1e30, rel_tol=0.0, min_iter=7, max_iter=100)
    res = cg(ops, b, jnp.zeros_like(b), cfg)
    assert int(res.iters) == 0


def test_min_iter_after_first_check():
    mat, _, b, _ = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    # tolerance reached after a few iters, but minIter=20 defers convergence
    cfg = StoppingConfig(tolerance=1e-8, rel_tol=0.0, min_iter=20, max_iter=100)
    res = cg(ops, b, jnp.zeros_like(b), cfg)
    assert int(res.iters) >= 20


def test_frequency_gating():
    mat, _, b, _ = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=500, frequency=10)
    res = cg(ops, b, jnp.zeros_like(b), cfg)
    assert bool(res.converged)
    assert int(res.iters) % 10 == 0  # can only stop on a check iteration


def test_max_iter_cap():
    mat, _, b, _ = _setup((16, 16))
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=1e-30, rel_tol=0.0, max_iter=5)
    res = cg(ops, b, jnp.zeros_like(b), cfg)
    assert int(res.iters) == 5  # maxIter stops the loop (reference :124)
    # ... but a solve that merely ran out of iterations is NOT converged
    # (OpenFOAM solverPerformance checkConvergence semantics)
    assert not bool(res.converged)


def test_rel_tol():
    mat, a, b, _ = _setup((12, 12))
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=0.0, rel_tol=1e-4, max_iter=500)
    res = cg(ops, b, jnp.zeros_like(b), cfg)
    assert bool(res.converged)
    assert float(res.final_res_norm) < 1e-4 * float(res.init_res_norm)
    assert int(res.iters) < 100


def test_adapt_min_iter_policy():
    cfg = StoppingConfig(adapt_min_iter=True, relaxation_factor=0.6, norm_eval_limit=100)
    adapted = cfg.adapted(prev_solve_iters=100, prev_rel_cost=0.4, export_res=False)
    assert adapted.min_iter == 60
    alpha = (1.0 / (100 * 0.4) * 0.4) ** 0.5  # sqrt(1/(iters*(1-relax)) * cost)
    assert adapted.frequency == min(100, max(1, int(1 / alpha)))
    # export mode disables adaptation (reference :201)
    same = cfg.adapted(100, 0.4, export_res=True)
    assert same.min_iter == cfg.min_iter and same.frequency == cfg.frequency


def test_gmres_nonsymmetric():
    # convection-diffusion (non-symmetric): GMRES + BiCGStab must converge
    rng = np.random.default_rng(0)
    n = 64
    a = np.diag(np.full(n, 3.0)) + np.diag(np.full(n - 1, -2.0), -1) + np.diag(
        np.full(n - 1, -0.5), 1
    )
    coo = formats.coo_from_dense(a)
    x_true = rng.normal(size=n)
    b = jnp.asarray(a @ x_true)
    ops = single_device_ops(spmv.matvec(coo), n)
    cfg = StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=300)
    for solver, kw in [(gmres, {"krylov_dim": 40}), (bicgstab, {})]:
        res = solver(ops, b, jnp.zeros_like(b), cfg, **kw)
        assert bool(res.converged), solver.__name__
        np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


def test_solve_is_jittable():
    mat, _, b, x_true = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    fn = jax.jit(lambda b: cg(ops, b, jnp.zeros_like(b), TOL))
    res = fn(b)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


def test_nonzero_initial_guess():
    mat, a, b, x_true = _setup()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    x0 = jnp.asarray(x_true + 0.01 * np.random.default_rng(1).normal(size=b.shape[0]))
    res = cg(ops, b, x0, TOL)
    assert bool(res.converged)
    assert int(res.iters) < 40  # warm start must help
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


def test_iteration_parity_across_precisions():
    """BASELINE.md metric 3: iteration parity between the 'reference
    executor' setting (float64, the reference CI's CPU fallback) and the
    float32 device path — same system, same criterion."""
    mat64, a, b64, _ = _setup((16, 16))
    ops64 = single_device_ops(spmv.matvec(mat64), b64.shape[0])
    cfg = StoppingConfig(tolerance=1e-6, rel_tol=0.0, max_iter=500)
    r64 = cg(ops64, b64, jnp.zeros_like(b64), cfg)

    mat32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        mat64,
    )
    b32 = jnp.asarray(b64, jnp.float32)
    ops32 = single_device_ops(spmv.matvec(mat32), b32.shape[0])
    r32 = cg(ops32, b32, jnp.zeros_like(b32), cfg)
    assert bool(r64.converged) and bool(r32.converged)
    assert abs(int(r64.iters) - int(r32.iters)) <= 2


def test_pipelined_cg_matches_classical():
    """Single-reduction (Chronopoulos–Gear) CG: identical iterates in exact
    arithmetic, so the iteration count must match classical CG to rounding
    order, on the same OpenFOAM criterion (solve/cg_pipe.py)."""
    from ogl_tpu.solve.cg_pipe import cg_pipelined

    mat, a, b, x_true = _setup((16, 16))
    n = b.shape[0]
    cfg = StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=500)

    ops = single_device_ops(spmv.matvec(mat), n)
    ref = cg(ops, b, jnp.zeros_like(b), cfg)
    res = cg_pipelined(ops, b, jnp.zeros_like(b), cfg)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    assert abs(int(res.iters) - int(ref.iters)) <= 2, (int(res.iters), int(ref.iters))
    # criterion state agrees: same norm factor ⇒ same normalised residuals
    np.testing.assert_allclose(float(res.init_res_norm), float(ref.init_res_norm),
                               rtol=1e-10)


def test_pipelined_cg_preconditioned_and_gated():
    """Preconditioned variant (Jacobi) plus minIter/frequency gating: the
    gating semantics ride stopping.check_from_norm and must match the
    classical path's stopping.check decisions."""
    from ogl_tpu.solve.cg_pipe import cg_pipelined

    mat, a, b, x_true = _setup((16, 16))
    n = b.shape[0]
    diag = jnp.asarray(np.diag(a))
    pc = lambda r: r / diag
    cfg = StoppingConfig(tolerance=1e-9, rel_tol=0.0, max_iter=500,
                         min_iter=7, frequency=3)
    ops = single_device_ops(spmv.matvec(mat), n, precond=pc)
    ref = cg(ops, b, jnp.zeros_like(b), cfg)
    res = cg_pipelined(ops, b, jnp.zeros_like(b), cfg)
    assert bool(res.converged) and bool(ref.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    # both stop on a check iteration of the same gating grid
    assert int(res.iters) >= 7 and (int(res.iters) % 3 == 0 or int(res.iters) >= 500)
    assert abs(int(res.iters) - int(ref.iters)) <= 3, (int(res.iters), int(ref.iters))


def test_pipelined_cg_history_export():
    from ogl_tpu.solve.cg_pipe import cg_pipelined

    mat, a, b, _ = _setup((8, 8))
    cfg = StoppingConfig(tolerance=1e-8, rel_tol=0.0, max_iter=300)
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    res = cg_pipelined(ops, b, jnp.zeros_like(b), cfg, history_len=310)
    it = int(res.iters)
    h = np.asarray(res.history)
    assert h[0] == pytest.approx(float(res.init_res_norm))
    # monotone-ish decay recorded through the converged iteration
    assert h[it] <= 1e-8 or h[it] == 0.0
