"""basisPrecision bfloat16: GMRES stores the Krylov
basis V at bf16 while H, the Givens chain, dots and x stay full precision.

Accuracy argument: x accumulates across restart cycles in full precision,
each cycle's bf16 recombination error shrinks with that cycle's correction
(defect correction), and the materialised OpenFOAM criterion always
evaluates the TRUE residual — so there is no false convergence, only
(slightly) more iterations.  A memory-traffic lever; no reference
analogue (Ginkgo's Gmres stores the basis at solver precision)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import foam, registry
from ogl_tpu import testing as problems
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels import spmv
from ogl_tpu.solve import gmres
from ogl_tpu.solve.krylov import single_device_ops


@pytest.fixture(autouse=True)
def _clear():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _system(dims=(10, 9), seed=2):
    """All-f32 system (the basisPrecision lever targets the f32 route)."""
    m = problems.poisson_ldu(dims)
    a = problems.poisson_dense(dims).astype(np.float32)
    rng = np.random.default_rng(seed)
    x_true = rng.normal(size=m.n).astype(np.float32)
    b = jnp.asarray(a @ x_true, jnp.float32)
    mat = formats.cast_values(
        formats.coo_to_csr(ldu.ldu_to_coo(m)), jnp.float32)
    return m, mat, a, b, x_true


def test_bf16_basis_converges_to_true_tolerance():
    _, mat, a, b, x_true = _system()
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=1e-6, rel_tol=0.0, max_iter=500)
    res = gmres(ops, b, jnp.zeros_like(b), cfg, krylov_dim=30,
                basis_dtype=jnp.bfloat16)
    assert bool(res.converged)
    # the reported convergence must hold against the TRUE residual — the
    # bf16 basis must not produce false convergence
    r = np.asarray(b, np.float64) - a.astype(np.float64) @ np.asarray(
        res.x, np.float64)
    nf = np.abs(np.asarray(b)).sum()
    assert np.abs(r).sum() / nf < 2e-6


def test_iteration_parity_in_the_relTol_regime():
    """Iteration counts within ±2 of the f32 basis.  The attainable
    in-cycle reduction of a bf16-stored basis is ~eps_bf16 (~2.4 decades)
    relative to the cycle-start residual, so parity holds exactly in the
    regime OpenFOAM actually runs GMRES in — relTol 1e-2..1e-3 per
    time-step solve (one to two decades)."""
    _, mat, a, b, _ = _system(seed=5)
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=1e-20, rel_tol=1e-2, max_iter=500)
    it32 = int(gmres(ops, b, jnp.zeros_like(b), cfg, krylov_dim=30).iters)
    it16 = int(gmres(ops, b, jnp.zeros_like(b), cfg, krylov_dim=30,
                     basis_dtype=jnp.bfloat16).iters)
    assert abs(it16 - it32) <= 2, (it16, it32)


def test_deep_reduction_bounded_penalty():
    """Beyond ~2.4 decades a bf16 basis must restart (the representation
    floor is proportional to the cycle-start residual), so a 6-decade
    solve pays extra cycles.  The stagnation-triggered restart bounds the
    waste: total iterations stay within ~2x of the f32 basis — and each
    iteration moves half the HBM bytes."""
    _, mat, a, b, _ = _system(seed=5)
    ops = single_device_ops(spmv.matvec(mat), b.shape[0])
    cfg = StoppingConfig(tolerance=1e-6, rel_tol=0.0, max_iter=500)
    r32 = gmres(ops, b, jnp.zeros_like(b), cfg, krylov_dim=30)
    r16 = gmres(ops, b, jnp.zeros_like(b), cfg, krylov_dim=30,
                basis_dtype=jnp.bfloat16)
    assert bool(r16.converged)
    it32, it16 = int(r32.iters), int(r16.iters)
    assert it16 <= 2.2 * it32 + 4, (it16, it32)
    # no false convergence: the reported final residual is a TRUE residual
    r = np.asarray(b, np.float64) - a.astype(np.float64) @ np.asarray(
        r16.x, np.float64)
    assert np.abs(r).sum() / np.abs(np.asarray(b)).sum() < 2e-6


def test_foam_front_end_key():
    """`basisPrecision bfloat16` through the fvSolution-dict front end.

    Iteration parity is asserted in the relTol regime (the one OpenFOAM
    actually runs per-time-step GMRES in); the deep absolute solve asserts
    true-residual accuracy with the bounded restart penalty instead."""
    m = problems.poisson_ldu((9, 8, 4))
    rng = np.random.default_rng(0)
    b = rng.normal(size=m.n).astype(np.float32)
    rel = {"solver": "GKOGMRES", "tolerance": 1e-20, "relTol": 1e-2,
           "maxIter": 1000, "krylovDim": 30}
    _, q32 = foam.solve("r32", m, b, rel)
    registry.global_registry.clear()
    _, q16 = foam.solve("r16", m, b, {**rel, "basisPrecision": "bfloat16"})
    assert q16.converged and q32.converged
    assert abs(q16.n_iterations - q32.n_iterations) <= 2
    registry.global_registry.clear()

    base = {"solver": "GKOGMRES", "tolerance": 1e-7, "relTol": 0.0,
            "maxIter": 1000, "krylovDim": 30}
    x32, p32 = foam.solve("g32", m, b, base)
    registry.global_registry.clear()
    x16, p16 = foam.solve("g16", m, b,
                          {**base, "basisPrecision": "bfloat16"})
    assert p16.converged and p32.converged
    assert p16.n_iterations <= 2.2 * p32.n_iterations + 4
    # both satisfy the OpenFOAM criterion against the exact operator
    coo = ldu.ldu_to_coo_host(m, dtype=np.float64)
    import scipy.sparse as sp

    a64 = sp.csr_matrix((np.asarray(coo.vals),
                         (np.asarray(coo.rows), np.asarray(coo.cols))),
                        shape=coo.shape)
    for x in (x16, x32):
        res = np.abs(b - a64 @ np.asarray(x, np.float64)).sum()
        assert res / np.abs(b).sum() < 1e-6


def test_f64_ignores_basis_precision():
    """basisPrecision only applies at f32; the f64 route keeps a full-width
    basis rather than silently quantising doubles."""
    m = problems.poisson_ldu((8, 7))
    rng = np.random.default_rng(1)
    b = rng.normal(size=m.n)
    x, perf = foam.solve("g64", m, b,
                         {"solver": "GKOGMRES", "tolerance": 1e-9,
                          "relTol": 0.0, "maxIter": 1000, "krylovDim": 30,
                          "dtype": "float64",
                          "basisPrecision": "bfloat16"})
    assert perf.converged
    coo = ldu.ldu_to_coo_host(m, dtype=np.float64)
    import scipy.sparse as sp

    a64 = sp.csr_matrix((np.asarray(coo.vals),
                         (np.asarray(coo.rows), np.asarray(coo.cols))),
                        shape=coo.shape)
    res = np.abs(b - a64 @ np.asarray(x, np.float64)).sum()
    assert res / np.abs(b).sum() < 1e-8


def test_dist_gmres_bf16_basis():
    """Distributed GMRES + Schwarz with the bf16 basis on the CPU mesh."""
    import jax

    if jax.device_count() < 2:
        pytest.skip("needs a multi-device mesh")
    m = problems.poisson_ldu((12, 10))
    rng = np.random.default_rng(3)
    b = rng.normal(size=m.n).astype(np.float32)
    base = {"solver": "GKOGMRES", "tolerance": 1e-7, "relTol": 0.0,
            "maxIter": 1000, "krylovDim": 30,
            "preconditioner": "BJ"}
    x32, p32 = foam.solve_distributed("dg32", m, b, base)
    registry.global_registry.clear()
    x16, p16 = foam.solve_distributed(
        "dg16", m, b, {**base, "basisPrecision": "bfloat16"})
    assert p16.converged and p32.converged
    # deep absolute solve: restarted iteration counts are not comparable
    # iteration-for-iteration (the f32 run pays full 30-cycles of its own);
    # assert the bounded-penalty envelope and solution agreement instead
    assert p16.n_iterations <= 2.2 * p32.n_iterations + 4
    np.testing.assert_allclose(np.asarray(x16), np.asarray(x32),
                               atol=5e-4, rtol=0)


def test_ill_conditioned_no_restart_pathology():
    """The restart heuristics (8-iter window, 0.7
    ratio, 8x slack) were tuned on well-behaved operators; an
    ill-conditioned case must not restart pathologically (which would
    inflate iterations unboundedly and regress silently).  1000:1
    anisotropic diffusion: bf16 basis must converge within ~3x the f32
    basis' iterations and deliver the same solution accuracy class."""
    import dataclasses

    import scipy.sparse as sp

    m = problems.poisson_ldu((20, 20))
    la, ua = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    horiz = (ua - la) == 1
    upper = np.where(horiz, m.upper * 1000.0, m.upper)
    diag = np.ones(m.n)
    np.add.at(diag, la, np.abs(upper))
    np.add.at(diag, ua, np.abs(upper))
    m = dataclasses.replace(m, upper=upper.astype(m.upper.dtype),
                            diag=diag.astype(m.diag.dtype))
    rng = np.random.default_rng(9)
    b = rng.normal(size=m.n).astype(np.float32)
    coo = ldu.ldu_to_coo_host(m, dtype=np.float64)
    a = sp.csr_matrix((np.asarray(coo.vals),
                       (np.asarray(coo.rows), np.asarray(coo.cols))),
                      shape=coo.shape)
    counts = {}
    res_true = {}
    for tag, extra in (("f32", {}), ("bf16", {"basisPrecision": "bfloat16"})):
        registry.global_registry.clear()
        x, perf = foam.solve(
            f"ill_{tag}", m, b,
            {"solver": "GKOGMRES", "tolerance": 1e-4, "relTol": 0.0,
             "maxIter": 4000, "krylovDim": 60,
             "preconditioner": {"preconditioner": "GISAI",
                                "sparsityPower": 1}, **extra})
        assert perf.converged, (tag, perf)
        counts[tag] = perf.n_iterations
        res_true[tag] = float(
            np.abs(b - a @ np.asarray(x, np.float64)).sum()
            / np.abs(b).sum())
    print("ill-conditioned GMRES bf16 basis:", counts, res_true)
    # BOUNDED, not fast: the near-floor gate on the stagnation restart
    # stops the runaway re-cycling (1516 iters before the gate, ~650
    # after), but bf16 subspace quality is intrinsically weaker on
    # ill-conditioned operators — expect ~5-7x the f32-basis iterations
    # here, i.e. a net wall REGRESSION.  The mode is opt-in; the docs
    # steer users away from it for strongly anisotropic systems.
    assert counts["bf16"] <= 8 * counts["f32"] + 20, counts
    assert res_true["bf16"] < 10 * max(res_true["f32"], 1e-9), res_true
