"""The solvers' XLA path (the one every device runs) against a float64
SciPy reference: the systems and controls the merged-kernel tests used,
now through `foam.solve` / `foam.solve_distributed` in float32.

Iterations are compared with the iteration at which SciPy's float64
iterate first meets the same OpenFOAM-normalised criterion; residuals are
re-evaluated in float64 on the host."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from jax.sharding import Mesh

from ogl_tpu import foam
from ogl_tpu import testing as problems
from ogl_tpu.core import ldu

TOL = 5e-5


def _csr(m):
    c = ldu.ldu_to_coo_host(m, dtype=np.float64)
    return sp.csr_matrix((np.asarray(c.vals), (np.asarray(c.rows),
                                               np.asarray(c.cols))),
                         shape=c.shape)


def _of_res(a, x, b):
    """OpenFOAM-normalised |b - Ax|_1 for a zero initial guess."""
    return float(np.abs(b - a @ x).sum() / (np.abs(b).sum() + 1e-15))


def _scipy_iters(method, a, b, tol):
    """(first iteration whose float64 iterate meets the criterion, the
    converged float64 solution)."""
    seen = []

    def count(xk):
        seen.append(_of_res(a, xk, b) < tol)

    method(a, b, rtol=1e-12, atol=0.0, maxiter=5000, callback=count)
    x_ref, info = method(a, b, rtol=1e-12, atol=0.0, maxiter=5000)
    assert info == 0
    return seen.index(True) + 1, x_ref


def _system(m, seed=0):
    a = _csr(m)
    x_true = np.random.default_rng(seed).normal(size=m.n)
    return a, a @ x_true


def _check(a, b, x, perf, it_ref, x_ref, frac=0.1, slack=2):
    assert perf.converged, perf
    x = np.asarray(x, np.float64)
    assert _of_res(a, x, b) < 10 * TOL
    np.testing.assert_allclose(x, x_ref, atol=1e-2 * np.abs(x_ref).max())
    if it_ref is not None:
        assert abs(perf.n_iterations - it_ref) <= max(slack, frac * it_ref), (
            perf.n_iterations, it_ref)


BASE = {"tolerance": TOL, "relTol": 0.0, "maxIter": 2000,
        "adaptMinIter": False, "executor": "reference"}


@pytest.mark.parametrize("fmt", ["Coo", "Dia"])
@pytest.mark.parametrize("dims", [(128, 8), (96, 11), (16, 12, 6)])
def test_cg_f32_matches_scipy(dims, fmt):
    m = problems.poisson_ldu(dims)
    a, b = _system(m)
    it_ref, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve("p", m, b, {**BASE, "matrixFormat": fmt})
    _check(a, b, x, perf, it_ref, x_ref)


@pytest.mark.parametrize("dims", [(128, 8), (96, 11), (16, 12, 6)])
def test_pipelined_cg_f32_matches_scipy(dims):
    m = problems.poisson_ldu(dims)
    a, b = _system(m)
    it_ref, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve("p", m, b, {**BASE, "matrixFormat": "Dia",
                                      "pipelinedCG": True})
    _check(a, b, x, perf, it_ref, x_ref)


@pytest.mark.parametrize("block", [1, 4])
def test_jacobi_cg_f32_converges(block):
    m = problems.poisson_ldu((128, 8))
    a, b = _system(m)
    _, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve("p", m, b, {
        **BASE, "matrixFormat": "Dia",
        "preconditioner": {"preconditioner": "BJ", "maxBlockSize": block}})
    _check(a, b, x, perf, None, x_ref)


@pytest.mark.parametrize("case", ["poisson", "convection"])
def test_bicgstab_f32_matches_scipy(case):
    m = (problems.poisson_ldu((128, 8)) if case == "poisson"
         else problems.convection_diffusion_ldu((64, 8), peclet=0.4))
    a, b = _system(m)
    it_ref, x_ref = _scipy_iters(spla.bicgstab, a, b, TOL)
    x, perf = foam.solve("p", m, b, {**BASE, "solver": "GKOBiCGStab",
                                      "matrixFormat": "Dia"})
    # BiCGStab's f32 trajectory drifts further from f64 than CG's
    _check(a, b, x, perf, it_ref, x_ref, frac=0.25)


@pytest.mark.parametrize("precision", ["default", "bfloat16"])
def test_ir_inner_cg_f32_converges(precision):
    m = problems.poisson_ldu((96, 11))
    a, b = _system(m)
    _, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve("p", m, b, {
        **BASE, "solver": "GKOIR", "matrixFormat": "Dia",
        "preconditioner": "BJ",
        "inner": {"tolerance": 1e-2, "maxIter": 300, "precision": precision}})
    _check(a, b, x, perf, None, x_ref)
    assert perf.n_iterations < 20  # each outer sweep gains ~2 decades


@pytest.mark.parametrize("aggregation", ["auto", "natural", "pgm"])
def test_amg_cg_f32_converges(aggregation):
    m = problems.poisson_ldu((32, 32, 4))
    a, b = _system(m)
    it_ref, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve("p", m, b, {
        **BASE, "matrixFormat": "Dia",
        "preconditioner": {"preconditioner": "Multigrid",
                           "aggregation": aggregation}})
    _check(a, b, x, perf, None, x_ref)
    assert perf.n_iterations < it_ref / 2, (perf.n_iterations, it_ref)


def test_steady_state_steps_track_scipy():
    """A first solve plus coefficient-changing steady steps: every step's
    solution matches SciPy's solve of that step's system."""
    m0 = problems.poisson_ldu((64, 16))
    x_true = np.random.default_rng(3).normal(size=m0.n)
    slv = foam.GKOCG("p", {**BASE, "matrixFormat": "Dia"})
    for k in range(3):
        mk = dataclasses.replace(m0, diag=np.asarray(m0.diag) * (1 + 0.01 * k))
        a = _csr(mk)
        b = a @ x_true
        it_ref, x_ref = _scipy_iters(spla.cg, a, b, TOL)
        x, perf = slv.solve(mk, b)
        _check(a, b, x, perf, it_ref, x_ref)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("decomposition", ["simple", "scotch"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_dist_cg_8_devices_matches_scipy(decomposition, pipelined):
    m = problems.poisson_ldu((64, 16))
    a, b = _system(m, seed=1)
    it_ref, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    x, perf = foam.solve_distributed("pd", m, b, {
        **BASE, "decomposition": decomposition, "pipelinedCG": pipelined},
        mesh=_mesh(8))
    assert perf.solver_name.endswith("dist8")
    _check(a, b, x, perf, it_ref, x_ref)


def test_dist_cg_8_devices_jacobi_matches_single_device():
    m = problems.poisson_ldu((32, 32))
    a, b = _system(m, seed=2)
    ctl = {**BASE, "preconditioner": "BJ"}
    xd, pd = foam.solve_distributed("pj", m, b, ctl, mesh=_mesh(8))
    x1, p1 = foam.solve("pj1", m, b, ctl)
    assert abs(pd.n_iterations - p1.n_iterations) <= 2
    _, x_ref = _scipy_iters(spla.cg, a, b, TOL)
    _check(a, b, xd, pd, None, x_ref)
