"""f64 defect correction (foam/f64.py): accuracy vs scipy's f64 direct
solve, sweep behaviour, routing, and delta-upload reuse.

Reference parity target: GKOCG.H:45-61 serves OpenFOAM's double scalar
natively; this framework serves it via host-f64 outer + device-f32 inner."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ogl_tpu import foam, registry, testing
from ogl_tpu.config import parse_controls
from ogl_tpu.foam.f64 import F64DefectSolver, wants_host_f64


@pytest.fixture(autouse=True)
def _clear_registry():
    """The host-f64 route is the NON-x64-process configuration (a default
    process); the suite-wide conftest enables x64, so toggle it off
    here."""
    import jax

    registry.global_registry.clear()
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)
    registry.global_registry.clear()


def _poisson_case(dims=(12, 12, 8), seed=0):
    m = testing.poisson_ldu(dims)
    rng = np.random.default_rng(seed)
    b = rng.normal(size=m.n)
    return m, b


def _dense_f64(m):
    from ogl_tpu.core import ldu as ldu_mod

    coo = ldu_mod.ldu_to_coo_host(m, dtype=np.float64)
    return sp.csr_matrix(
        (np.asarray(coo.vals), (np.asarray(coo.rows), np.asarray(coo.cols))),
        shape=coo.shape)


def test_routing_without_x64():
    cfg = parse_controls({"solver": "GKOCG", "tolerance": 1e-8,
                          "dtype": "float64"})
    assert wants_host_f64(cfg)
    cfg32 = parse_controls({"solver": "GKOCG", "tolerance": 1e-8})
    assert not wants_host_f64(cfg32)


def test_f64_beats_f32_accuracy_floor():
    """The whole point: the defect-corrected solution reaches residual
    levels a pure-f32 solve cannot (f32 stagnates near 1e-7 relative)."""
    m, b = _poisson_case()
    a = _dense_f64(m)
    x_direct = spla.spsolve(a.tocsc(), b)

    x64, perf = foam.solve(
        "p64", m, b,
        {"solver": "GKOCG", "tolerance": 1e-13, "relTol": 0.0,
         "maxIter": 5000, "dtype": "float64"})
    assert isinstance(
        registry.global_registry.get_or_init("p64_solver", lambda: None),
        F64DefectSolver)
    x64 = np.asarray(x64, np.float64)
    assert perf.converged
    rel_err64 = np.abs(x64 - x_direct).max() / np.abs(x_direct).max()
    # f32 reference point: same solve at f32's own best tolerance
    x32, _ = foam.solve(
        "p32", m, b,
        {"solver": "GKOCG", "tolerance": 0.0, "relTol": 1e-7,
         "maxIter": 5000})
    rel_err32 = np.abs(np.asarray(x32, np.float64) - x_direct).max() / np.abs(x_direct).max()
    assert rel_err64 < 1e-10, f"f64 path only reached {rel_err64:.2e}"
    assert rel_err64 < rel_err32 * 1e-2, (
        f"f64 ({rel_err64:.2e}) not meaningfully beyond f32 ({rel_err32:.2e})")
    # true f64 residual, OpenFOAM-normalised, matches the reported one
    nf_res = np.sum(np.abs(b - a @ x64))
    assert perf.final_residual == pytest.approx(
        nf_res / (nf_res / perf.final_residual), rel=1e-9)


def test_sweeps_accumulate_digits():
    """Each sweep multiplies the residual by ~the inner relTol: the outer
    converges geometrically, in a handful of sweeps."""
    m, b = _poisson_case(seed=1)
    x, perf = foam.solve(
        "sweeps", m, b,
        {"solver": "GKOIR", "tolerance": 1e-12, "relTol": 0.0,
         "maxIter": 8000, "dtype": "float64",
         "inner": {"tolerance": 0.0, "relTol": 1e-4, "maxIter": 2000}})
    slv = registry.global_registry.get_or_init("sweeps_solver", lambda: None)
    assert perf.converged
    assert 2 <= slv.last_outer_sweeps <= 6
    a = _dense_f64(m)
    res = np.sum(np.abs(b - a @ np.asarray(x, np.float64)))
    x_direct = spla.spsolve(a.tocsc(), b)
    denom = np.sum(np.abs(b - a @ np.full_like(b, 0.0)))
    assert res / max(denom, 1e-30) < 1e-10


def test_host_operator_delta_reuse():
    """Unchanged coefficients must not rebuild the host CSR; the inner
    FoamSolver's delta machinery must skip the coefficient re-upload."""
    m, b = _poisson_case(seed=2)
    slv = F64DefectSolver("delta", parse_controls(
        {"solver": "GKOCG", "tolerance": 1e-11, "relTol": 0.0,
         "maxIter": 4000, "dtype": "float64"}))
    slv.solve(m, b)
    csr_first = slv._csr
    slv.solve(m, b * 1.5)  # new RHS, same operator
    assert slv._csr is csr_first, "host CSR rebuilt for unchanged operator"
    uploaded, _nb = slv.inner.last_blocks_uploaded
    assert uploaded == 0, f"inner re-uploaded {uploaded} unchanged blocks"
    # changed coefficients: the host CSR takes a data-only overwrite (same
    # object, row-major LDU order == CSR data order) and stays CORRECT
    import dataclasses

    m3 = dataclasses.replace(m, diag=m.diag * 1.25)
    x3, perf3 = slv.solve(m3, b)
    assert slv._csr is csr_first, "structure rebuilt for value-only change"
    a3 = _dense_f64(m3)
    res3 = np.sum(np.abs(b - a3 @ np.asarray(x3, np.float64)))
    assert perf3.converged and res3 / np.sum(np.abs(b)) < 1e-9


def test_scaling_invariance():
    """`scaling` multiplies A and b alike — the solution is invariant
    (lduLduBase.H:244-252 parity, f64 route)."""
    m, b = _poisson_case(seed=3)
    x1, _ = foam.solve("s1", m, b,
                       {"solver": "GKOCG", "tolerance": 1e-12, "relTol": 0.0,
                        "maxIter": 4000, "dtype": "float64"})
    x2, _ = foam.solve("s2", m, b,
                       {"solver": "GKOCG", "tolerance": 1e-12, "relTol": 0.0,
                        "maxIter": 4000, "dtype": "float64", "scaling": 3.0})
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                               rtol=1e-9, atol=1e-12)


def test_initial_guess_used():
    m, b = _poisson_case(seed=4)
    a = _dense_f64(m)
    x_direct = spla.spsolve(a.tocsc(), b)
    near = x_direct + 1e-6 * np.random.default_rng(5).normal(size=m.n)
    _, perf_cold = foam.solve(
        "guess_cold", m, b,
        {"solver": "GKOCG", "tolerance": 1e-11, "relTol": 0.0,
         "maxIter": 4000, "dtype": "float64", "updateInitGuess": True})
    _, perf_warm = foam.solve(
        "guess_warm", m, b,
        {"solver": "GKOCG", "tolerance": 1e-11, "relTol": 0.0,
         "maxIter": 4000, "dtype": "float64", "updateInitGuess": True},
        psi=near)
    assert perf_warm.n_iterations < perf_cold.n_iterations


def test_dist_f64_routes_through_defect_correction():
    """`dtype float64` through solve_distributed in
    a non-x64 process must NOT silently downcast — it routes to the
    host-f64 defect correction with a DISTRIBUTED f32 inner and reaches
    residual levels f32 cannot (reference: Ginkgo native double through
    the distributed path, GKOCG.H:45-61, CsrMatrixWrapper.H:163-210)."""
    m, b = _poisson_case(seed=6)
    a = _dense_f64(m)
    x_direct = spla.spsolve(a.tocsc(), b)
    x, perf = foam.solve_distributed(
        "pd64", m, b,
        {"solver": "GKOCG", "tolerance": 1e-13, "relTol": 0.0,
         "maxIter": 8000, "dtype": "float64"})
    slv = registry.global_registry.get_or_init("pd64_dist_solver",
                                               lambda: None)
    assert isinstance(slv, F64DefectSolver)
    from ogl_tpu.foam.dist_solver import DistFoamSolver

    assert isinstance(slv.inner, DistFoamSolver)
    assert perf.converged
    assert "f64defect" in perf.solver_name
    x = np.asarray(x, np.float64)
    rel_err = np.abs(x - x_direct).max() / np.abs(x_direct).max()
    assert rel_err < 1e-10, f"dist f64 route only reached {rel_err:.2e}"


def test_dist_f64_matches_single_device_f64():
    """The distributed and single-device f64 routes solve the same system
    to the same accuracy class."""
    m, b = _poisson_case(seed=7)
    controls = {"solver": "GKOCG", "tolerance": 1e-12, "relTol": 0.0,
                "maxIter": 8000, "dtype": "float64"}
    x1, p1 = foam.solve("cmp64", m, b, controls)
    x2, p2 = foam.solve_distributed("cmp64d", m, b, controls)
    assert p1.converged and p2.converged
    np.testing.assert_allclose(np.asarray(x1, np.float64),
                               np.asarray(x2, np.float64),
                               rtol=1e-8, atol=1e-11)


def test_naked_dist_solver_rejects_f64():
    """Constructing DistFoamSolver directly with dtype float64 in a
    non-x64 process fails LOUD instead of silently truncating to f32."""
    from ogl_tpu.foam.dist_solver import DistFoamSolver

    with pytest.raises(ValueError, match="float64"):
        DistFoamSolver("naked64", {"solver": "GKOCG", "dtype": "float64"})


def test_dist_f64_multiproc_shape_is_loud():
    """Per-rank system lists (the multi-process deployment shape) have no
    host-f64 route: the defect solver must say so, not downcast."""
    m, b = _poisson_case(seed=8)
    slv = F64DefectSolver("mp64", parse_controls(
        {"solver": "GKOCG", "tolerance": 1e-11, "relTol": 0.0,
         "maxIter": 4000, "dtype": "float64"}))
    with pytest.raises(TypeError, match="GLOBAL LduMatrix"):
        slv.solve([m, m], [b, b])
