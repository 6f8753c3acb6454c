"""Steady-state device value updates (reference CsrMatrixWrapper.H:74-136:
in-place overwrite of device value arrays without rebuilding sparsity).

The jit'd `ValueMap.update` must (a) reproduce a fresh conversion exactly for
every format, and (b) be the ONLY path FoamSolver takes on later solves —
no host-side format converter may run again.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels.gdia import gdia_from_coo


def _random_coo(rng, n=40, density=0.15):
    a = (rng.random((n, n)) < density) * rng.normal(size=(n, n))
    np.fill_diagonal(a, 4.0 + rng.random(n))
    return formats.coo_from_dense(a, dtype=np.float64)


CONVERTERS = {
    "Coo": lambda c: c,
    "Csr": formats.coo_to_csr,
    "Ell": formats.coo_to_ell,
    "Dia": formats.coo_to_dia,
    "Sell": formats.coo_to_sell,
    "Gdia": gdia_from_coo,
    "Hybrid": formats.coo_to_hybrid,
}


@pytest.mark.parametrize("fmt", list(CONVERTERS))
def test_value_map_matches_fresh_conversion(fmt, rng):
    coo = _random_coo(rng)
    m = CONVERTERS[fmt](coo)
    vm = formats.value_map(m, coo.rows, coo.cols)

    new_vals = jnp.asarray(rng.normal(size=coo.nnz))
    updated = vm.update(m, new_vals)
    fresh = CONVERTERS[fmt](
        formats.Coo(rows=coo.rows, cols=coo.cols, vals=new_vals, shape=coo.shape)
    )
    np.testing.assert_allclose(
        formats.to_dense(updated), formats.to_dense(fresh), rtol=0, atol=0
    )
    # structure arrays must be untouched (sparsity is constant)
    if fmt == "Ell":
        np.testing.assert_array_equal(updated.cols, m.cols)
    if fmt == "Gdia":
        np.testing.assert_array_equal(updated.lidx, m.lidx)


def test_value_map_accumulates_duplicates(rng):
    # two COO entries on the same (row, col): Dia layout collides -> add
    coo = formats.Coo(
        rows=jnp.asarray([0, 1, 1, 2], jnp.int32),
        cols=jnp.asarray([0, 1, 1, 2], jnp.int32),
        vals=jnp.asarray([4.0, 2.0, 3.0, 4.0]),
        shape=(3, 3),
    )
    m = formats.coo_to_dia(coo)
    vm = formats.value_map(m, coo.rows, coo.cols)
    assert not vm.unique
    upd = vm.update(m, jnp.asarray([1.0, 10.0, 100.0, 1000.0]))
    np.testing.assert_allclose(np.diag(formats.to_dense(upd)), [1.0, 110.0, 1000.0])


@pytest.mark.parametrize("fmt", ["Dia", "Gdia", "Ell", "Sell"])
def test_foam_steady_state_update_is_device_only(fmt, rng, monkeypatch):
    """Second solve with updateSysMatrix=true must not re-run any host
    format converter."""
    from ogl_tpu.foam import solver as foam_solver

    dims = (12, 12)
    m = problems.poisson_ldu(dims)
    n = m.n
    x_true = rng.normal(size=n)
    a = problems.poisson_dense(dims)
    b = a @ x_true

    fs = foam_solver.FoamSolver(
        f"p_vu_{fmt}",
        {"solver": "GKOCG", "matrixFormat": fmt, "tolerance": 1e-10,
         "maxIter": 500, "executor": "reference", "dtype": "float64"},
    )
    x1, perf1 = fs.solve(m, b)
    assert perf1.converged

    def _boom(*a, **k):
        raise AssertionError("host format converter ran on a steady-state update")

    for key in list(foam_solver._FORMAT_CONVERTERS):
        if key not in ("Coo",):
            monkeypatch.setitem(foam_solver._FORMAT_CONVERTERS, key, _boom)

    # new coefficients: scale the whole system (same sparsity)
    m2 = ldu.LduMatrix(
        n=m.n, lower_addr=m.lower_addr, upper_addr=m.upper_addr,
        diag=np.asarray(m.diag) * 2.0, upper=np.asarray(m.upper) * 2.0,
    )
    x2, perf2 = fs.solve(m2, 2.0 * b)
    assert perf2.converged
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-5)
