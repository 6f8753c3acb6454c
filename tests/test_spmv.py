"""SpMV correctness across all formats vs dense reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu.core import formats
from ogl_tpu.kernels import spmv


def _random_sparse(rng, n=48, density=0.12):
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(a, rng.normal(size=n) + 5.0)
    return a


ALL_CONVERTERS = [
    ("coo", lambda c: c),
    ("csr", formats.coo_to_csr),
    ("ell", formats.coo_to_ell),
    ("dia", formats.coo_to_dia),
    ("sell", formats.coo_to_sell),
]


@pytest.mark.parametrize("name,conv", ALL_CONVERTERS)
def test_spmv_matches_dense(rng, name, conv):
    a = _random_sparse(rng)
    x = rng.normal(size=a.shape[0])
    m = conv(formats.coo_from_dense(a))
    y = spmv.spmv(m, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,conv", ALL_CONVERTERS)
def test_spmv_jit_and_grad_safe(rng, name, conv):
    a = _random_sparse(rng, n=24)
    x = jnp.asarray(rng.normal(size=24))
    m = conv(formats.coo_from_dense(a))
    y = jax.jit(spmv.spmv)(m, x)
    np.testing.assert_allclose(np.asarray(y), a @ np.asarray(x), rtol=1e-12, atol=1e-12)


def test_spmv_structured_poisson_dia(rng):
    # 2-D 5-point Poisson on a 16x16 grid: Dia must be exact
    nx = 16
    n = nx * nx
    a = np.zeros((n, n))
    for j in range(nx):
        for i in range(nx):
            c = j * nx + i
            a[c, c] = 4.0
            for d in (-1, 1):
                if 0 <= i + d < nx:
                    a[c, c + d] = -1.0
            for d in (-nx, nx):
                if 0 <= c + d < n and 0 <= j + d // nx < nx:
                    a[c, c + d] = -1.0
    m = formats.coo_to_dia(formats.coo_from_dense(a))
    assert m.offsets == (-nx, -1, 0, 1, nx)
    x = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(spmv.spmv(m, jnp.asarray(x))), a @ x, rtol=1e-12)


def test_matvec_closure_in_while_loop(rng):
    a = _random_sparse(rng, n=16)
    m = formats.coo_to_ell(formats.coo_from_dense(a))
    mv = spmv.matvec(m)

    def body(i, x):
        return mv(x) / jnp.linalg.norm(mv(x))

    x0 = jnp.asarray(rng.normal(size=16))
    y = jax.jit(lambda x: jax.lax.fori_loop(0, 5, body, x))(x0)
    assert np.isfinite(np.asarray(y)).all()


def test_roofline_model_positive(rng):
    from ogl_tpu.kernels import roofline

    a = _random_sparse(rng, n=32)
    for conv in (formats.coo_to_csr, formats.coo_to_ell, formats.coo_to_dia,
                 formats.coo_to_sell, lambda c: c):
        m = conv(formats.coo_from_dense(a))
        assert roofline.spmv_bytes(m) > 0
        assert roofline.spmv_flops(m) > 0
    # the CPU has no entry in the published-peak table: an error, never a
    # silent default denominator
    with pytest.raises(KeyError):
        roofline.hbm_peak_gbps()
