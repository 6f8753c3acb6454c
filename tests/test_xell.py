"""Xell (crossed-gather ELL) — the format for fully unstructured
sparsity beyond the Gdia plane budget (reference role: device-fast Csr for
any sparsity, CsrMatrixWrapper.H:138-161)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu
from ogl_tpu.core.reorder import permute_coo, rcm_permutation
from ogl_tpu.kernels import spmv
from ogl_tpu.kernels.xell import (
    xell_from_coo, xell_layout, xell_to_coo, spmv_xell)


def _random_graph_coo(rng, n=2000, k=5, dtype=np.float64):
    """Random symmetric graph matrix (kNN-ish degree k) — unstructured."""
    src = np.repeat(np.arange(n), k)
    dst = rng.integers(0, n, size=n * k)
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep], np.arange(n)])
    c = np.concatenate([dst[keep], src[keep], np.arange(n)])
    v = rng.normal(size=len(r)).astype(dtype)
    # dedup (row, col): keep first
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c, v = r[idx], c[idx], v[idx]
    order = np.lexsort((c, r))
    return formats.Coo(rows=r[order].astype(np.int32),
                       cols=c[order].astype(np.int32),
                       vals=jnp.asarray(v[order]), shape=(n, n))


def _rcm(coo):
    perm = rcm_permutation(coo)
    return permute_coo(coo, perm)


def test_xell_roundtrip(rng):
    coo = _rcm(_random_graph_coo(rng, n=1500))
    m = xell_from_coo(coo)
    back = xell_to_coo(m)
    np.testing.assert_array_equal(np.asarray(back.rows), np.asarray(coo.rows))
    np.testing.assert_array_equal(np.asarray(back.cols), np.asarray(coo.cols))
    np.testing.assert_allclose(np.asarray(back.vals), np.asarray(coo.vals))


def test_xell_spmv_matches_dense(rng):
    coo = _rcm(_random_graph_coo(rng, n=1200))
    m = xell_from_coo(coo)
    a = formats.to_dense(coo)
    x = rng.normal(size=coo.shape[0])
    y = spmv_xell(m, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-10, atol=1e-10)
    # to_dense of the container itself
    np.testing.assert_allclose(formats.to_dense(m), a)


def test_xell_structured_stencil(rng):
    ml = problems.poisson_ldu((32, 8, 4))
    coo = ldu.ldu_to_coo_host(ml, dtype=np.float64)
    m = xell_from_coo(coo)
    a = formats.to_dense(coo)
    x = rng.normal(size=ml.n)
    y = spmv_xell(m, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-10, atol=1e-10)


def test_xell_matvec_f32(rng):
    """The format-dispatched matvec on an f32 Xell container (the dispatch
    the solvers capture) equals the dense operator."""
    coo = _rcm(_random_graph_coo(rng, n=900, dtype=np.float32))
    m = xell_from_coo(coo)
    a = formats.to_dense(coo)
    x = rng.normal(size=coo.shape[0]).astype(np.float32)
    y = spmv.matvec(m)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=2e-5, atol=2e-5)


def test_xell_spill(rng):
    # a generous spill budget stops packing early, forcing the COO spill
    # tail; result must stay exact
    coo = _rcm(_random_graph_coo(rng, n=800))
    m = xell_from_coo(coo, spill_frac=0.15)
    assert m.spill.nnz > 0
    a = formats.to_dense(coo)
    x = rng.normal(size=coo.shape[0])
    y = spmv_xell(m, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-10, atol=1e-10)
    back = xell_to_coo(m)
    np.testing.assert_array_equal(np.asarray(back.rows), np.asarray(coo.rows))


def test_xell_window_cap():
    # an entry coupling row 0 to the far end exceeds any chunk budget
    n = 200_000
    r = np.array([0, 0, n - 1], np.int64)
    c = np.array([0, n - 1, n - 1], np.int64)
    with pytest.raises(ValueError, match="renumber"):
        xell_layout(r, c, n, c_max=4)


def test_xell_value_map(rng):
    coo = _rcm(_random_graph_coo(rng, n=1100))
    m = xell_from_coo(coo)
    vm = formats.value_map(m, coo.rows, coo.cols)
    new_vals = rng.normal(size=coo.nnz)
    m2 = vm.update(m, jnp.asarray(new_vals))
    a2 = formats.to_dense(
        formats.Coo(rows=coo.rows, cols=coo.cols,
                    vals=jnp.asarray(new_vals), shape=coo.shape))
    np.testing.assert_allclose(formats.to_dense(m2), a2)
    # structure tables untouched
    np.testing.assert_array_equal(np.asarray(m2.ll), np.asarray(m.ll))
    np.testing.assert_array_equal(np.asarray(m2.bbT), np.asarray(m.bbT))


def test_xell_value_map_detects_structure_change(rng):
    coo = _rcm(_random_graph_coo(rng, n=1000))
    m = xell_from_coo(coo)
    other = _rcm(_random_graph_coo(np.random.default_rng(7), n=1000))
    with pytest.raises(ValueError, match="sparsity changed|packing"):
        formats.value_map(m, other.rows, other.cols)


def test_pack_fast_routes_to_xell(rng):
    # bandwidth beyond the Gdia plane budget at >= 1<<15 rows -> Xell
    n = 1 << 15
    k = 4
    src = np.repeat(np.arange(n), k)
    dst = (src + rng.integers(-n // 3, n // 3, size=n * k)) % n
    keep = src != dst
    r = np.concatenate([src[keep], np.arange(n)])
    c = np.concatenate([dst[keep], np.arange(n)])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.normal(size=len(r))
    m = spmv.pack_fast(r, c, v, n)
    assert type(m).__name__ == "Xell"
    x = rng.normal(size=n)
    dense_y = None  # too big to densify; cross-check via COO spmv
    coo = formats.Coo(rows=jnp.asarray(r.astype(np.int32)),
                      cols=jnp.asarray(c.astype(np.int32)),
                      vals=jnp.asarray(v), shape=(n, n))
    ref = spmv.spmv_coo(coo, jnp.asarray(x))
    got = spmv.spmv(m, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)


def test_pack_fast_warns_on_ell_landing(rng):
    # pathological: a scrambled permutation at a size where the window
    # budget (c_max chunks of 128 block-rows) cannot cover the span
    n = 1 << 18
    r = np.arange(n, dtype=np.int64)
    c = (r * 48271 + 11) % n  # scrambled permutation: huge window span
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    key = r * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    v = np.ones(len(r))
    with pytest.warns(RuntimeWarning, match="Ell"):
        m = spmv.pack_fast(r, c, v, n)
    assert isinstance(m, formats.Ell)


def test_foam_solve_with_xell(rng):
    """End-to-end: explicit matrixFormat Xell through the foam API."""
    from ogl_tpu import foam

    ml = problems.poisson_ldu((24, 8, 4))
    b = rng.normal(size=ml.n)
    x, perf = foam.solve(
        "p", ml, b,
        {"solver": "GKOCG", "matrixFormat": "Xell",
         "tolerance": 1e-8, "maxIter": 2000})
    a = formats.to_dense(ldu.ldu_to_coo_host(ml, dtype=np.float64))
    xref = np.linalg.solve(a, b)
    np.testing.assert_allclose(np.asarray(x), xref, rtol=1e-4, atol=1e-5)
