"""Format container + conversion tests (the gko::matrix::{Coo,Csr,Ell}
surface the reference selects via matrixFormat, CsrMatrixWrapper.H:138-161,
plus the Dia and Sell formats)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu.core import formats


def _random_sparse(rng, n=32, density=0.15):
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(a, rng.normal(size=n) + 5.0)
    return a


def test_coo_roundtrip(rng):
    a = _random_sparse(rng)
    coo = formats.coo_from_dense(a)
    np.testing.assert_allclose(formats.to_dense(coo), a, atol=1e-14)


@pytest.mark.parametrize("conv", [formats.coo_to_csr, formats.coo_to_ell, formats.coo_to_dia])
def test_conversions_preserve_matrix(rng, conv):
    a = _random_sparse(rng)
    m = conv(formats.coo_from_dense(a))
    np.testing.assert_allclose(formats.to_dense(m), a, atol=1e-14)


@pytest.mark.parametrize("slice_height,sigma", [(8, 64), (4, 8)])
def test_sell_preserves_matrix(rng, slice_height, sigma):
    a = _random_sparse(rng, n=37)  # non-multiple of slice height
    m = formats.coo_to_sell(formats.coo_from_dense(a), slice_height, sigma)
    np.testing.assert_allclose(formats.to_dense(m), a, atol=1e-14)


def test_dia_structured_offsets():
    # 1-D Poisson: exactly three diagonals
    n = 16
    a = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    d = formats.coo_to_dia(formats.coo_from_dense(a))
    assert d.offsets == (-1, 0, 1)
    np.testing.assert_allclose(formats.to_dense(d), a)


def test_ell_padding_is_safe(rng):
    a = _random_sparse(rng, n=16)
    e = formats.coo_to_ell(formats.coo_from_dense(a))
    cols = np.asarray(e.cols)
    assert cols.min() >= 0 and cols.max() < 16  # pad cols in range (own row)
    vals = np.asarray(e.vals)
    counts = (np.asarray(formats.to_dense(e)) != 0).sum()
    assert (vals != 0).sum() <= counts + 16  # padding contributes zeros only


def test_formats_are_pytrees(rng):
    a = _random_sparse(rng, n=8)
    coo = formats.coo_from_dense(a)
    doubled = jax.jit(lambda m: formats.with_values(m, m.vals * 2.0))(coo)
    np.testing.assert_allclose(formats.to_dense(doubled), 2 * a, atol=1e-14)
    dia = formats.coo_to_dia(coo)
    doubled = jax.jit(lambda m: formats.with_values(m, m.data * 2.0))(dia)
    np.testing.assert_allclose(formats.to_dense(doubled), 2 * a, atol=1e-14)


def test_mtx_roundtrip(tmp_path, rng):
    from ogl_tpu.core import mtx

    a = _random_sparse(rng, n=12)
    coo = formats.coo_from_dense(a)
    p = str(tmp_path / "a.mtx")
    mtx.write_coo(p, coo)
    back = mtx.read(p)
    np.testing.assert_allclose(formats.to_dense(back), a, atol=1e-14)
    vp = str(tmp_path / "v.mtx")
    v = rng.normal(size=12)
    mtx.write_dense(vp, jnp.asarray(v))
    np.testing.assert_allclose(mtx.read(vp).ravel(), v, atol=1e-14)


def test_hybrid_preserves_matrix(rng):
    """Hybrid (ELL bulk + COO tail) reproduces the matrix and actually
    splits: skewed row lengths must land entries in both parts."""
    n = 48
    a = (rng.random((n, n)) < 0.08) * rng.normal(size=(n, n))
    a[0, :] = rng.normal(size=n)  # one long row forces a COO tail
    np.fill_diagonal(a, 4.0)
    coo = formats.coo_from_dense(a)
    h = formats.coo_to_hybrid(coo)
    assert h.coo.nnz > 0  # tail non-empty
    assert h.ell.row_width < int(np.count_nonzero(a, axis=1).max())
    np.testing.assert_allclose(formats.to_dense(h), a, rtol=1e-12)
    # spmv matches dense
    from ogl_tpu.kernels import spmv as _s

    x = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(_s.spmv(h, jnp.asarray(x))), a @ x, rtol=1e-6)


def test_sell_storage_is_sliced_not_ell():
    """The SELL-C-σ footprint must track per-slice widths, not the global
    max.
    One dense row among short rows: ELL pads everything to n, SELL pads
    only that row's slice."""
    n = 256
    rng = np.random.default_rng(0)
    rows = [np.arange(n), np.arange(n)]  # diagonal
    cols = [np.arange(n), (np.arange(n) + 1) % n]
    rows.append(np.full(n, 7))  # one dense row
    cols.append(np.arange(n))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    order = np.lexsort((c, r))
    coo = formats.Coo(rows=r[order].astype(np.int32),
                      cols=c[order].astype(np.int32),
                      vals=rng.normal(size=len(r))[order], shape=(n, n))
    sell = formats.coo_to_sell(coo, slice_height=8, sigma=64)
    ell_footprint = n * (n + 2)  # global max row = n+2 wide
    assert sell.stored < ell_footprint // 8, (sell.stored, ell_footprint)
    np.testing.assert_allclose(formats.to_dense(sell), formats.to_dense(coo),
                               atol=1e-12)
    # SpMV agrees with the dense product
    from ogl_tpu.kernels import spmv as spmv_mod

    x = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(spmv_mod.spmv(sell, jnp.asarray(x))),
                               formats.to_dense(coo) @ x, atol=1e-9)


def test_dia_layout_ranks_and_duplicates():
    # brute-force cross-check of the presence-table rank computation
    rng = np.random.default_rng(7)
    n = 50
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, n, 300)
    offs, dest = formats.dia_layout(rows, cols, n)
    assert list(offs) == sorted(set(int(c) - int(r) for r, c in zip(rows, cols)))
    for i in (0, 17, 299):
        d = int(cols[i]) - int(rows[i])
        assert dest[i] == offs.index(d) * n + rows[i]
    # duplicate coordinates map to the SAME slot (summed by coo_to_dia)
    a = np.zeros((4, 4))
    a[1, 2] = 5.0
    coo = formats.coo_from_dense(a)
    dup = formats.Coo(
        rows=np.concatenate([np.asarray(coo.rows)] * 2),
        cols=np.concatenate([np.asarray(coo.cols)] * 2),
        vals=np.concatenate([np.asarray(coo.vals)] * 2),
        shape=coo.shape,
    )
    d = formats.coo_to_dia(dup)
    assert formats.to_dense(d)[1, 2] == 10.0


def test_dia_layout_empty():
    offs, dest = formats.dia_layout(np.zeros(0, np.int64), np.zeros(0, np.int64), 8)
    assert offs == () and len(dest) == 0
