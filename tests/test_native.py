"""Native C++ host library tests: each native routine must agree exactly
with its NumPy fallback (the fallback is the reference semantics, pinned by
the 5×5 fixtures in test_ldu.py)."""

import os

import numpy as np
import pytest

from ogl_tpu import native
from ogl_tpu import testing as problems
from ogl_tpu.core import formats

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


def test_native_compiles():
    assert native.available()


def test_init_local_sparsity_matches_numpy(rng):
    m = problems.poisson_ldu((13, 7, 3))
    nat = native.init_local_sparsity(m.n, m.lower_addr, m.upper_addr, True)
    # numpy fallback path (bypass native)
    nf = m.n_faces
    faces = np.arange(nf)
    diag_idx = np.arange(m.n)
    rows = np.concatenate([m.lower_addr, m.upper_addr, diag_idx])
    cols = np.concatenate([m.upper_addr, m.lower_addr, diag_idx])
    src = np.concatenate([faces, faces, nf + diag_idx])
    order = np.lexsort((cols, rows))
    np.testing.assert_array_equal(nat[0], rows[order])
    np.testing.assert_array_equal(nat[1], cols[order])
    np.testing.assert_array_equal(nat[2], src[order])


def test_init_local_sparsity_fixture():
    """The reference 5×5 fixture (test_HostMatrix.C:70-107) through the
    native path."""
    upper = np.array([1, 3, 2, 4, 3, 4])
    lower = np.array([0, 0, 1, 1, 2, 3])
    r, c, p = native.init_local_sparsity(5, lower, upper, True)
    np.testing.assert_array_equal(r, [0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4])
    np.testing.assert_array_equal(c, [0, 1, 3, 0, 1, 2, 4, 1, 2, 3, 0, 2, 3, 4, 1, 3, 4])
    np.testing.assert_array_equal(p, [6, 0, 1, 0, 7, 2, 3, 2, 8, 4, 1, 4, 9, 5, 3, 5, 10])


def test_ilu0_exact_on_tridiagonal():
    n = 16
    a = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    coo = formats.coo_from_dense(a)
    rows = np.asarray(coo.rows)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    out = native.ilu0_csr(n, indptr, np.asarray(coo.cols), np.asarray(coo.vals))
    # tridiagonal: ILU(0) == exact LU; L @ U must reproduce A
    L = np.eye(n)
    U = np.zeros((n, n))
    for p in range(len(out)):
        i, j = int(rows[p]), int(np.asarray(coo.cols)[p])
        (L if j < i else U)[i, j] = out[p]
    np.testing.assert_allclose(L @ U, a, atol=1e-12)


def test_ic0_exact_on_tridiagonal():
    n = 16
    a = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    # lower CSR incl diag
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(max(0, i - 1), i + 1):
            rows.append(i), cols.append(j), vals.append(a[i, j])
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, np.array(rows) + 1, 1)
    indptr = np.cumsum(indptr)
    lv = native.ic0_csr(n, indptr, np.array(cols, np.int32), np.array(vals))
    L = np.zeros((n, n))
    for p, (i, j) in enumerate(zip(rows, cols)):
        L[i, j] = lv[p]
    np.testing.assert_allclose(L @ L.T, a, atol=1e-12)


def test_pgm_matches_python(rng):
    import scipy.sparse as sp

    a = problems.poisson_dense((8, 8))
    acsr = sp.csr_matrix(a)
    agg, nc = native.pgm_aggregate(
        a.shape[0], acsr.indptr.astype(np.int64), acsr.indices.astype(np.int32),
        np.abs(acsr.data),
    )
    assert nc == agg.max() + 1
    assert (agg >= 0).all()
    # pairwise matching at least halves-ish the graph
    assert nc <= (2 * a.shape[0]) // 3 + 1


def test_sort_coo(rng):
    n = 50
    rows = rng.integers(0, n, 300).astype(np.int64)
    cols = rng.integers(0, n, 300).astype(np.int64)
    r, c, p = native.sort_coo(n, rows, cols)
    key = r.astype(np.int64) * n + c
    assert np.all(np.diff(key) >= 0)
    np.testing.assert_array_equal(r, rows[p])
    np.testing.assert_array_equal(c, cols[p])


def test_native_isai_build_matches_fallback(rng):
    from ogl_tpu import native
    from ogl_tpu.precond.isai import isai_triples

    if not native.available():
        pytest.skip("native lib unavailable")
    m = problems.poisson_ldu((9, 7))
    from ogl_tpu.core import ldu as ldu_mod

    coo = ldu_mod.ldu_to_coo_host(m)
    mr, mc, mv = isai_triples(coo, sparsity_power=2)
    # fallback path (monkey-free: call with native disabled via env of lib)
    import ogl_tpu.native as nat_mod

    saved = nat_mod.isai_build
    try:
        nat_mod.isai_build = lambda *a, **k: None
        fr, fc, fv = isai_triples(coo, sparsity_power=2)
    finally:
        nat_mod.isai_build = saved
    ok = np.lexsort((mc, mr))
    fk = np.lexsort((fc, fr))
    np.testing.assert_array_equal(mr[ok], fr[fk])
    np.testing.assert_array_equal(mc[ok], fc[fk])
    np.testing.assert_allclose(mv[ok], fv[fk], atol=1e-12)


def test_native_ilut_factors_solve():
    """Native threshold ILU must be a usable preconditioner: L@U close to A
    on A's pattern, and CG/BiCGStab-style sweep apply reduces residuals."""
    from ogl_tpu import native

    if not native.available():
        pytest.skip("native lib unavailable")
    m = problems.poisson_ldu((12, 10))
    from ogl_tpu.core import ldu as ldu_mod
    from ogl_tpu.precond.ilu import ilut_factors

    coo = ldu_mod.ldu_to_coo_host(m)
    # generous fill cap -> effectively a complete LU on this small system
    (lr, lc, lv), (ur, uc, uv), ud = ilut_factors(coo, drop_tol=0.0,
                                                  fill_factor=100.0)
    n = m.n
    L = np.eye(n)
    L[lr, lc] = lv
    U = np.zeros((n, n))
    U[ur, uc] = uv
    np.fill_diagonal(U, ud)
    a = formats.to_dense(coo)
    prod = L @ U
    mask = a != 0
    # with drop_tol=0 this is a (possibly fill-in-complete) LU: on-pattern
    # agreement should be tight for this diagonally dominant system
    np.testing.assert_allclose(prod[mask], a[mask], atol=1e-8)


def test_native_ict_matches_python():
    from ogl_tpu import native

    if not native.available():
        pytest.skip("native lib unavailable")
    m = problems.poisson_ldu((10, 9))
    from ogl_tpu.core import ldu as ldu_mod
    from ogl_tpu.precond.ilu import ict_factor

    coo = ldu_mod.ldu_to_coo_host(m)
    (nr, nc, nv), nd = ict_factor(coo, drop_tol=1e-3)
    import ogl_tpu.native as nat_mod

    saved = nat_mod.ict_triples
    try:
        nat_mod.ict_triples = lambda *a, **k: None
        (pr, pc, pv), pd = ict_factor(coo, drop_tol=1e-3)
    finally:
        nat_mod.ict_triples = saved
    nk = np.lexsort((nc, nr))
    pk = np.lexsort((pc, pr))
    np.testing.assert_array_equal(nr[nk], pr[pk])
    np.testing.assert_array_equal(nc[nk], pc[pk])
    np.testing.assert_allclose(nv[nk], pv[pk], atol=1e-10)
    np.testing.assert_allclose(nd, pd, atol=1e-10)


def test_native_dia_layout_matches_numpy(rng):
    """Native DIA layout/pack vs the NumPy path: identical offsets, dest,
    and packed data (incl. duplicate (row,col) entries, which must sum)."""
    from ogl_tpu import native
    from ogl_tpu.core import formats

    if not native.available():
        pytest.skip("native lib unavailable")
    n = 700
    nnz = 5000
    rows = rng.integers(0, n, nnz).astype(np.int64)
    cols = np.clip(rows + rng.integers(-6, 7, nnz), 0, n - 1).astype(np.int64)
    vals = rng.normal(size=nnz).astype(np.float32)

    offs_n, dest_n = formats.dia_layout(rows, cols, n)

    # NumPy reference, computed inline (the module path routes to native)
    shifted = (cols - rows) + n - 1
    present = np.zeros(2 * n - 1, bool)
    present[shifted] = True
    offs_ref = tuple(int(o) - (n - 1) for o in np.flatnonzero(present))
    rank = np.cumsum(present) - 1
    dest_ref = rank[shifted] * n + rows
    assert offs_n == offs_ref
    np.testing.assert_array_equal(dest_n, dest_ref)

    coo = formats.Coo(rows=rows, cols=cols, vals=vals, shape=(n, n))
    d = formats.coo_to_dia(coo)
    data_ref = np.bincount(
        dest_ref, weights=vals.astype(np.float64),
        minlength=len(offs_ref) * n).astype(np.float32).reshape(-1, n)
    np.testing.assert_array_equal(np.asarray(d.data), data_ref)


# --- build keying: a library built elsewhere is never loaded ---------------

@pytest.fixture
def private_build(monkeypatch, tmp_path):
    """The loader pointed at a private copy of the source and build dir,
    with its load cache reset (restored afterwards)."""
    import shutil

    import ogl_tpu.native as nat_mod

    src = tmp_path / "ogl_host.cpp"
    shutil.copy(nat_mod._SRC, src)
    monkeypatch.setattr(nat_mod, "_SRC", str(src))
    monkeypatch.setattr(nat_mod, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(nat_mod, "_lib", None)
    monkeypatch.setattr(nat_mod, "_tried", False)
    return nat_mod, src


def test_build_key_tracks_source(private_build):
    nat_mod, src = private_build
    k1 = nat_mod.build_key(str(src))
    src.write_text(src.read_text() + "\n// changed\n")
    assert nat_mod.build_key(str(src)) != k1


def test_build_key_tracks_host(private_build, monkeypatch):
    import platform

    nat_mod, src = private_build
    k1 = nat_mod.build_key(str(src))
    monkeypatch.setattr(platform, "node", lambda: "another-host")
    assert nat_mod.build_key(str(src)) != k1


def test_changed_source_is_rebuilt(private_build):
    nat_mod, src = private_build
    assert nat_mod.lib() is not None
    first = nat_mod.library_path(str(src))
    assert os.path.exists(first)
    src.write_text(src.read_text() + "\n// changed\n")
    nat_mod._lib, nat_mod._tried = None, False
    assert nat_mod.lib() is not None
    second = nat_mod.library_path(str(src))
    assert second != first and os.path.exists(second)


def test_foreign_library_is_not_loaded(private_build):
    """A library under any other name (another host's key, the old
    unkeyed name) is ignored: the loader builds its own."""
    nat_mod, src = private_build
    os.makedirs(nat_mod._BUILD)
    for name in ("libogl_host.so", "libogl_host-0123456789abcdef.so"):
        with open(os.path.join(nat_mod._BUILD, name), "wb") as f:
            f.write(b"not a library")
    assert nat_mod.lib() is not None
    assert os.path.exists(nat_mod.library_path(str(src)))
