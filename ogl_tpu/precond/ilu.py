"""Incomplete-factorisation preconditioners: ILU(0), ILUT, IC(0), ICT
(reference Preconditioner.H:106-225; Ginkgo factorization::{Ilu,ParIlut,
Ic,ParIct} + preconditioner::{Ilu,Ic}).

Apply: sparse triangular solves are inherently sequential, so the
factors are applied with fixed-count Jacobi sweeps (truncated Neumann
series) — pure SpMV + elementwise work with static shapes.  This is not an
approximation foreign to the reference: its own "IRILU" variant applies the
L/U factors with 5 scalar-Jacobi Richardson iterations
(Preconditioner.H:146-178).  `sweeps` is the `triSolveSweeps` config knob.

  L z = r,  L unit-lower:  z ← r − L_strict z          (sweeps×)
  U x = z:                 x ← (z − U_strict x) / d_U  (sweeps×)
  IC:  L Lᵀ with full lower L:  z ← (r − L_strict z)/d_L, then the
       transposed sweep with Lᵀ_strict.

EXACT mode (`triSolve exact` — the reference's
default ILU/IC apply is Ginkgo's exact sparse triangular solve): a strict
triangular factor is nilpotent, so the SAME sweep iteration run to the
factor's dependency depth (`factor_depth` levels) IS exact forward/backward
substitution — the truncated Neumann series simply stops truncating.  The
exact apply therefore still streams format-dispatched SpMVs; its cost is
depth/sweeps × the approximate apply (a level-scheduled trisolve is the
GPU-native alternative, ROADMAP reach item 4),
with depth ≈ nx+ny+nz for a 3-D Poisson ILU(0).  Convergence parity of the
approximate default against this exact mode is pinned by
tests/test_trisolve_exact.py and recorded in BASELINE.md.

Factorisation itself is one-time host setup (NumPy/SciPy; the native C++
path in ogl_tpu.native accelerates it for large systems).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo

__all__ = ["ilu0", "ilut", "ic0", "ict", "ilu0_factors", "ic0_factor",
           "ict_factor", "factor_depth"]


def factor_depth(rows, cols, n: int) -> int:
    """Dependency depth (level count) of a strict triangular factor: the
    sweep count at which the Jacobi/Neumann apply equals exact
    substitution.  level[i] = 1 + max(level[j]) over stored (i, j); the
    fixpoint converges in `depth` passes (one vectorised np.maximum.at
    each — O(depth·nnz) setup, acceptable for the opt-in exact mode)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if not len(rows):
        return 1
    level = np.zeros(n, np.int64)
    for _ in range(n):
        new = level.copy()
        np.maximum.at(new, rows, level[cols] + 1)
        if np.array_equal(new, level):
            break
        level = new
    return max(int(level.max()), 1)


def _sweep(body, x0, k: int):
    """k applications of body; unrolled when short (XLA fuses the chain),
    fori_loop when long (exact mode can need hundreds of sweeps — an
    unrolled program that size explodes compile time)."""
    if k <= 12:
        x = x0
        for i in range(k):
            x = body(i, x)
        return x
    return jax.lax.fori_loop(0, k, body, x0)


def make_lu_apply(sweeps: int, sweeps_u: int | None = None):
    """Jacobi-sweep triangular-solve apply for (L_strict, U_strict, 1/diagU)
    states — shared by the single-device and distributed (Schwarz) paths.
    With sweeps = the factors' dependency depths the apply is EXACT
    substitution (see module docstring); sweeps_u defaults to sweeps."""
    su = sweeps if sweeps_u is None else sweeps_u

    def apply(s, r):
        from ogl_tpu.kernels.spmv import spmv

        ls, us, inv = s
        z = _sweep(lambda _, zz: r - spmv(ls, zz), r, sweeps)
        x = _sweep(lambda _, xx: (z - spmv(us, xx)) * inv,
                   z * inv, su)
        return x

    return apply


def make_ic_apply(sweeps: int, sweeps_u: int | None = None):
    """Sweep apply for (L_strict, L_strict^T, 1/diagL) states."""
    su = sweeps if sweeps_u is None else sweeps_u

    def apply(s, r):
        from ogl_tpu.kernels.spmv import spmv

        ls, lst, inv = s
        z = _sweep(lambda _, zz: (r - spmv(ls, zz)) * inv,
                   r * inv, sweeps)
        x = _sweep(lambda _, xx: (z - spmv(lst, xx)) * inv,
                   z * inv, su)
        return x

    return apply


def _host_csr(coo: Coo):
    """Host CSR with duplicate (row, col) entries SUMMED — like every other
    COO consumer (SpMV, to_dense, the converters).  Duplicates occur e.g.
    when a cyclic interface couples the same cell pair as a regular face;
    the factorisation kernels' scatter would otherwise silently factor a
    matrix with only one of the duplicate coefficients."""
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals)).astype(np.float64)
    n = coo.shape[0]
    keys = rows * n + cols
    order = np.argsort(keys, kind="stable")
    uk, starts = np.unique(keys[order], return_index=True)
    if len(uk) != len(keys):
        vals = np.add.reduceat(vals[order], starts)
        rows = (uk // n).astype(np.int64)
        cols = (uk % n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return n, indptr, cols, vals


def ilu0_factors(coo: Coo):
    """IKJ-ordered ILU(0) on the host (native C++ when available); returns
    (L_strict, U_strict, u_diag) as (rows, cols, vals) triples / vector."""
    n, indptr, cols, vals = _host_csr(coo)

    from ogl_tpu import native

    a = native.ilu0_csr(n, indptr, cols, vals)
    if a is None:
        a = vals.copy()
        col_pos = [dict(zip(cols[indptr[i]:indptr[i + 1]], range(indptr[i], indptr[i + 1]))) for i in range(n)]
        for i in range(n):
            s, e = indptr[i], indptr[i + 1]
            for kk in range(s, e):
                k = cols[kk]
                if k >= i:
                    break
                dk = col_pos[k].get(k)
                a[kk] = a[kk] / a[dk]
                lik = a[kk]
                for jj in range(col_pos[k][k] + 1, indptr[k + 1]):
                    j = cols[jj]
                    tgt = col_pos[i].get(j)
                    if tgt is not None:
                        a[tgt] -= lik * a[jj]
    rows_full = np.repeat(np.arange(n), np.diff(indptr))
    lower = rows_full > cols
    upper = rows_full < cols
    diag = rows_full == cols
    udiag = np.zeros(n)
    udiag[rows_full[diag]] = a[diag]
    return (
        (rows_full[lower], cols[lower], a[lower]),
        (rows_full[upper], cols[upper], a[upper]),
        udiag,
    )


def ic0_factor(coo: Coo):
    """IC(0): A ≈ L Lᵀ on the lower-triangular pattern of A
    (native C++ when available)."""
    n, indptr, cols, vals = _host_csr(coo)

    from ogl_tpu import native

    if native.available():
        # build lower-triangle CSR (incl. diagonal)
        rows_full = np.repeat(np.arange(n), np.diff(indptr))
        low = cols <= rows_full
        lcols = cols[low].astype(np.int32)
        lvals = vals[low]
        lptr = np.zeros(n + 1, np.int64)
        np.add.at(lptr, rows_full[low] + 1, 1)
        lptr = np.cumsum(lptr)
        lv = native.ic0_csr(n, lptr, lcols, lvals)
        lr2 = np.repeat(np.arange(n), np.diff(lptr))
        dm = lr2 == lcols
        ldiag = np.zeros(n)
        ldiag[lr2[dm]] = lv[dm]
        strict = ~dm
        return (lr2[strict], lcols[strict].astype(np.int64), lv[strict]), ldiag

    lrow: list[dict[int, float]] = [dict() for _ in range(n)]
    ldiag = np.zeros(n)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = cols[p]
            if j > i:
                break
            s = 0.0
            li, lj = lrow[i], lrow[j]
            if len(li) < len(lj):
                for kk, v in li.items():
                    if kk < j:
                        w = lj.get(kk)
                        if w is not None:
                            s += v * w
            else:
                for kk, w in lj.items():
                    if kk < j:
                        v = li.get(kk)
                        if v is not None:
                            s += v * w
            if j < i:
                lrow[i][j] = (vals[p] - s) / ldiag[j]
            else:
                d = vals[p] - sum(v * v for v in lrow[i].values())
                ldiag[i] = np.sqrt(max(d, 1e-300))
    rws, cls, vls = [], [], []
    for i in range(n):
        for j, v in lrow[i].items():
            rws.append(i)
            cls.append(j)
            vls.append(v)
    return (np.array(rws, np.int64), np.array(cls, np.int64), np.array(vls)), ldiag


def _to_ell(n, rows, cols, vals, dtype):
    """Factor triangle -> densest representable format (Dia/Gdia/Ell; see
    kernels.spmv.pack_fast) — the Jacobi-sweep applies are SpMVs in the
    solver hot loop."""
    from ogl_tpu.kernels.spmv import pack_fast

    return pack_fast(rows, cols, vals.astype(dtype), n)


def _lu_apply(n, Ls, Us, udiag, sweeps, dtype, sweeps_u=None):
    from ogl_tpu.precond import PrecondOp

    inv_ud = jnp.asarray((1.0 / udiag), dtype)

    return PrecondOp(make_lu_apply(sweeps, sweeps_u), (Ls, Us, inv_ud))


def ilu0(coo: Coo, sweeps: int = 8, exact: bool = False):
    dtype = np.asarray(jax.device_get(coo.vals)).dtype
    (lr, lc, lv), (ur, uc, uv), ud = ilu0_factors(coo)
    n = coo.shape[0]
    sw_l, sw_u = ((factor_depth(lr, lc, n), factor_depth(ur, uc, n))
                  if exact else (sweeps, sweeps))
    Ls = _to_ell(n, lr, lc, lv, dtype)
    Us = _to_ell(n, ur, uc, uv, dtype)
    return _lu_apply(n, Ls, Us, ud, sw_l, dtype, sweeps_u=sw_u)


def ilut_factors(coo: Coo, drop_tol: float = 1e-3, fill_factor: float = 2.0):
    """Threshold ILU factors ((L_strict), (U_strict), udiag) — native C++
    when available (row-wise IKJ with dual dropping, the ParIlut role),
    SuperLU ILUTP (pivoting disabled) otherwise; ILU(0) as last resort."""
    n, indptr, cols, vals = _host_csr(coo)

    from ogl_tpu import native

    try:
        nat = native.ilut_triples(n, indptr, cols, vals,
                                  drop_tol=drop_tol, fill_factor=fill_factor)
    except RuntimeError:
        nat = None
    if nat is not None:
        (tr, tc, tv), ud = nat
        lm = tr > tc
        um = tr < tc
        return ((tr[lm].astype(np.int64), tc[lm].astype(np.int64), tv[lm]),
                (tr[um].astype(np.int64), tc[um].astype(np.int64), tv[um]),
                ud)

    import scipy.sparse as sp
    from scipy.sparse.linalg import spilu

    a = sp.csr_matrix((vals, cols, indptr), shape=coo.shape).tocsc()
    try:
        f = spilu(a, drop_tol=drop_tol, fill_factor=fill_factor,
                  permc_spec="NATURAL", diag_pivot_thresh=0.0,
                  options={"ILU_MILU": "SILU"})
        if not (np.array_equal(f.perm_r, np.arange(n))
                and np.array_equal(f.perm_c, np.arange(n))):
            raise RuntimeError("spilu produced a nontrivial permutation")
        L, U = f.L.tocoo(), f.U.tocoo()
    except Exception:
        return ilu0_factors(coo)
    lm = L.row > L.col
    um = U.row < U.col
    dm = U.row == U.col
    ud = np.zeros(n)
    ud[U.row[dm]] = U.data[dm]
    return ((L.row[lm].astype(np.int64), L.col[lm].astype(np.int64), L.data[lm]),
            (U.row[um].astype(np.int64), U.col[um].astype(np.int64), U.data[um]),
            ud)


def ilut(coo: Coo, sweeps: int = 8, drop_tol: float = 1e-3,
         fill_factor: float = 2.0, exact: bool = False):
    """Threshold ILU preconditioner (sweep apply over ilut_factors)."""
    dtype = np.asarray(jax.device_get(coo.vals)).dtype
    (lr, lc, lv), (ur, uc, uv), ud = ilut_factors(coo, drop_tol, fill_factor)
    n = coo.shape[0]
    sw_l, sw_u = ((factor_depth(lr, lc, n), factor_depth(ur, uc, n))
                  if exact else (sweeps, sweeps))
    Ls = _to_ell(n, lr, lc, lv, dtype)
    Us = _to_ell(n, ur, uc, uv, dtype)
    return _lu_apply(n, Ls, Us, ud, sw_l, dtype, sweeps_u=sw_u)


def _ic_apply(n, Ls, Lst, ldiag, sweeps, dtype, sweeps_u=None):
    from ogl_tpu.precond import PrecondOp

    inv_d = jnp.asarray(1.0 / ldiag, dtype)

    return PrecondOp(make_ic_apply(sweeps, sweeps_u), (Ls, Lst, inv_d))


def ic0(coo: Coo, sweeps: int = 8, exact: bool = False):
    dtype = np.asarray(jax.device_get(coo.vals)).dtype
    (lr, lc, lv), ld = ic0_factor(coo)
    n = coo.shape[0]
    d = factor_depth(lr, lc, n) if exact else sweeps
    Ls = _to_ell(n, lr, lc, lv, dtype)
    Lst = _to_ell(n, lc, lr, lv, dtype)  # strict upper = Lᵀ strict
    return _ic_apply(n, Ls, Lst, ld, d, dtype, sweeps_u=d)


def ict_factor(coo: Coo, drop_tol: float = 1e-3):
    """Threshold IC factor (ParIct equivalent): left-looking row Cholesky
    with fill-in, dropping computed entries with |l_ij| ≤ drop_tol·√(a_ii·a_jj)
    unless (i,j) is in A's pattern.  Returns ((rows, cols, vals), ldiag).
    Native C++ when available; pure-Python fallback below."""
    n, indptr, cols, vals = _host_csr(coo)

    from ogl_tpu import native

    try:
        nat = native.ict_triples(n, indptr, cols, vals, drop_tol=drop_tol)
    except RuntimeError:
        nat = None
    if nat is not None:
        (tr, tc, tv), ld = nat
        return (tr.astype(np.int64), tc.astype(np.int64), tv), ld
    rows_full = np.repeat(np.arange(n), np.diff(indptr))
    diag = np.zeros(n)
    dm = rows_full == cols
    diag[rows_full[dm]] = vals[dm]
    scale = np.sqrt(np.maximum(np.abs(diag), 1e-300))
    ldiag = np.zeros(n)
    l_cols: list[list[int]] = [[] for _ in range(n)]  # column k -> rows j (asc)
    l_colv: list[list[float]] = [[] for _ in range(n)]
    lrow: list[dict[int, float]] = [dict() for _ in range(n)]
    arow_lower: list[dict[int, float]] = [dict() for _ in range(n)]
    for p in range(len(vals)):
        if cols[p] <= rows_full[p]:
            arow_lower[rows_full[p]][cols[p]] = vals[p]
    import heapq

    for i in range(n):
        w = dict(arow_lower[i])  # working row over columns <= i (may fill)
        heap = [k for k in w if k < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            k = heapq.heappop(heap)
            lik = w[k] / ldiag[k]
            keep = (k in arow_lower[i]) or abs(lik) > drop_tol * scale[i] * scale[k]
            if keep:
                lrow[i][k] = lik
                # apply column-k updates: w[j] -= l_ik * l_jk for j in col k
                # (col k holds only completed rows j < i; the i-diagonal
                # update is the Σ l_ik² term below)
                for j, ljk in zip(l_cols[k], l_colv[k]):
                    if k < j < i:
                        if j in w:
                            w[j] -= lik * ljk
                        else:
                            w[j] = -lik * ljk
                            if j not in seen:
                                heapq.heappush(heap, j)
                                seen.add(j)
        d = arow_lower[i].get(i, 0.0) - sum(v * v for v in lrow[i].values())
        ldiag[i] = np.sqrt(max(d, 1e-300))
        for k, v in lrow[i].items():
            l_cols[k].append(i)
            l_colv[k].append(v)
    rws, cls, vls = [], [], []
    for i in range(n):
        for j, v in lrow[i].items():
            rws.append(i)
            cls.append(j)
            vls.append(v)
    return (np.array(rws, np.int64), np.array(cls, np.int64),
            np.array(vls)), ldiag


def ict(coo: Coo, sweeps: int = 8, drop_tol: float = 1e-3,
        exact: bool = False):
    """Threshold IC preconditioner (sweep apply over the ict_factor)."""
    dtype = np.asarray(jax.device_get(coo.vals)).dtype
    (lr, lc, lv), ldiag = ict_factor(coo, drop_tol)
    n = coo.shape[0]
    d = factor_depth(lr, lc, n) if exact else sweeps
    Ls = _to_ell(n, lr, lc, lv, dtype)
    Lst = _to_ell(n, lc, lr, lv, dtype)
    return _ic_apply(n, Ls, Lst, ldiag, d, dtype, sweeps_u=d)
