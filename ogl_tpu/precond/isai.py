"""ISAI — incomplete sparse approximate inverse ("ISAI"/"GISAI",
reference Preconditioner.H:226-259, Ginkgo gko::preconditioner::Isai).

For each row i, M is supported on the sparsity J_i of A^p (p =
sparsityPower) and chosen so (M A)|_{J_i} = e_i|_{J_i}:

    M[i, J_i] · A[J_i, J_i] = e_i[J_i]   ⇒   A[J_i,J_i]ᵀ m = e_i

Shape: all n small systems are ONE padded batched dense solve (n, K, K)
at setup, and the apply is a format-dispatched SpMV
(Dia/Gdia/Ell via kernels.spmv.pack_fast) — no triangular solves anywhere.  The spd variant symmetrises the apply,
r ↦ ½(M + Mᵀ)r, so CG sees a symmetric operator (Ginkgo's spd isai
guarantees SPD through its factored form; the symmetrised general ISAI is
the batched-dense equivalent)."""

from __future__ import annotations

import jax
import numpy as np

from ogl_tpu.core.formats import Coo

__all__ = ["isai", "isai_triples"]


def _pattern_power(rows, cols, n, p: int):
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    s = a.copy()
    for _ in range(p - 1):
        s = (s @ a).tocsr()
        s.data[:] = 1
    s = (s + sp.identity(n, np.int8, format="csr")).tocsr()
    s.data[:] = 1
    s.sort_indices()
    return s


def isai_triples(coo: Coo, sparsity_power: int = 1):
    """The approximate-inverse M as host COO triples (rows, cols, vals) —
    setup only; used by both the single-device PrecondOp and the
    distributed Schwarz stacking (dist.precond).

    The batched extraction G[i] = A[J_i, J_i] runs in the native C++ lib
    when available (NumPy fallback), and the n small solves run as one
    batched HOST solve: at k ≤ ~10 the LAPACK batch beats shipping a
    (n,k,k) tensor to the accelerator and the inverse back."""
    n = coo.shape[0]
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals))

    import scipy.sparse as sp

    s = _pattern_power(rows, cols, n, sparsity_power)
    counts = np.diff(s.indptr)
    k = int(counts.max())

    from ogl_tpu import native

    # f32 end-to-end: the extraction's G tensor (n, k, k) is the setup's
    # largest allocation, and an approximate inverse gains nothing from
    # f64 (Ginkgo extracts in value_type precision)
    a = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, n))
    a.sort_indices()
    nat = native.isai_build(n, a.indptr.astype(np.int64), a.indices, a.data,
                            s.indptr.astype(np.int64), s.indices, k)
    if nat is not None:
        # native path solved the k x k systems in place: assemble directly
        J, valid, m_rows = nat
        m_rows = m_rows.astype(vals.dtype, copy=False)
        mrows_all = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
        vmask = valid.reshape(-1)
        return (mrows_all.reshape(-1)[vmask], J.reshape(-1)[vmask],
                m_rows.reshape(-1)[vmask])
    else:
        # padded per-row column sets J_i (pad with the row itself; padded
        # positions get identity rows/cols in G so they solve to 0 coupling)
        J = np.repeat(np.arange(n)[:, None], k, axis=1)
        slot = np.arange(len(s.indices)) - np.repeat(s.indptr[:-1], counts)
        row_of = np.repeat(np.arange(n), counts)
        J[row_of, slot] = s.indices
        valid = np.zeros((n, k), bool)
        valid[row_of, slot] = True

        # G[i] = A[J_i, J_i] via a sorted (row*n+col) -> val lookup;
        # duplicate (row, col) entries (e.g. a face plus a cyclic-interface
        # coupling of the same cell pair) must SUM like every other
        # consumer of the COO, so reduce to unique keys first
        keys = rows * n + cols
        order_k = np.argsort(keys)
        keys_sorted, starts = np.unique(keys[order_k], return_index=True)
        vals_sorted = np.add.reduceat(vals[order_k], starts)
        q = (J[:, :, None].astype(np.int64) * n + J[:, None, :]).reshape(-1)
        idx = np.searchsorted(keys_sorted, q)
        idx = np.clip(idx, 0, len(keys_sorted) - 1)
        hit = keys_sorted[idx] == q
        G = np.where(hit, vals_sorted[idx], 0.0).reshape(n, k, k).astype(np.float32)
        pad = ~valid
        eye = np.eye(k, dtype=bool)[None]
        G = np.where((pad[:, :, None] | pad[:, None, :]) & ~eye, 0.0, G)
        G = np.where(pad[:, :, None] & eye, 1.0, G)
        e = np.zeros((n, k), np.float32)
        pos = np.argmax(J == np.arange(n)[:, None], axis=1)
        e[np.arange(n), pos] = 1.0

    # rows whose own diagonal is zero (empty rows of padded Schwarz shards,
    # structurally-zero diagonals) would make G singular — and the native
    # path pads G with identity entries, hiding them behind a unit pivot
    # while leaving e all-zero (an all-zero M row).  Either signature gets
    # the identity action instead (M[i] = e_i).
    pos = np.argmax(J == np.arange(n)[:, None], axis=1)
    bad = (G[np.arange(n), pos, pos] == 0.0) | ~np.any(e != 0.0, axis=1)
    if bad.any():
        G[bad] = np.eye(k, dtype=G.dtype)
        e[bad] = 0.0
        e[bad, pos[bad]] = 1.0
        valid = valid.copy()
        valid[bad] = False
        valid[bad, pos[bad]] = True
    try:
        m_rows = np.linalg.solve(G.transpose(0, 2, 1), e[..., None]).squeeze(-1)
    except np.linalg.LinAlgError:
        # singular local blocks beyond the diagonal guard: least-squares
        m_rows = np.einsum(
            "nij,nj->ni", np.linalg.pinv(G.transpose(0, 2, 1)), e)
    m_rows = np.where(valid, m_rows, 0.0).astype(vals.dtype)

    mrows_all = np.repeat(np.arange(n)[:, None], k, axis=1)
    vmask = valid.reshape(-1)
    return (mrows_all.reshape(-1)[vmask], J.reshape(-1)[vmask],
            m_rows.reshape(-1)[vmask])


def isai(coo: Coo, sparsity_power: int = 1, spd: bool = False):
    n = coo.shape[0]
    mr, mc, mv = isai_triples(coo, sparsity_power=sparsity_power)

    from ogl_tpu.kernels.spmv import pack_fast, spmv
    from ogl_tpu.precond import PrecondOp

    # pack M into the densest format (its apply is a hot-loop SpMV)
    M = pack_fast(mr, mc, mv, n)

    if not spd:
        return PrecondOp(lambda s, r: spmv(s, r).astype(r.dtype), M)

    # transpose of M for the symmetrised apply
    Mt = pack_fast(mc, mr, mv, n)

    def apply_spd(s, r):
        m, mt = s
        return (0.5 * (spmv(m, r) + spmv(mt, r))).astype(r.dtype)

    return PrecondOp(apply_spd, (M, Mt))
