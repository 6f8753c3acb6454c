"""Sparse matrix-vector products, one per device format.

This is the device hot loop of every Krylov solve (the work Ginkgo's CUDA
kernels do for the reference — `solver->apply` per iteration,
lduLduBase.H:272-276).  Design rules: static shapes everywhere (sparsity
is compile-time constant), no scalar loops, gathers only where the format
requires them:

  Coo/Csr — gather x[cols] + segment-sum.  Reference-parity formats; the
            segment reduction lowers to an XLA scatter-add (atomics on
            the GPU, so the summation order varies from run to run).
  Ell     — dense (n,K) gather + product + row reduce.  The general
            unstructured workhorse: one vectorised gather, then
            elementwise work.
  Sell    — SELL-C-σ width buckets: per-bucket dense gather+reduce,
            reducing padded FLOPs/bytes for skewed row lengths.
  Dia     — static shifted dense products: ZERO gathers; XLA fuses the
            pad, the shifted slices and the multiply-adds into one loop
            for stencil (structured-mesh) matrices.

All functions take x of shape (n,) and return y = A @ x of shape (n,).
`matvec(A)` returns a jit-friendly closure dispatched on format type.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ogl_tpu.core.formats import Coo, Csr, Dia, Ell, Hybrid, Sell

__all__ = ["spmv", "matvec", "spmv_coo", "spmv_csr", "spmv_ell", "spmv_dia", "spmv_sell"]


def spmv_coo(m: Coo, x):
    prod = m.vals * jnp.take(x, m.cols, axis=0)
    return jax.ops.segment_sum(prod, m.rows, num_segments=m.shape[0])


def spmv_csr(m: Csr, x):
    n = m.shape[0]
    # expand row_ptr -> row ids with a static total length (nnz)
    rows = jnp.repeat(
        jnp.arange(n, dtype=jnp.int32),
        jnp.diff(m.row_ptr),
        total_repeat_length=m.nnz,
    )
    prod = m.vals * jnp.take(x, m.cols, axis=0)
    return jax.ops.segment_sum(prod, rows, num_segments=n)


def spmv_ell(m: Ell, x):
    # (n, K) gather; padding cols point at the row itself with val 0
    return jnp.sum(m.vals * jnp.take(x, m.cols, axis=0), axis=1)


def spmv_sell(m: Sell, x):
    # per-bucket dense gather+reduce (each bucket streams only its own
    # w_b-padded slices — the SELL-C-σ traffic win over ELL), scattered
    # back to natural row order through the slot tables
    n = m.shape[0]
    y = jnp.zeros((n + 1,), x.dtype)  # slot n = dead pad row
    for cb, vb, sr in zip(m.cols, m.vals, m.slot_rows):
        contrib = jnp.sum(vb * jnp.take(x, cb, axis=0), axis=-1)  # (ns, C)
        y = y.at[sr].add(contrib.reshape(-1))
    return y[:n]


def spmv_dia(m: Dia, x):
    n = m.shape[0]
    offs = m.offsets
    lo = max(0, -min(offs)) if offs else 0
    hi = max(0, max(offs)) if offs else 0
    xp = jnp.pad(x, (lo, hi))
    y = jnp.zeros_like(x)
    for k, off in enumerate(offs):
        # x[i + off] for all i, OOB = 0 via the padding; data OOB entries are 0
        y = y + m.data[k] * jax.lax.dynamic_slice_in_dim(xp, lo + off, n)
    return y


def _spmv_gdia(m, x):
    from ogl_tpu.kernels.gdia import spmv_gdia

    return spmv_gdia(m, x)


def spmv_hybrid(m, x):
    return spmv_ell(m.ell, x) + spmv_coo(m.coo, x)


def _spmv_xell(m, x):
    from ogl_tpu.kernels.xell import spmv_xell

    return spmv_xell(m, x)


_DISPATCH = {Coo: spmv_coo, Csr: spmv_csr, Ell: spmv_ell, Dia: spmv_dia,
             Sell: spmv_sell, Hybrid: spmv_hybrid}


def _lookup(m):
    f = _DISPATCH.get(type(m))
    if f is None and type(m).__name__ == "Gdia":
        return _spmv_gdia
    if f is None and type(m).__name__ == "Xell":
        return _spmv_xell
    if f is None:
        raise TypeError(f"unknown matrix format {type(m)}")
    return f


def spmv(m, x):
    """y = A @ x for any format (XLA paths)."""
    return _lookup(m)(m, x)


def pack_fast(rows, cols, vals, n: int, max_planes: int = 48,
              presorted: bool = False):
    """Pack host COO triplets into the densest format that represents
    them: Dia (bounded distinct offsets, gather-free) → Gdia (bounded
    block-row planes, lane gathers) → Xell (crossed-gather, fully
    unstructured) → Ell (plain gather).  Used for derived operators (ISAI
    inverses, ILU/IC factors, AMG levels).
    presorted=True skips the row-major sort (the LDU sparsity emits
    row-major order already)."""
    import numpy as np

    from ogl_tpu.core.formats import Coo, coo_to_dia, coo_to_ell

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if not presorted:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    coo = Coo(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
              vals=vals, shape=(n, n))
    diffs = cols - rows
    # cheap pre-check: distinct offsets bounded without a full unique —
    # sample first; confirm with a presence-table count (no nnz sort)
    sample = np.unique(diffs[:: max(1, len(diffs) // 65536)])
    if len(sample) <= 64:
        present = np.zeros(2 * n - 1, np.bool_) if n else np.zeros(1, np.bool_)
        present[diffs + (n - 1)] = True
        if int(present.sum()) <= 64:
            return coo_to_dia(coo)
    try:
        from ogl_tpu.kernels.gdia import gdia_from_coo

        return gdia_from_coo(coo, max_planes=max_planes)
    except ValueError:
        pass
    if n >= (1 << 15):
        # beyond the Gdia plane budget: the crossed-gather format covers
        # arbitrary sparsity up to a window budget of c_max chunks of 128
        # block-rows
        try:
            from ogl_tpu.kernels.xell import xell_from_coo

            return xell_from_coo(coo)
        except ValueError as e:
            import warnings

            warnings.warn(
                f"pack_fast: {n}-row matrix fell to the Ell tier "
                f"(Xell packing failed: {e}) — renumber the matrix "
                "(reorder='rcm') or raise the Xell window budget",
                RuntimeWarning, stacklevel=2)
    import jax.numpy as jnp

    coo = Coo(rows=jnp.asarray(coo.rows), cols=jnp.asarray(coo.cols),
              vals=jnp.asarray(coo.vals), shape=coo.shape)
    return coo_to_ell(coo)


def matvec(m):
    """Return `x -> A @ x` closing over the (pytree) matrix; suitable for
    capture inside jit/while_loop bodies.  Dispatches on the format type."""
    f = _lookup(m)
    return lambda x: f(m, x)
