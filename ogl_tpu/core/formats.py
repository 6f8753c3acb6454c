"""Sparse matrix containers as JAX pytrees.

Re-design of the matrix-format layer the reference delegates to
Ginkgo (``gko::matrix::{Coo,Csr,Ell}``, selected by the ``matrixFormat``
keyword, reference CsrMatrixWrapper.H:138-161).  All containers are
registered dataclass pytrees: array fields are traced leaves, shape/meta
fields are static, so a container can flow through jit/shard_map and its
sparsity (static after step 1 — reference HostMatrix.H:34 assumes constant
rows/cols) is baked into the compiled program.

Formats:
  Coo   — row/col/val triplets, row-major sorted.  Reference format and the
          exchange format for IO and conversion.
  Csr   — row_ptr/col/val.  Kept mainly for parity; SpMV uses the row ids.
  Ell   — row-padded (n, K) col/val planes.  The general unstructured
          format: SpMV is a dense (n,K) gather + reduce, no scalar loops.
  Dia   — diagonal storage for structured (stencil) matrices: SpMV is a sum
          of shifted dense vector products — zero gathers, one fused
          streaming loop.
  Sell  — sliced-ELL (SELL-C): rows grouped into slices of C=8 sublanes with
          per-slice padding buckets (reduces ELL padding waste).

All conversions preserve the row-major entry order (required for
distributed correctness, reference HostMatrix.C:449-456).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any

__all__ = [
    "Coo",
    "Csr",
    "Ell",
    "Dia",
    "Sell",
    "Hybrid",
    "coo_from_dense",
    "to_dense",
    "coo_to_csr",
    "coo_to_ell",
    "coo_to_dia",
    "coo_to_sell",
    "coo_to_hybrid",
    "with_values",
    "values_flat",
    "cast_values",
    "ValueMap",
    "value_map",
    "BlockUpdatePlan",
    "block_update_plans",
]


def _pytree(cls):
    """Register a dataclass as a pytree: ndarray-annotated fields are leaves,
    everything else is static metadata."""
    data_fields = [f.name for f in dataclasses.fields(cls) if f.metadata.get("leaf", True)]
    meta_fields = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("leaf", True)]
    return jax.tree_util.register_dataclass(cls, data_fields, meta_fields)


def static_field(**kw):
    return dataclasses.field(metadata={"leaf": False}, **kw)


@_pytree
@dataclasses.dataclass(frozen=True)
class Coo:
    """Row-major sorted COO. rows/cols are int32, vals any float dtype."""

    rows: Array
    cols: Array
    vals: Array
    shape: tuple[int, int] = static_field()

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype


@_pytree
@dataclasses.dataclass(frozen=True)
class Csr:
    """Compressed sparse row.  Row-major sorted columns within each row."""

    row_ptr: Array
    cols: Array
    vals: Array
    shape: tuple[int, int] = static_field()

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype


@_pytree
@dataclasses.dataclass(frozen=True)
class Ell:
    """Row-padded ELLPACK.  cols/vals have shape (n_rows, K).

    Padding entries have col == the row's own index and val == 0 so a
    gather-based SpMV needs no masking (reads x[row] and multiplies by 0).
    """

    cols: Array
    vals: Array
    shape: tuple[int, int] = static_field()

    @property
    def row_width(self) -> int:
        return int(self.vals.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype


@_pytree
@dataclasses.dataclass(frozen=True)
class Dia:
    """Diagonal (DIA) storage.  data[d, i] = A[i, i + offsets[d]].

    Out-of-range positions are stored as 0.  `offsets` is static metadata:
    the diagonal structure is compile-time constant, so SpMV unrolls into a
    static sum of shifted elementwise products (no gather at all).
    """

    data: Array  # (n_diags, n_rows)
    offsets: tuple[int, ...] = static_field()
    shape: tuple[int, int] = static_field()

    @property
    def dtype(self):
        return self.data.dtype


@_pytree
@dataclasses.dataclass(frozen=True)
class Sell:
    """SELL-C-σ with per-slice width BUCKETS.  Rows are σ-sorted by length
    in windows of `sigma`, grouped into slices of C = `slice_height` rows,
    and each slice is padded only to ITS OWN width; slices sharing a width
    form a bucket stored as one dense (ns_b, C, w_b) block.  Storage and
    SpMV traffic equal the true SELL-C-σ footprint (Σ C·max_nnz(slice)),
    NOT the global-max ELL footprint, while every shape stays static for
    XLA (bucket count is bounded; see sell_layout).

    cols index x directly (padding: col 0 with val 0 — inert);
    slot_rows[b][s] is the original row of packed slot s (n = dead pad row).
    """

    cols: tuple  # per bucket: (ns_b, C, w_b) int32
    vals: tuple  # per bucket: (ns_b, C, w_b)
    slot_rows: tuple  # per bucket: (ns_b * C,) int32, pad slots -> n
    shape: tuple[int, int] = static_field()
    slice_height: int = static_field()
    sigma: int = static_field(default=64)

    @property
    def dtype(self):
        return self.vals[0].dtype

    @property
    def stored(self) -> int:
        """Stored (padded) entry count — the SELL footprint."""
        return int(sum(int(np.prod(v.shape)) for v in self.vals))


@_pytree
@dataclasses.dataclass(frozen=True)
class Hybrid:
    """Ginkgo-style hybrid: an ELL part for the regular bulk plus a COO
    tail for overflow entries.  The reference advertises `matrixFormat
    Hybrid` but ships it disabled (CsrMatrixWrapper.H:150-153); implemented
    here for drop-in completeness."""

    ell: "Ell"
    coo: "Coo"
    shape: tuple[int, int] = static_field()

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(jax.device_get(self.ell.vals)))) + self.coo.nnz

    @property
    def dtype(self):
        return self.ell.vals.dtype


# -----------------------------------------------------------------------------
# construction / conversion (host-side, NumPy — one-time setup, like the
# reference's init_local_sparsity_pattern; reference HostMatrix.C:469-589)
# -----------------------------------------------------------------------------


def coo_from_dense(a: np.ndarray, dtype=None) -> Coo:
    a = np.asarray(a)
    rows, cols = np.nonzero(a)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = a[rows, cols]
    if dtype is not None:
        vals = vals.astype(dtype)
    return Coo(
        rows=jnp.asarray(rows, jnp.int32),
        cols=jnp.asarray(cols, jnp.int32),
        vals=jnp.asarray(vals),
        shape=a.shape,
    )


def to_dense(m) -> np.ndarray:
    """Densify any format (host-side, for tests/IO)."""
    n, mcols = m.shape
    out = np.zeros((n, mcols), dtype=np.asarray(jax.device_get(_vals_of(m))).dtype)
    if isinstance(m, Coo):
        r, c, v = (np.asarray(jax.device_get(x)) for x in (m.rows, m.cols, m.vals))
        np.add.at(out, (r, c), v)
    elif isinstance(m, Csr):
        rp, c, v = (np.asarray(jax.device_get(x)) for x in (m.row_ptr, m.cols, m.vals))
        r = np.repeat(np.arange(n), np.diff(rp))
        np.add.at(out, (r, c), v)
    elif isinstance(m, Ell):
        c, v = (np.asarray(jax.device_get(x)) for x in (m.cols, m.vals))
        r = np.repeat(np.arange(n)[:, None], c.shape[1], axis=1)
        np.add.at(out, (r.ravel(), c.ravel()), v.ravel())
    elif isinstance(m, Dia):
        d = np.asarray(jax.device_get(m.data))
        for k, off in enumerate(m.offsets):
            i = np.arange(n)
            j = i + off
            ok = (j >= 0) & (j < mcols)
            out[i[ok], j[ok]] += d[k, i[ok]]
    elif isinstance(m, Hybrid):
        out = to_dense(m.ell) + to_dense(m.coo)
    elif isinstance(m, Sell):
        for cb, vb, sr in zip(m.cols, m.vals, m.slot_rows):
            w = int(cb.shape[-1])
            c = np.asarray(jax.device_get(cb)).reshape(-1, w)
            v = np.asarray(jax.device_get(vb)).reshape(-1, w)
            rr = np.repeat(np.asarray(jax.device_get(sr)).astype(np.int64), w)
            live = rr < n  # pad slots park at row n; pad entries add 0
            np.add.at(out, (rr[live], c.reshape(-1)[live]), v.reshape(-1)[live])
    elif type(m).__name__ == "Xell":
        from ogl_tpu.kernels.xell import xell_to_coo

        out = to_dense(xell_to_coo(m))
    elif type(m).__name__ == "Gdia":
        v = np.asarray(jax.device_get(m.vals))  # (P, R, 128)
        l = np.asarray(jax.device_get(m.lidx)).astype(np.int64)
        lanes = v.shape[-1]
        rr = np.arange(v.shape[1])
        for p, qv in enumerate(m.plane_offsets):
            for blk in rr:
                src_blk = blk + qv
                if src_blk < 0 or src_blk * lanes >= mcols:
                    continue
                i = blk * lanes + np.arange(lanes)
                j = src_blk * lanes + l[p, blk]
                ok = (i < n) & (j < mcols) & (v[p, blk] != 0)
                np.add.at(out, (i[ok], j[ok]), v[p, blk][ok])
    else:
        raise TypeError(f"unknown format {type(m)}")
    return out


def _vals_of(m):
    if isinstance(m, Dia):
        return m.data
    if isinstance(m, Hybrid):
        return m.ell.vals
    if isinstance(m, Sell):
        return m.vals[0]
    return m.vals


def _host(m: Coo):
    return (
        np.asarray(jax.device_get(m.rows)),
        np.asarray(jax.device_get(m.cols)),
        np.asarray(jax.device_get(m.vals)),
    )


def coo_to_csr(m: Coo) -> Csr:
    rows, cols, vals = _host(m)
    n = m.shape[0]
    row_ptr = np.zeros(n + 1, np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    return Csr(
        row_ptr=jnp.asarray(row_ptr),
        cols=jnp.asarray(cols, jnp.int32),
        vals=jnp.asarray(vals),
        shape=m.shape,
    )


def ell_layout(rows: np.ndarray, n: int, width: int | None = None):
    """Per-entry (row, lane) destination for packing row-major COO into ELL.

    Returns (width, slot) where slot[i] is the lane of entry i within its row.
    The packing is order-preserving within a row, so ELL columns stay
    row-major sorted.
    """
    counts = np.bincount(rows, minlength=n)
    k = int(counts.max()) if width is None else width
    if width is not None and counts.max() > width:
        raise ValueError(f"row width {counts.max()} exceeds requested ELL width {width}")
    # position of each entry within its row (rows are sorted ascending)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows)) - starts[rows]
    return k, slot.astype(np.int64)


def coo_to_ell(m: Coo, width: int | None = None) -> Ell:
    rows, cols, vals = _host(m)
    n = m.shape[0]
    k, slot = ell_layout(rows, n, width)
    ecols = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)  # pad col = own row
    evals = np.zeros((n, k), dtype=vals.dtype)
    ecols[rows, slot] = cols
    evals[rows, slot] = vals
    return Ell(cols=jnp.asarray(ecols), vals=jnp.asarray(evals), shape=m.shape)


def coo_to_hybrid(m: Coo, width: int | None = None) -> "Hybrid":
    """Hybrid = ELL bulk + COO tail.  Entries up to `width` per row land in
    the ELL planes; overflow entries go to the row-major COO tail.  Width
    defaults to the 80th-percentile row length (bounds ELL padding waste on
    matrices with a few long rows)."""
    rows, cols, vals = _host(m)
    n = m.shape[0]
    counts = np.bincount(rows, minlength=n) if n else np.zeros(0, np.int64)
    if width is None:
        width = max(1, int(np.percentile(counts, 80))) if n else 1
    _, slot = ell_layout(rows, n)
    in_ell = slot < width
    ecols = np.repeat(np.arange(n, dtype=np.int32)[:, None], width, axis=1)
    evals = np.zeros((n, width), dtype=vals.dtype)
    ecols[rows[in_ell], slot[in_ell]] = cols[in_ell]
    evals[rows[in_ell], slot[in_ell]] = vals[in_ell]
    tail = ~in_ell
    return Hybrid(
        ell=Ell(cols=jnp.asarray(ecols), vals=jnp.asarray(evals), shape=m.shape),
        coo=Coo(rows=jnp.asarray(rows[tail].astype(np.int32)),
                cols=jnp.asarray(cols[tail].astype(np.int32)),
                vals=jnp.asarray(vals[tail]), shape=m.shape),
        shape=m.shape,
    )


def dia_layout(rows: np.ndarray, cols: np.ndarray, n: int):
    """Entry→slot layout for DIA packing: returns (offsets, dest) where
    dest[i] is the flat index of entry i into the (n_diags, n) data array.

    Diagonal offsets live in the small range [-(n-1), n-1], so their ranks
    come from a boolean presence table + short cumsum (O(nnz + n) with tiny
    constants) instead of np.unique's O(nnz log nnz) sort — this runs on
    10M+ entry arrays at setup and the sort dominated first-solve time."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) == 0 or n == 0:
        return (), np.zeros(0, np.int64)
    from ogl_tpu import native

    nat = native.dia_layout(rows, cols, n)
    if nat is not None:
        return nat
    shifted = np.subtract(cols, rows, dtype=np.int64)
    shifted += n - 1  # in [0, 2n-2]
    present = np.zeros(2 * n - 1, np.bool_)
    present[shifted] = True
    offs = np.flatnonzero(present)
    rank = np.cumsum(present, dtype=np.int64)
    rank -= 1  # rank[s] = index of offset s among the present ones
    dest = rank[shifted]
    dest *= n
    dest += rows
    return tuple(int(o) - (n - 1) for o in offs), dest


def coo_to_dia(m: Coo) -> Dia:
    rows, cols, vals = _host(m)
    n = m.shape[0]
    offs, dest = dia_layout(rows, cols, n)
    if vals.dtype == np.float32 and len(offs):
        from ogl_tpu import native

        data2 = native.dia_pack_f32(dest, vals, len(offs), n)
        if data2 is not None:
            return Dia(data=jnp.asarray(data2), offsets=offs, shape=m.shape)
    # bincount is a single vectorised pass; np.add.at's buffered scatter is
    # ~10x slower at the 10M-entry scale this runs at (duplicates still sum)
    data = np.bincount(dest, weights=vals.astype(np.float64),
                       minlength=len(offs) * n).astype(vals.dtype)
    return Dia(data=jnp.asarray(data.reshape(len(offs), n)), offsets=offs, shape=m.shape)


def sell_layout(rows: np.ndarray, n: int, slice_height: int = 8,
                sigma: int = 64, max_buckets: int = 8):
    """Deterministic SELL-C-σ layout from the row-major COO structure
    (shared by coo_to_sell and value_map so the steady-state update cannot
    drift from construction).

    σ-window descending-stable length sort → slices of C rows → per-slice
    width = its longest row → slices grouped into buckets by width.  If
    more than `max_buckets` distinct widths occur, widths round up to
    powers of two (bounding the bucket count at log2(max width), ≤2x
    padding overhead).

    Returns (widths, ns_of, dest, slot_rows, total): per-bucket widths and
    slice counts, the per-entry flat destination into the concatenated
    bucket storage, per-bucket original-row tables (pad slots -> n), and
    the total stored entry count."""
    C = slice_height
    counts = np.bincount(rows, minlength=n)
    order = np.arange(n)
    for s in range(0, n, sigma):
        w = order[s:s + sigma]
        order[s:s + sigma] = w[np.argsort(counts[w], kind="stable")[::-1]]
    n_slices = max(-(-n // C), 1)
    n_pad = n_slices * C
    perm = np.full(n_pad, -1, np.int64)
    perm[:n] = order
    counts_pad = np.zeros(n_pad, np.int64)
    counts_pad[:n] = counts[order]
    slice_w = np.maximum(counts_pad.reshape(n_slices, C).max(axis=1), 1)
    if len(np.unique(slice_w)) > max_buckets:
        slice_w = 2 ** np.ceil(np.log2(slice_w)).astype(np.int64)
    widths = [int(w) for w in np.unique(slice_w)]
    bucket_of = {w: b for b, w in enumerate(widths)}
    slice_bucket = np.array([bucket_of[int(w)] for w in slice_w], np.int64)
    pos_in_bucket = np.zeros(n_slices, np.int64)
    ns_of = []
    for b in range(len(widths)):
        sel = slice_bucket == b
        pos_in_bucket[sel] = np.arange(int(sel.sum()))
        ns_of.append(int(sel.sum()))
    base = np.zeros(len(widths) + 1, np.int64)
    base[1:] = np.cumsum([ns * C * w for ns, w in zip(ns_of, widths)])

    inv = np.zeros(n, np.int64)
    inv[order] = np.arange(n)
    _, slot = ell_layout(rows, n)
    p = inv[rows]
    s_of = p // C
    dest = (base[slice_bucket[s_of]]
            + (pos_in_bucket[s_of] * C + p % C) * slice_w[s_of] + slot)

    slot_rows = []
    for b in range(len(widths)):
        sl = np.nonzero(slice_bucket == b)[0]
        pr = perm[(sl[:, None] * C + np.arange(C)[None, :])].reshape(-1)
        slot_rows.append(np.where(pr >= 0, pr, n).astype(np.int32))
    return widths, ns_of, dest, slot_rows, int(base[-1])


def coo_to_sell(m: Coo, slice_height: int = 8, sigma: int = 64) -> Sell:
    """SELL-C-σ (see Sell/sell_layout): per-slice padding buckets, true
    sliced storage — SURVEY §7.2 'sliced-CSR sized for 8×128 lanes'."""
    rows, cols, vals = _host(m)
    n = m.shape[0]
    widths, ns_of, dest, slot_rows, total = sell_layout(
        rows, n, slice_height, sigma)
    flat_c = np.zeros(total, np.int64)  # pad col 0 (val 0 -> inert)
    flat_v = np.zeros(total, dtype=vals.dtype)
    flat_c[dest] = cols
    flat_v[dest] = vals
    cols_b, vals_b = [], []
    off = 0
    for w, ns in zip(widths, ns_of):
        k = ns * slice_height * w
        shape = (ns, slice_height, w)
        cols_b.append(jnp.asarray(flat_c[off:off + k].reshape(shape), jnp.int32))
        vals_b.append(jnp.asarray(flat_v[off:off + k].reshape(shape)))
        off += k
    return Sell(
        cols=tuple(cols_b),
        vals=tuple(vals_b),
        slot_rows=tuple(jnp.asarray(sr) for sr in slot_rows),
        shape=m.shape,
        slice_height=slice_height,
        sigma=sigma,
    )


def with_values(m, vals: Array):
    """Return the same-sparsity matrix with new values (the steady-state
    coefficient-update path; reference CsrMatrixWrapper.H:74-136 overwrites
    device value arrays in place — here the new value array slots into the
    same compiled sparsity)."""
    if isinstance(m, Dia):
        return dataclasses.replace(m, data=vals)
    if isinstance(m, Sell):
        # virtual flat storage = concatenated bucket blocks
        parts, off = [], 0
        for v in m.vals:
            k = int(np.prod(v.shape))
            parts.append(vals[off:off + k].reshape(v.shape))
            off += k
        return dataclasses.replace(m, vals=tuple(parts))
    if isinstance(m, Hybrid):
        # virtual flat storage: [ell.vals.flat ++ tail.vals]
        esize = m.ell.vals.size
        return dataclasses.replace(
            m,
            ell=dataclasses.replace(m.ell, vals=vals[:esize].reshape(m.ell.vals.shape)),
            coo=dataclasses.replace(m.coo, vals=vals[esize:]),
        )
    if type(m).__name__ == "Xell":
        # virtual flat storage: [vals.flat ++ spill.vals]
        msize = m.vals.size
        return dataclasses.replace(
            m,
            vals=vals[:msize].reshape(m.vals.shape),
            spill=dataclasses.replace(m.spill, vals=vals[msize:]),
        )
    return dataclasses.replace(m, vals=vals)


def values_flat(m) -> Array:
    """The virtual flat value storage `with_values` consumes, read back
    from a container (the incremental block-update path starts from the
    CURRENT values and overwrites only the changed entries)."""
    if isinstance(m, Dia):
        return m.data.reshape(-1)
    if isinstance(m, Sell):
        return jnp.concatenate([v.reshape(-1) for v in m.vals])
    if isinstance(m, Hybrid):
        return jnp.concatenate([m.ell.vals.reshape(-1), m.coo.vals])
    if type(m).__name__ == "Xell":
        return jnp.concatenate([m.vals.reshape(-1), m.spill.vals])
    return m.vals.reshape(-1)  # Coo/Csr/Ell/Gdia


@dataclasses.dataclass(frozen=True)
class BlockUpdatePlan:
    """One source block's slice of the steady-state value update: which
    container slots (`dest`) read which positions of the block (`src`).
    `dest is None` marks the affine case — the block maps onto one
    contiguous run starting at `dest_start` in block order (e.g. the LDU
    diag block onto the DIA main plane) — applied as a pure slice write.
    `src is None` means block order (src == arange)."""

    dest: Array | None  # int32 container slots; None = affine
    src: Array | None   # int32 positions within the block; None = identity
    dest_start: int
    length: int


def block_update_plans(vm: ValueMap, perm2, sizes) -> list | None:
    """Per-source-block incremental update plans for a ValueMap.

    `perm2` is the entry->source-position map the full update path applies
    (sparsity.permute, composed with any reorder entry_order; NOT a
    bijection — a symmetric matrix's upper block feeds both triangles) and
    `sizes` the raw LDU block sizes in source order.  In transient CFD only
    diag/RHS usually change per step (fixed mesh), yet the full path
    re-gathers and re-scatters ALL nnz entries; with these plans a step
    touches only the changed blocks' entries — and the diag block of a DIA
    container degenerates to one contiguous slice write.  Returns None when
    per-block set() is unsound (duplicate slots accumulate: vm.unique is
    False, matching ValueMap.update's .add branch)."""
    if not vm.unique:
        return None
    perm2 = np.asarray(perm2, np.int64)
    dest_all = (np.arange(len(perm2), dtype=np.int64) if vm.dest is None
                else np.asarray(jax.device_get(vm.dest), np.int64))
    if len(dest_all) != len(perm2):
        return None
    plans = []
    off = 0
    for size in sizes:
        q = np.flatnonzero((perm2 >= off) & (perm2 < off + size))
        src = perm2[q] - off
        d = dest_all[q]
        o = np.argsort(src, kind="stable")
        src, d = src[o], d[o]
        if (len(src) == size and np.array_equal(src, np.arange(size))
                and size and np.all(np.diff(d) == 1)):
            plans.append(BlockUpdatePlan(None, None, int(d[0]), int(size)))
        else:
            identity = (len(src) == size
                        and np.array_equal(src, np.arange(size)))
            plans.append(BlockUpdatePlan(
                jnp.asarray(d, jnp.int32),
                None if identity else jnp.asarray(src, jnp.int32),
                0, int(size)))
        off += size
    return plans


def cast_values(m, dtype):
    """Same-sparsity matrix with every floating leaf cast to `dtype`
    (index arrays untouched).  Works for any format pytree — used for
    reduced-precision operator storage (e.g. the bfloat16 inner operator
    of mixed-precision GKOIR): kernels accumulate in f32, so only the
    stored A-stream narrows."""
    return jax.tree_util.tree_map(
        lambda l: l.astype(dtype) if jnp.issubdtype(
            jnp.asarray(l).dtype, jnp.floating) else l,
        m,
    )


@_pytree
@dataclasses.dataclass(frozen=True)
class ValueMap:
    """Static entry→slot map making the steady-state coefficient update one
    jit'd scatter on device for EVERY format (the reference's in-place device
    value overwrite, CsrMatrixWrapper.H:74-136, generalised to the formats
    whose storage is a permutation of the COO entry order).

    `dest[i]` is the flat index of COO entry i in the format's value storage
    (None = the storage IS the entry order: Coo/Csr).  `unique` means no two
    entries share a slot, so the scatter is a set; otherwise duplicates are
    accumulated (matching the converters' np.add.at semantics)."""

    dest: Array | None
    out_shape: tuple = static_field()
    unique: bool = static_field()

    def update(self, m, coo_vals):
        """New container with same sparsity, values from the row-major COO
        entry array.  Pure jax — safe inside jit; zero host work."""
        if self.dest is None:
            return with_values(m, coo_vals)
        size = 1
        for s in self.out_shape:
            size *= int(s)
        flat = jnp.zeros(size, coo_vals.dtype)
        if self.unique:
            flat = flat.at[self.dest].set(coo_vals, unique_indices=True)
        else:
            flat = flat.at[self.dest].add(coo_vals)
        return with_values(m, flat.reshape(self.out_shape))


def value_map(m, rows, cols) -> ValueMap:
    """Build the ValueMap for container `m`, given the host COO structure
    (row-major sorted, the order `ldu.assemble_coeffs` emits values in).
    One-time setup; the returned map's `update` is the per-step path."""
    if isinstance(m, (Coo, Csr)):
        return ValueMap(dest=None, out_shape=(int(len(rows)),), unique=True)
    rows = np.asarray(jax.device_get(rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(cols)).astype(np.int64)
    n = m.shape[0]
    if isinstance(m, Ell):
        k, slot = ell_layout(rows, n, m.row_width)
        dest = rows * k + slot
        shape = (n, k)
    elif isinstance(m, Dia):
        offs, dest = dia_layout(rows, cols, n)
        if offs != m.offsets:
            raise ValueError("sparsity changed: DIA offsets do not match container")
        shape = (len(offs), n)
    elif isinstance(m, Sell):
        widths, ns_of, dest, _, total = sell_layout(
            rows, n, m.slice_height, m.sigma)
        got = [tuple(int(s) for s in v.shape) for v in m.vals]
        want = [(ns, m.slice_height, w) for ns, w in zip(ns_of, widths)]
        if got != want:
            raise ValueError(
                f"sparsity changed: SELL buckets {want} do not match "
                f"container {got}")
        shape = (total,)
    elif isinstance(m, Hybrid):
        w = m.ell.row_width
        _, slot = ell_layout(rows, n)
        in_ell = slot < w
        dest = np.empty(len(rows), np.int64)
        dest[in_ell] = rows[in_ell] * w + slot[in_ell]
        esize = int(m.ell.vals.size)
        dest[~in_ell] = esize + np.arange(int((~in_ell).sum()))
        shape = (esize + m.coo.nnz,)
    elif type(m).__name__ == "Gdia":
        from ogl_tpu.kernels.gdia import gdia_layout

        plane_offsets, _, dest, _ = gdia_layout(
            rows, cols, n, max_planes=max(64, len(m.plane_offsets)))
        if plane_offsets != m.plane_offsets:
            raise ValueError("sparsity changed: Gdia planes do not match container")
        shape = tuple(int(s) for s in m.vals.shape)
    elif type(m).__name__ == "Xell":
        from ogl_tpu.kernels.xell import xell_layout

        lay = xell_layout(rows, cols, n)
        if (lay.n_slots != m.n_slots or lay.c_chunks != m.c_chunks
                or int(lay.spill_sel.sum()) != m.spill.nnz):
            raise ValueError(
                "sparsity changed: Xell packing does not match container")
        dest = lay.dest
        shape = (int(m.vals.size) + m.spill.nnz,)
    else:
        raise TypeError(f"no value map for format {type(m)}")
    size = 1
    for s in shape:
        size *= s
    assert size < 2**31, "value storage too large for int32 slot indices"
    # duplicate-slot check without an nnz sort: mark-and-count
    seen = np.zeros(size, np.bool_)
    seen[dest] = True
    unique = int(seen.sum()) == len(dest)
    return ValueMap(
        dest=jnp.asarray(dest, jnp.int32), out_shape=shape, unique=unique
    )
