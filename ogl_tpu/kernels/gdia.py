"""Gdia — generalized block-row DIA with lane indices: a banded
unstructured SpMV format.

Gdia keeps row alignment STATIC and lane addressing DYNAMIC:

  view vectors as (R, 128);  an entry (dst, src) has
    q = src//128 − dst//128   (block-row offset — static class)
    l = src%128               (source lane — per-entry data)

  storage: for each (q, plane) a pair of (R,128) streams — values and
  int8 lane indices (multiple entries hitting the same destination slot
  in the same class spill to extra planes);

  SpMV per plane:  acc += vals ⊙ lane_gather(row_shift(x, q), lidx)

The plane count is bounded by the matrix bandwidth in 128-row blocks
(+ collision multiplicity), so bandwidth-reducing renumbering
(core/reorder.rcm_permutation — OpenFOAM's renumberMesh analogue) is the
setup-time companion.  Structured stencils need ~9 planes (vs 7 Dia
diagonals); Dia remains the cheaper special case (no index stream).
Whether the format earns its place over Ell/Sell on the GPU is open
(ROADMAP design debt 1).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo, static_field, _pytree

LANES = 128

__all__ = ["Gdia", "gdia_from_coo", "gdia_layout", "gdia_requirements",
           "spmv_gdia"]


@_pytree
@dataclasses.dataclass(frozen=True)
class Gdia:
    """vals/lidx: (n_planes, R, 128); plane_offsets[p] = block-row offset q.
    Unused slots: val 0, lane idx 0.  Lane indices are int8 (< 128), cast
    to int32 at use — cuts the index-stream HBM traffic 4×."""

    vals: jnp.ndarray
    lidx: jnp.ndarray  # int8 source lanes
    plane_offsets: tuple[int, ...] = static_field()
    shape: tuple[int, int] = static_field()

    @property
    def dtype(self):
        return self.vals.dtype


def gdia_requirements(rows, cols, n: int) -> dict[int, int]:
    """Per-block-row-offset plane multiplicity this sparsity needs — the
    structural metadata a stacked multi-shard packing unifies (max per q
    across shards)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rd, ld = rows // LANES, rows % LANES
    q = (cols // LANES) - rd
    out: dict[int, int] = {}
    for qv in np.unique(q):
        sel = q == qv
        dst = rd[sel] * LANES + ld[sel]
        out[int(qv)] = int(np.bincount(dst - dst.min()).max()) if len(dst) else 0
    return out


def gdia_layout(rows, cols, n: int, max_planes: int = 64, plane_table=None):
    """Entry→slot layout for Gdia packing.

    Returns (plane_offsets, r, dest, lanes): entry i goes to flat position
    dest[i] of the (n_planes, r, 128) storage, with source lane lanes[i].
    Shared by `gdia_from_coo` and the steady-state value-update path
    (core.formats.value_map) so both agree on plane assignment.

    plane_table: an externally-agreed plane_offsets tuple (q repeated by
    multiplicity, ascending q) — stacked multi-shard packings must share
    one table; raises if this sparsity does not fit it."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    r = max(math.ceil(n / LANES), 1)
    rd, ld = rows // LANES, rows % LANES
    rs, ls = cols // LANES, cols % LANES
    q = rs - rd

    base_of: dict[int, tuple[int, int]] = {}
    if plane_table is not None:
        for k, qv in enumerate(plane_table):
            b, c = base_of.get(int(qv), (k, 0))
            base_of[int(qv)] = (b, c + 1)

    plane_offsets: list[int] = []
    dest = np.zeros(len(rows), np.int64)
    plane_base = 0
    for qv in np.unique(q):
        sel = np.nonzero(q == qv)[0]
        # plane index = running occurrence count per destination slot
        dst = rd[sel] * LANES + ld[sel]
        order = np.argsort(dst, kind="stable")
        sel = sel[order]
        dst = dst[order]
        starts = np.searchsorted(dst, dst)  # first occurrence index
        plane_of = np.arange(len(dst)) - starts
        n_p = int(plane_of.max()) + 1 if len(dst) else 0
        if plane_table is not None:
            if int(qv) not in base_of or n_p > base_of[int(qv)][1]:
                raise ValueError(
                    f"sparsity does not fit the agreed Gdia plane table: "
                    f"offset {int(qv)} needs {n_p} planes, table has "
                    f"{base_of.get(int(qv), (0, 0))[1]}")
            dest[sel] = (base_of[int(qv)][0] + plane_of) * (r * LANES) + dst
        else:
            dest[sel] = (plane_base + plane_of) * (r * LANES) + dst
            plane_offsets.extend([int(qv)] * n_p)
            plane_base += n_p
    if plane_table is not None:
        plane_offsets = [int(qv) for qv in plane_table]
    if len(plane_offsets) > max_planes:
        raise ValueError(
            f"Gdia needs {len(plane_offsets)} planes (> {max_planes}); matrix "
            "bandwidth too large — renumber (core.reorder.rcm_permutation) "
            "or raise max_planes"
        )
    if not plane_offsets:
        plane_offsets = [0]
    return tuple(plane_offsets), r, dest, ls.astype(np.int8)


def gdia_from_coo(coo: Coo, max_planes: int = 64) -> Gdia:
    """Host-side packing.  Raises if the plane count exceeds max_planes —
    renumber with core.reorder.rcm_permutation first."""
    n = coo.shape[0]
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals))
    plane_offsets, r, dest, lanes = gdia_layout(rows, cols, n, max_planes)
    np_ = len(plane_offsets)
    v = np.zeros(np_ * r * LANES, vals.dtype)
    l = np.zeros(np_ * r * LANES, np.int8)
    v[dest] = vals
    l[dest] = lanes
    return Gdia(
        vals=jnp.asarray(v.reshape(np_, r, LANES)),
        lidx=jnp.asarray(l.reshape(np_, r, LANES)),
        plane_offsets=plane_offsets,
        shape=coo.shape,
    )


def spmv_gdia(m: Gdia, x):
    """y = A @ x: one static row shift and one lane gather per plane."""
    n = m.shape[0]
    r = m.vals.shape[1]
    qmax = max((abs(qv) for qv in m.plane_offsets), default=0)
    x2 = jnp.pad(x, (0, r * LANES - n)).reshape(r, LANES)
    xp = jnp.pad(x2, ((qmax, qmax), (0, 0)))
    acc = jnp.zeros((r, LANES), x.dtype)
    for p, qv in enumerate(m.plane_offsets):
        shifted = jax.lax.dynamic_slice_in_dim(xp, qmax + qv, r, axis=0)
        g = jnp.take_along_axis(shifted, m.lidx[p].astype(jnp.int32), axis=1)
        acc = acc + m.vals[p].astype(x.dtype) * g
    return acc.reshape(-1)[:n]
