"""Xell — crossed-gather ELL for FULLY unstructured sparsity (the tier
Dia/Gdia cannot reach).

Gdia's planes are GLOBAL block-row offsets, so its plane count scales
with matrix bandwidth: an RCM'd random FV-graph (kNN-6, 1M cells) needs
hundreds of planes at single-digit fill.  Xell decomposes the arbitrary
gather x[c], c = 128*a + b, into two lane gathers crossed by one
transpose.  View vectors as (R, 128) [block a = sublane-row, residue
b = lane].  Per destination tile of 128 block-rows (16384 rows) and per
slot k:

  stage 1 (block select, transposed space):  on the transposed window
      chunks xwT[c] (128 residues x 128 window blocks) gather
      g1T[b, t] = xwT[.][b, bbT[k, b, t]]  — per residue b, pick the ONE
      source block slot k uses for destination block-row t;
  cross:  g1 = T(g1T);
  stage 2 (lane select, natural space):
      y[t, l] += vals[k, t, l] * g1[t, ll[k, t, l]].

Packing therefore needs, per slot k: (a) one entry per destination row
(t, l); (b) per (t, source-residue b) a single source block.  That is a
bipartite edge-colouring; first-fit greedy needs K ~= max row degree +
collision slack (K=17 covers 99.9% of a 1M kNN-6 graph).  The ~0.1% tail
spills to a COO side term.

Storage per slot: vals f32 (n), stage-2 lanes int8 (n), stage-1 blocks
int16 (n) = 7 B/slot-entry.  All shapes static; value updates ride the
same ValueMap scatter as every other format.  `spmv_xell` stacks the nt
tile windows, so its working memory grows with the window count.
Whether the format earns its place over Ell/Sell on the GPU, where
gathers are native, is open (ROADMAP design debt 1).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo, static_field, _pytree

LANES = 128
TB = 128  # block-rows per destination tile

__all__ = ["Xell", "xell_layout", "xell_from_coo", "spmv_xell",
           "xell_to_coo"]


@_pytree
@dataclasses.dataclass(frozen=True)
class Xell:
    """vals/ll: (NT, K, TB, LANES) destination-natural layout; bbT:
    (NT, K, LANES, TB) stage-1 block table in transposed (residue, t)
    layout, window-relative int16.  Unused slots: val 0, indices 0 (the
    window is zero-padded so garbage gathers multiply to 0).  spill: COO
    tail for entries beyond the slot cap (typically <0.2% of nnz)."""

    vals: jnp.ndarray
    ll: jnp.ndarray    # int8 stage-2 source lanes
    bbT: jnp.ndarray   # int16 stage-1 window-relative source blocks
    spill: Coo
    c_left: int = static_field()
    c_chunks: int = static_field()
    shape: tuple[int, int] = static_field()

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def n_slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def stored(self) -> int:
        return int(np.prod(self.vals.shape)) + self.spill.nnz


@dataclasses.dataclass(frozen=True)
class XellLayout:
    """Deterministic packing of a sparsity pattern (pure function of
    rows/cols/n — shared by `xell_from_coo` and the ValueMap rebuild so
    the steady-state value update cannot drift from the container)."""

    n_slots: int
    c_chunks: int
    c_left: int
    n_tiles: int
    dest: np.ndarray        # per entry (input order): flat slot in the
    #                         concat(vals.ravel(), spill_vals) value space
    spill_sel: np.ndarray   # bool per entry: landed in the COO spill
    bb_pos: np.ndarray      # main entries: flat position in bbT
    bb_val: np.ndarray      # main entries: int16 window-relative block
    ll_val: np.ndarray      # main entries: int8 source lane


def xell_layout(rows, cols, n: int, k_max: int = 32,
                spill_frac: float = 0.002, c_max: int = 6,
                force_slots: int | None = None,
                force_c_left: int | None = None,
                force_c_chunks: int | None = None) -> XellLayout:
    """First-fit greedy slot assignment (the bipartite edge-colouring of
    the module docstring), fully vectorised: one pre-sort by destination
    row, then one O(nnz) pass per slot.  Raises when the window span
    exceeds `c_max` chunks (renumber with core.reorder.rcm_permutation) or
    when more than 20% of entries would spill (pathological sparsity —
    Xell is the wrong format; the caller should fail loudly rather than
    fall to the XLA-gather tier).

    force_slots / force_c_left / force_c_chunks pin the data-dependent
    statics to externally-agreed values (>= this pattern's own needs):
    SPMD stacks (dist.partition XellStack) require every shard — and, in
    multi-process builds, every process — to land on identical program
    shapes.  Forcing never changes the greedy assignment, only the
    slot arithmetic and the window framing."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nnz = len(rows)
    nb = max(math.ceil(n / LANES), 1)
    nt = max(math.ceil(nb / TB), 1)

    a_d, l_d = rows // LANES, rows % LANES
    a_s, b_s = cols // LANES, cols % LANES
    tile, t_in = a_d // TB, a_d % TB
    wrel = a_s - tile * TB
    c_left = int(max(0, math.ceil(-min(wrel.min(), 0) / 128))) if nnz else 0
    if force_c_left is not None:
        if force_c_left < c_left:
            raise ValueError(
                f"force_c_left={force_c_left} < required {c_left}")
        c_left = force_c_left
    right_span = int(wrel.max()) + 1 if nnz else 1
    c_chunks = c_left + max(math.ceil(right_span / 128), 1)
    if force_c_chunks is not None:
        if force_c_chunks < c_chunks:
            raise ValueError(
                f"force_c_chunks={force_c_chunks} < required {c_chunks}")
        c_chunks = force_c_chunks
    if c_chunks > c_max:
        raise ValueError(
            f"Xell window needs {c_chunks} chunks (> {c_max}): matrix "
            f"bandwidth too large — renumber (core.reorder.rcm_permutation) "
            "or raise c_max")
    wloc = (wrel + c_left * 128).astype(np.int16)

    # greedy rounds: per round take the first unassigned entry of every
    # destination row, then keep only one source block per (t, residue)
    slot = np.full(nnz, -1, np.int32)
    if nnz:
        po = np.argsort(rows, kind="stable")       # group by dest row
        pk = rows[po]
        new_grp = np.r_[True, pk[1:] != pk[:-1]]
        starts = np.flatnonzero(new_grp)
        inv_po = np.empty(nnz, np.int64)
        inv_po[po] = np.arange(nnz)
        tb_key = a_d * LANES + b_s                  # (tile, t, residue)
        alive = np.ones(nnz, bool)                  # po-order
        idx = np.arange(nnz)
        big = nnz
        target = max(int(spill_frac * nnz), 0)
        remaining = nnz
        for k in range(k_max):
            if remaining <= target:
                break
            first = np.minimum.reduceat(np.where(alive, idx, big), starts)
            first = first[first < big]
            cand = po[first]
            # (b): among this round's candidates, one source block per
            # (t, residue) group — the leader's block wins; same-block
            # followers ride along (they occupy different dest rows)
            o2 = np.argsort(tb_key[cand], kind="stable")
            cs = cand[o2]
            tks = tb_key[cs]
            lead = np.r_[True, tks[1:] != tks[:-1]]
            grp = np.cumsum(lead) - 1
            lead_blk = a_s[cs[lead]][grp]
            chosen = cs[lead | (a_s[cs] == lead_blk)]
            slot[chosen] = k
            alive[inv_po[chosen]] = False
            remaining -= len(chosen)
        if remaining > max(target, int(0.2 * nnz)):
            raise ValueError(
                f"Xell packing left {remaining}/{nnz} entries after "
                f"{k_max} slots: sparsity too irregular for the Xell format "
                "(raise k_max or renumber)")

    k_used = int(slot.max()) + 1 if nnz else 0
    k_used = max(k_used, 1)
    if force_slots is not None:
        if force_slots < k_used:
            raise ValueError(f"force_slots={force_slots} < required {k_used}")
        k_used = force_slots
    main = slot >= 0
    main_size = nt * k_used * TB * LANES
    dest = np.empty(nnz, np.int64)
    dest[main] = (((tile[main] * k_used + slot[main]) * TB + t_in[main])
                  * LANES + l_d[main])
    n_spill = int((~main).sum())
    dest[~main] = main_size + np.arange(n_spill)
    bb_pos = (((tile[main] * k_used + slot[main]) * LANES + b_s[main])
              * TB + t_in[main])
    return XellLayout(
        n_slots=k_used, c_chunks=c_chunks, c_left=c_left, n_tiles=nt,
        dest=dest, spill_sel=~main, bb_pos=bb_pos, bb_val=wloc[main],
        ll_val=b_s[main].astype(np.int8))


def xell_from_coo(coo: Coo, k_max: int = 32, spill_frac: float = 0.002,
                  c_max: int = 6) -> Xell:
    n = coo.shape[0]
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals))
    lay = xell_layout(rows, cols, n, k_max=k_max, spill_frac=spill_frac,
                      c_max=c_max)
    nt, k = lay.n_tiles, lay.n_slots
    main_size = nt * k * TB * LANES
    v = np.zeros(main_size, vals.dtype)
    llv = np.zeros(main_size, np.int8)
    bbv = np.zeros(nt * k * LANES * TB, np.int16)
    main = ~lay.spill_sel
    v[lay.dest[main]] = vals[main]
    llv[lay.dest[main]] = lay.ll_val
    bbv[lay.bb_pos] = lay.bb_val
    sp = lay.spill_sel
    spill = Coo(rows=jnp.asarray(rows[sp], jnp.int32),
                cols=jnp.asarray(cols[sp], jnp.int32),
                vals=jnp.asarray(vals[sp]), shape=coo.shape)
    return Xell(
        vals=jnp.asarray(v.reshape(nt, k, TB, LANES)),
        ll=jnp.asarray(llv.reshape(nt, k, TB, LANES)),
        bbT=jnp.asarray(bbv.reshape(nt, k, LANES, TB)),
        spill=spill, c_left=lay.c_left, c_chunks=lay.c_chunks,
        shape=coo.shape)


def xell_to_coo(m: Xell) -> Coo:
    """Host-side structural inverse (tests/export): occupancy is recovered
    as (val != 0) | (source lane != 0), so a STORED entry whose coefficient
    is exactly 0.0 survives the round trip unless its source lane is also
    lane 0 — that residual 1/128 case is indistinguishable from padding in
    the packed tables (advisor r04; padding carries val 0 / ll 0 / bb 0 by
    construction).  Zero-valued entries are numerically inert either way;
    only export/structure diagnostics see the difference."""
    nt, k = int(m.vals.shape[0]), int(m.vals.shape[1])
    vals = np.asarray(jax.device_get(m.vals))
    ll = np.asarray(jax.device_get(m.ll)).astype(np.int64)
    bbT = np.asarray(jax.device_get(m.bbT)).astype(np.int64)
    occupied = (vals != 0) | (ll != 0)
    sl, t, l = np.nonzero(occupied.reshape(nt * k, TB, LANES))
    tile = sl // k
    rows = (tile * TB + t) * LANES + l
    b = ll.reshape(nt * k, TB, LANES)[sl, t, l]
    wblk = bbT.reshape(nt * k, LANES, TB)[sl, b, t]
    cols = (tile * TB + wblk - m.c_left * 128) * LANES + b
    out_v = vals.reshape(nt * k, TB, LANES)[sl, t, l]
    rows = np.concatenate([rows, np.asarray(jax.device_get(m.spill.rows), np.int64)])
    cols = np.concatenate([cols, np.asarray(jax.device_get(m.spill.cols), np.int64)])
    out_v = np.concatenate([out_v, np.asarray(jax.device_get(m.spill.vals))])
    order = np.lexsort((cols, rows))
    return Coo(rows=rows[order].astype(np.int32),
               cols=cols[order].astype(np.int32),
               vals=out_v[order], shape=m.shape)


def _pad_x(m: Xell, x):
    n = m.shape[0]
    nt = int(m.vals.shape[0])
    c = m.c_chunks
    total = (nt + c - 1) * TB * LANES
    body = jnp.pad(jnp.asarray(x), (0, nt * TB * LANES - n))
    left = m.c_left * 128 * LANES
    return jnp.pad(body, (left, total - left - body.shape[0])).reshape(-1, LANES)


def spmv_xell(m: Xell, x):
    """y = A @ x through the two crossed gathers (module docstring)."""
    n = m.shape[0]
    nt, k = int(m.vals.shape[0]), int(m.vals.shape[1])
    c = m.c_chunks
    xpad = _pad_x(m, x)  # ((nt+c-1)*TB, LANES)
    win = jnp.stack([
        jax.lax.dynamic_slice_in_dim(xpad, i * TB, c * TB, axis=0)
        for i in range(nt)])                       # (nt, c*TB, LANES)
    win_t = jnp.swapaxes(win, 1, 2)                # (nt, LANES, c*TB)
    acc = jnp.zeros((nt, TB, LANES), x.dtype)
    for kk in range(k):
        g1t = jnp.take_along_axis(win_t, m.bbT[:, kk].astype(jnp.int32),
                                  axis=2)          # (nt, LANES, TB)
        g1 = jnp.swapaxes(g1t, 1, 2)               # (nt, TB, LANES)
        g = jnp.take_along_axis(g1, m.ll[:, kk].astype(jnp.int32), axis=2)
        acc = acc + m.vals[:, kk].astype(x.dtype) * g
    y = acc.reshape(-1)[:n]
    if int(m.spill.vals.shape[0]):
        prod = m.spill.vals.astype(x.dtype) * jnp.take(x, m.spill.cols, axis=0)
        y = y + jax.ops.segment_sum(prod, m.spill.rows, num_segments=n)
    return y
