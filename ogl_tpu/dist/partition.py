"""Mesh-decomposition partitioning and the halo-exchange plan.

The reference realises distribution as one matrix shard per MPI rank with a
`localized_partition` + `sparse_communicator` doing neighbor sends during
SpMV (Partition.H:57-70, CsrMatrixWrapper.H:163-210, and the
CommunicationPattern built from processor interfaces, HostMatrix.C:252-306).

Re-design (SURVEY.md §2c mapping):
  * shards live on a jax.sharding.Mesh axis; every per-shard array is
    stacked on a leading parts axis and shard_map'd;
  * the communication pattern compiles to a STATIC schedule of
    `lax.ppermute` rounds — one per ring-offset class d=(dst−src) mod P —
    so a 1/2/3-D domain decomposition needs only a handful of permutes,
    which XLA hands to NCCL;
  * the LOCAL (volume-sized) operator is stored per shard in a device
    format stacked on the parts axis: DIA with the union of diagonal
    offsets across shards (gather-free SpMV — the reference's device-fast
    inner formats, CsrMatrixWrapper.H:138-161) with an ELL fallback for
    unstructured shards;
  * the NON-LOCAL (surface-sized) halo matrix is stored as per-shard COO
    triplets whose columns index the halo buffer — its apply is a
    surface-sized gather+segment-sum, not a volume-sized gather.

All shapes are padded uniform across shards (SPMD requires identical local
programs); pads are numerically inert (zero values, parked indices).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo, Dia, Ell, static_field, _pytree

__all__ = [
    "DistMatrix",
    "HaloPlan",
    "DiaStack",
    "GdiaStack",
    "XellStack",
    "EllStack",
    "CooStack",
    "pack_local_stack",
    "pack_halo_stack",
    "shard_local_matrix",
    "partition_coo",
    "split_vector",
    "gather_global",
]


@_pytree
@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static ppermute schedule.  For each ring offset d (static tuple):
    send_idx[k]: (P, S_k) local row indices to ship to rank (i+d) mod P
    recv_pos[k]: (P, S_k) halo-buffer slots for data arriving from
                 (i−d) mod P; pads park at slot `halo_size` (sliced off).

    send_affine/recv_affine: per-class AffineRuns (dist.affine) when every
    class's index sets decompose into uniform arithmetic runs — the
    gather-free route (slices + lane one-hot matmuls); None falls back to
    the generic gather route."""

    send_idx: tuple  # tuple of (P, S_k) int32 arrays
    recv_pos: tuple  # tuple of (P, S_k) int32 arrays
    offsets: tuple[int, ...] = static_field()
    halo_size: int = static_field()
    n_parts: int = static_field()
    send_affine: tuple | None = None
    recv_affine: tuple | None = None


@_pytree
@dataclasses.dataclass(frozen=True)
class DiaStack:
    """Per-shard DIA local blocks stacked on the parts axis, sharing the
    UNION of diagonal offsets (static, identical program per shard)."""

    data: jnp.ndarray  # (P, n_diags, n_local)
    offsets: tuple[int, ...] = static_field()


@_pytree
@dataclasses.dataclass(frozen=True)
class GdiaStack:
    """Per-shard Gdia local blocks stacked on the parts axis, sharing a
    UNION plane table (per block-row offset q: the max plane multiplicity
    any shard needs) — the banded unstructured local format
    (kernels/gdia.py) for shards too wide for DIA."""

    vals: jnp.ndarray  # (P, n_planes, R, 128)
    lidx: jnp.ndarray  # (P, n_planes, R, 128) int8 source lanes
    plane_offsets: tuple[int, ...] = static_field()


@_pytree
@dataclasses.dataclass(frozen=True)
class XellStack:
    """Per-shard Xell (crossed-gather, kernels/xell.py) local blocks
    stacked on the parts axis — the distributed fast tier for FULLY
    unstructured shards.  All shards share the UNION statics
    (n_slots, window framing, spill width) so the shard program is
    identical (SPMD); multi-process builds agree through the structure
    hook.  The value leaf is ONE flat (P, main + spill_e) array — main
    slot values followed by spill values — so the steady-state value
    update (DistAssembler / _assemble_values) treats it like any other
    stack; ll/bbT/spill indices are structure, constant across updates."""

    vals: jnp.ndarray        # (P, NT*K*TB*LANES + spill_e)
    ll: jnp.ndarray          # (P, NT, K, TB, LANES) int8 stage-2 lanes
    bbT: jnp.ndarray         # (P, NT, K, LANES, TB) int16 stage-1 blocks
    spill_rows: jnp.ndarray  # (P, spill_e) int32 (pads: row 0 / col 0 /
    spill_cols: jnp.ndarray  # (P, spill_e) int32   val 0 — inert)
    n_slots: int = static_field()
    c_left: int = static_field()
    c_chunks: int = static_field()
    n_tiles: int = static_field()
    spill_e: int = static_field()


@_pytree
@dataclasses.dataclass(frozen=True)
class EllStack:
    """Per-shard ELL local blocks (pad cols point at the row itself,
    val 0)."""

    cols: jnp.ndarray  # (P, n_local, K)
    vals: jnp.ndarray


@_pytree
@dataclasses.dataclass(frozen=True)
class CooStack:
    """Per-shard COO triplets (the halo matrix: surface-sized).  Pad
    entries carry row = 0, col = 0, val = 0 — numerically inert ONLY
    because the value is zero (consumers scatter-add val*x, so pads
    contribute 0 to row 0); dm.halo_sizes records the true counts."""

    rows: jnp.ndarray  # (P, E) int32
    cols: jnp.ndarray  # (P, E) int32 — halo-buffer slots
    vals: jnp.ndarray  # (P, E)


@_pytree
@dataclasses.dataclass(frozen=True)
class DistMatrix:
    """Sharded matrix: stacked per-shard local operator (fast format) plus
    per-shard non-local COO (cols = halo-buffer slots) and the halo plan."""

    local: DiaStack | EllStack
    halo: CooStack
    plan: HaloPlan
    n_local: int = static_field()
    local_sizes: tuple[int, ...] = static_field()  # true rows per shard
    global_n: int = static_field()
    # true non-local entry count per shard (halo stacks are padded; pads
    # carry value 0 but a 0-VALUED live entry is still a live entry)
    halo_sizes: tuple[int, ...] = static_field(default=())
    # AffineRuns over the halo-entry ROWS (slots sequential) when the
    # non-local structure is affine — enables the slice/matmul halo apply
    apply_affine: object = None

    @property
    def n_parts(self) -> int:
        return len(self.local_sizes)

    @property
    def dtype(self):
        if isinstance(self.local, DiaStack):
            return self.local.data.dtype
        return self.local.vals.dtype


# -----------------------------------------------------------------------------
# packing (host-side setup)
# -----------------------------------------------------------------------------


def _dia_union_offsets(shards, max_diags: int = 64):
    """Union of diagonal offsets across shards, or None if too wide for DIA."""
    offs: set[int] = set()
    for rows, cols, _ in shards:
        if len(rows):
            offs |= set(np.unique(np.asarray(cols, np.int64) - np.asarray(rows, np.int64)).tolist())
    if not offs:
        offs = {0}
    if len(offs) > max_diags:
        return None
    return tuple(sorted(int(o) for o in offs))


# Structure-agreement hook (multi-process builds): pack_local_stack's
# static shapes (DIA offsets / ELL width / entry count) are data-dependent;
# when processes pack only their local shards, every process must land on
# the SAME shapes.  dist.multiproc installs a hook that allgathers and
# unifies the locally computed structure; pack call order is deterministic,
# so the collectives line up across processes.
_STRUCT_AGREE_HOOK = None


def set_struct_agree_hook(hook):
    """Install (or clear, with None) the structure-agreement hook; returns
    the previous hook so callers can restore it."""
    global _STRUCT_AGREE_HOOK
    prev = _STRUCT_AGREE_HOOK
    _STRUCT_AGREE_HOOK = hook
    return prev


def pack_local_stack(shards, n_local: int, dtype, fmt: str = "auto",
                     max_diags: int = 64, force_offsets=None,
                     force_width: int | None = None,
                     force_entries: int | None = None):
    """Pack per-shard (rows, cols, vals) triples into a stacked local
    operator.  Returns (stack, dest) where dest is the per-shard entry→slot
    map (P, E) into the flattened per-shard storage, for the jit'd
    steady-state value update (pad entries map to the last parking slot).

    fmt: "auto" (Dia if the union of offsets is narrow, else Ell),
    "Dia", or "Ell".

    force_offsets / force_width / force_entries pin the static shapes to
    externally-agreed values — multi-process construction packs only the
    locally-owned shards, and every process must produce identical
    program shapes (the globally allgathered union).
    """
    if fmt not in ("auto", "Dia", "Gdia", "Xell", "Ell"):
        raise ValueError(
            f"unknown local format {fmt!r}; use auto|Dia|Gdia|Xell|Ell")
    p = len(shards)
    e = max((len(r) for r, _, _ in shards), default=0)
    e = max(force_entries or 0, e, 1)
    if force_offsets is not None:
        offs = tuple(int(o) for o in force_offsets)
    else:
        offs = _dia_union_offsets(shards, max_diags) if fmt in ("auto", "Dia") else None
    if _STRUCT_AGREE_HOOK is not None and force_offsets is None:
        # widths are only needed when the agreed structure is Ell
        k_local = 1
        for rows, _, _ in shards:
            if len(rows):
                k_local = max(k_local, int(np.bincount(
                    np.asarray(rows, np.int64)).max()))
        offs, k_agreed, e = _STRUCT_AGREE_HOOK(
            "dia", offs, k_local, e, max_diags)
        force_width = max(force_width or 1, k_agreed)
    if fmt == "Dia" and offs is None:
        raise ValueError(f"shard bandwidth too wide for Dia (> {max_diags} offsets)")
    if fmt in ("Gdia", "Xell", "Ell"):
        offs = None  # explicit format: skip the Dia tier

    if offs is not None:
        nd = len(offs)
        size = nd * n_local
        assert size < 2**31, "value storage too large for int32 slot indices"
        data = np.zeros((p, size + 1), dtype)
        dest = np.full((p, e), size, np.int32)  # parking slot
        offs_arr = np.asarray(offs, np.int64)
        for i, (rows, cols, vals) in enumerate(shards):
            if not len(rows):
                continue
            rows = np.asarray(rows, np.int64)
            cols = np.asarray(cols, np.int64)
            d_ids = np.searchsorted(offs_arr, cols - rows)
            dst = d_ids * n_local + rows
            np.add.at(data[i], dst, vals)
            dest[i, : len(rows)] = dst
        stack = DiaStack(
            data=jnp.asarray(data[:, :size].reshape(p, nd, n_local)),
            offsets=offs,
        )
        return stack, jnp.asarray(dest)

    # ---- Gdia tier: banded unstructured shards (lane gathers) — shards
    # share a UNION plane table (per block-row offset q
    # the max plane multiplicity any shard needs); multi-process packs
    # agree on the table through the hook.
    if fmt in ("auto", "Gdia"):
        from ogl_tpu.kernels.gdia import (
            LANES as _L,
            gdia_layout,
            gdia_requirements,
        )

        req: dict[int, int] = {}
        for rows, cols, _ in shards:
            if len(rows):
                for qv, c in gdia_requirements(rows, cols, n_local).items():
                    req[qv] = max(req.get(qv, 0), c)
        if _STRUCT_AGREE_HOOK is not None:
            req = _STRUCT_AGREE_HOOK("gdia", req)
        table = tuple(qv for qv in sorted(req) for _ in range(req[qv])) or (0,)
        max_planes_g = 48
        if len(table) > max_planes_g:
            if fmt == "Gdia":
                raise ValueError(
                    f"shards need {len(table)} Gdia planes (> {max_planes_g});"
                    " renumber (core.reorder.rcm_permutation) first")
        else:
            r = max(-(-n_local // _L), 1)
            n_planes = len(table)
            size = n_planes * r * _L
            assert size < 2**31, "value storage too large for int32 slots"
            vals_s = np.zeros((p, size), dtype)
            lidx_s = np.zeros((p, size), np.int8)
            dest = np.full((p, e), size, np.int32)
            for i, (rows, cols, vals) in enumerate(shards):
                if not len(rows):
                    continue
                _, _, d, lanes = gdia_layout(
                    rows, cols, n_local, max_planes=max_planes_g,
                    plane_table=table)
                vals_s[i][d] = vals
                lidx_s[i][d] = lanes
                dest[i, : len(rows)] = d
            stack = GdiaStack(
                vals=jnp.asarray(vals_s.reshape(p, n_planes, r, _L)),
                lidx=jnp.asarray(lidx_s.reshape(p, n_planes, r, _L)),
                plane_offsets=table,
            )
            return stack, jnp.asarray(dest)

    # ---- Xell tier: fully unstructured shards (crossed-gather kernel,
    # kernels/xell.py) — the distributed twin of pack_fast's third rung.
    # Gated to shards large enough that the XLA-gather Ell tier would be
    # catastrophic; explicit fmt="Xell" packs at any size.
    if fmt in ("auto", "Xell") and (fmt == "Xell"
                                    or n_local >= _XELL_MIN_ROWS):
        try:
            return _pack_xell_stack(shards, n_local, dtype, e)
        except ValueError as ex:
            if fmt == "Xell":
                raise
            _warn_ell_landing(n_local, ex)

    # ELL fallback
    k = force_width or 1
    for rows, _, _ in shards:
        if len(rows):
            k = max(k, int(np.bincount(np.asarray(rows, np.int64)).max()))
    size = n_local * k
    assert size < 2**31, "value storage too large for int32 slot indices"
    ecols = np.zeros((p, n_local, k), np.int32)
    ecols[:] = np.arange(n_local, dtype=np.int32)[None, :, None]  # pad col = own row
    evals = np.zeros((p, n_local, k), dtype)
    dest = np.full((p, e), size, np.int32)
    for i, (rows, cols, vals) in enumerate(shards):
        if not len(rows):
            continue
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        # slot computation needs row-major order; callers pass factor /
        # inverse triples in arbitrary order (e.g. transposed or
        # column-major), so sort here and map dest back to ENTRY order
        order = np.lexsort((cols, rows))
        rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
        counts = np.bincount(rows_s, minlength=n_local)
        starts = np.zeros(n_local + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(len(rows_s)) - starts[rows_s]
        ecols[i, rows_s, slot] = cols_s.astype(np.int32)
        evals[i, rows_s, slot] = vals_s
        dst = np.empty(len(rows), np.int32)
        dst[order] = (rows_s * k + slot).astype(np.int32)
        dest[i, : len(rows)] = dst
    return EllStack(cols=jnp.asarray(ecols), vals=jnp.asarray(evals)), jnp.asarray(dest)


# shards at/above this row count land on the Xell tier (or warn loudly if
# they can't): below it the XLA-gather Ell tier is tolerable, above it the
# solve is orders of magnitude off roofline (mirrors kernels/spmv.py's
# single-device gate; module-level so tests can exercise the warning
# without building 32k-row shards)
_XELL_MIN_ROWS = 1 << 15


def _warn_ell_landing(n_local: int, cause):
    """The distributed twin of the single-device warning at
    kernels/spmv.py pack_fast."""
    import warnings

    why = f" (Xell stack packing failed: {cause})" if cause else ""
    warnings.warn(
        f"pack_local_stack: {n_local}-row shards fell to the Ell "
        f"tier{why} — renumber the mesh (reorder='rcm' /"
        " decomposition='scotch') or raise the Xell window budget",
        RuntimeWarning, stacklevel=3)


def _pack_xell_stack(shards, n_local: int, dtype, e: int):
    """Pack per-shard triples into an XellStack + dest map.  Two passes:
    a trial layout per shard discovers each shard's statics; the union
    (agreed across processes through the structure hook — EVERY process
    must take the same success/fallback branch, so the ok flag is agreed
    too) is then forced back onto every shard so the stacked program
    shapes are identical."""
    from ogl_tpu.kernels import xell as xk

    p = len(shards)
    ok, cause = True, None
    # c_left and the RIGHT-chunk count unionise independently (a shard
    # skewed left and one skewed right can each fit c_max while their
    # naive max(c_chunks) does not cover c_left_union + own_right — the
    # forced second pass would then fail on one shard/process only,
    # diverging the SPMD program structure across processes)
    k = c_left = c_right = spill_e = 0
    nb = max(-(-n_local // xk.LANES), 1)
    nt = max(-(-nb // xk.TB), 1)
    try:
        for rows, cols, _ in shards:
            if not len(rows):
                continue
            lay = xk.xell_layout(rows, cols, n_local)
            k = max(k, lay.n_slots)
            c_left = max(c_left, lay.c_left)
            c_right = max(c_right, lay.c_chunks - lay.c_left)
            spill_e = max(spill_e, int(lay.spill_sel.sum()))
            nt = lay.n_tiles
    except ValueError as ex:
        ok, cause = False, ex
    if _STRUCT_AGREE_HOOK is not None:
        ok, k, c_left, c_right, spill_e = _STRUCT_AGREE_HOOK(
            "xell", ok, k, c_left, c_right, spill_e)
    if not ok:
        raise ValueError(
            f"Xell stack packing failed on at least one shard"
            f"{f': {cause}' if cause else ' (another process)'}")
    k = max(k, 1)
    c_chunks = c_left + max(c_right, 1)
    if c_chunks > 6:  # xell_layout's c_max: agreed union must respect it
        # uniformly (every process sees the same union, so every process
        # takes the same fallback branch — incl. ones with empty shards)
        raise ValueError(
            f"agreed Xell window needs {c_chunks} chunks (> 6): shard "
            "bandwidths too spread — renumber the mesh")
    main_size = nt * k * xk.TB * xk.LANES
    size = main_size + spill_e
    assert size < 2**31, "value storage too large for int32 slot indices"
    vals_s = np.zeros((p, size), dtype)
    ll_s = np.zeros((p, main_size), np.int8)
    bb_s = np.zeros((p, main_size), np.int16)
    srow = np.zeros((p, spill_e), np.int32)
    scol = np.zeros((p, spill_e), np.int32)
    dest = np.full((p, e), size, np.int32)  # parking slot
    for i, (rows, cols, vals) in enumerate(shards):
        if not len(rows):
            continue
        lay = xk.xell_layout(rows, cols, n_local, force_slots=k,
                             force_c_left=c_left, force_c_chunks=c_chunks)
        vals = np.asarray(vals)
        main = ~lay.spill_sel
        vals_s[i][lay.dest[main]] = vals[main]
        ll_s[i][lay.dest[main]] = lay.ll_val
        bb_s[i][lay.bb_pos] = lay.bb_val
        nsp = int(lay.spill_sel.sum())
        if nsp:
            srow[i, :nsp] = np.asarray(rows, np.int64)[lay.spill_sel]
            scol[i, :nsp] = np.asarray(cols, np.int64)[lay.spill_sel]
            vals_s[i][main_size:main_size + nsp] = vals[lay.spill_sel]
        # lay.dest already addresses [main | spill] — exactly this stack's
        # flat value space
        dest[i, : len(rows)] = lay.dest
    stack = XellStack(
        vals=jnp.asarray(vals_s),
        ll=jnp.asarray(ll_s.reshape(p, nt, k, xk.TB, xk.LANES)),
        bbT=jnp.asarray(bb_s.reshape(p, nt, k, xk.LANES, xk.TB)),
        spill_rows=jnp.asarray(srow),
        spill_cols=jnp.asarray(scol),
        n_slots=k, c_left=c_left, c_chunks=c_chunks, n_tiles=nt,
        spill_e=spill_e,
    )
    return stack, jnp.asarray(dest)


def pack_halo_stack(shards, dtype, force_entries: int | None = None):
    """Pack per-shard halo (rows, slots, vals) triples into a CooStack.
    Entry order within each shard is preserved (row-major sorted by
    construction — required ordering, reference HostMatrix.C:449-456)."""
    p = len(shards)
    e = max((len(r) for r, _, _ in shards), default=0)
    e = max(force_entries or 0, e, 1)
    rows = np.full((p, e), 0, np.int32)
    cols = np.zeros((p, e), np.int32)
    vals = np.zeros((p, e), dtype)
    for i, (r, s, v) in enumerate(shards):
        rows[i, : len(r)] = np.asarray(r, np.int32)
        cols[i, : len(s)] = np.asarray(s, np.int32)
        vals[i, : len(v)] = v
    return CooStack(rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                    vals=jnp.asarray(vals))


def shard_local_matrix(local, n_local: int):
    """Per-shard format container from a stacked local operator whose leaves
    carry a leading parts axis of size 1 (inside shard_map)."""
    if isinstance(local, DiaStack):
        return Dia(data=local.data[0], offsets=local.offsets,
                   shape=(n_local, n_local))
    if isinstance(local, GdiaStack):
        from ogl_tpu.kernels.gdia import Gdia

        return Gdia(vals=local.vals[0], lidx=local.lidx[0],
                    plane_offsets=local.plane_offsets,
                    shape=(n_local, n_local))
    if isinstance(local, XellStack):
        from ogl_tpu.kernels.xell import LANES, TB, Xell

        main = local.n_tiles * local.n_slots * TB * LANES
        v = local.vals[0]
        spill = Coo(rows=local.spill_rows[0], cols=local.spill_cols[0],
                    vals=v[main:], shape=(n_local, n_local))
        return Xell(vals=v[:main].reshape(local.n_tiles, local.n_slots,
                                          TB, LANES),
                    ll=local.ll[0], bbT=local.bbT[0], spill=spill,
                    c_left=local.c_left, c_chunks=local.c_chunks,
                    shape=(n_local, n_local))
    if isinstance(local, EllStack):
        return Ell(cols=local.cols[0], vals=local.vals[0],
                   shape=(n_local, n_local))
    raise TypeError(f"unknown local stack {type(local)}")


# -----------------------------------------------------------------------------
# global-COO construction (decomposePar-simple analogue)
# -----------------------------------------------------------------------------


def partition_coo(coo: Coo, n_parts: int, local_format: str = "auto",
                  force_halo=None) -> DistMatrix:
    """Contiguous block (1-D) partition of a global row-major COO into a
    DistMatrix — the structural equivalent of decomposePar + the reference's
    per-rank HostMatrix construction, derived from the global operator.
    (decomposition by contiguous row blocks matches `decomposePar simple`).

    force_halo: optional boolean mask over the nnz entries (or a callable
    (rows, cols) -> mask) marking entries that must route through the halo
    exchange even when row and column land on the same part — e.g. the
    wrap couplings of a periodic operator.  Same operator either way;
    forced entries create a d = (requester-owner) mod P = 0 ppermute class
    (self-permutation [(i, i)]), so the compiled halo gather / exchange /
    scatter executes even on a ONE-device mesh."""
    n = coo.shape[0]
    p = int(n_parts)
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals))
    dtype = vals.dtype

    bounds = [round(i * n / p) for i in range(p + 1)]
    local_sizes = tuple(bounds[i + 1] - bounds[i] for i in range(p))
    n_local = max(local_sizes)
    owner = np.searchsorted(bounds, np.arange(n), side="right") - 1

    part_of_entry = owner[rows]
    is_local = owner[cols] == part_of_entry
    if force_halo is not None:
        fh = np.asarray(force_halo(rows, cols) if callable(force_halo)
                        else force_halo, bool)
        if fh.shape != rows.shape:
            raise ValueError(
                f"force_halo mask shape {fh.shape} != nnz {rows.shape}")
        is_local = is_local & ~fh

    # ---- halo column sets: per part, unique remote cols, grouped by owner
    halo_cols_of = []  # part -> sorted np.array of global cols (owner-major)
    for i in range(p):
        sel = (part_of_entry == i) & ~is_local
        hc = np.unique(cols[sel])
        hc = hc[np.lexsort((hc, owner[hc]))]  # group by owner, ascending col
        halo_cols_of.append(hc)
    halo_size = max((len(h) for h in halo_cols_of), default=0)
    halo_size = max(halo_size, 1)

    # vectorized position lookup into each part's (owner-major) halo list:
    # sort once per part, map queries through searchsorted + the sort
    # permutation (per-element Python dicts were O(halo) interpreter work
    # repeated per neighbor pair AND per part)
    _halo_sorted = []
    for hc in halo_cols_of:
        order_ = np.argsort(hc, kind="stable")
        _halo_sorted.append((hc[order_], order_.astype(np.int64)))

    def _slots_of(part: int, q: np.ndarray) -> np.ndarray:
        hs, order_ = _halo_sorted[part]
        return order_[np.searchsorted(hs, q)]

    # ---- ppermute schedule: offset classes d = (requester - owner) mod p
    per_offset: dict[int, list[tuple[int, np.ndarray]]] = {}
    for i in range(p):
        hc = halo_cols_of[i]
        for o in np.unique(owner[hc]) if len(hc) else []:
            d = (i - int(o)) % p
            sel = owner[hc] == o
            per_offset.setdefault(d, []).append((i, hc[sel]))
    offsets = tuple(sorted(per_offset))
    send_idx_list, recv_pos_list = [], []
    for d in offsets:
        entries = dict(per_offset[d])  # requester -> global cols
        s = max(len(v) for v in entries.values())
        sidx = np.zeros((p, s), np.int32)  # owner-side local indices (pad 0)
        rpos = np.full((p, s), halo_size, np.int32)  # requester-side slots
        for req, gcols in entries.items():
            own = (req - d) % p
            sidx[own, : len(gcols)] = (gcols - bounds[own]).astype(np.int32)
            # halo slots: positions of gcols within the requester's
            # (owner-major sorted) halo list
            rpos[req, : len(gcols)] = _slots_of(req, gcols).astype(np.int32)
        send_idx_list.append(jnp.asarray(sidx))
        recv_pos_list.append(jnp.asarray(rpos))

    # affine fast-path detection (dist.affine): uniform arithmetic runs on
    # every class's send/recv sets, all parts participating
    send_affine = recv_affine = None
    if offsets and all(len(dict(per_offset[d])) == p for d in offsets):
        from ogl_tpu.dist.affine import build_send_affine

        try:
            aff = build_send_affine(
                [[dict(per_offset[d])[(o + d) % p] - bounds[o]
                  for o in range(p)] for d in offsets],
                [[_slots_of(i, dict(per_offset[d])[i]) for i in range(p)]
                 for d in offsets])
        except KeyError:
            aff = None
        if aff is not None:
            send_affine, recv_affine = aff

    plan = HaloPlan(
        send_idx=tuple(send_idx_list),
        recv_pos=tuple(recv_pos_list),
        offsets=offsets,
        halo_size=halo_size,
        n_parts=p,
        send_affine=send_affine,
        recv_affine=recv_affine,
    )

    # ---- per-part triples (row-major order preserved)
    loc_shards, halo_shards = [], []
    for i in range(p):
        sel_l = (part_of_entry == i) & is_local
        sel_h = (part_of_entry == i) & ~is_local
        hslots = (_slots_of(i, cols[sel_h]) if np.any(sel_h)
                  else np.zeros(0, np.int64))
        loc_shards.append((rows[sel_l] - bounds[i], cols[sel_l] - bounds[i], vals[sel_l]))
        halo_shards.append((rows[sel_h] - bounds[i], hslots, vals[sel_h]))

    local, _ = pack_local_stack(loc_shards, n_local, dtype, fmt=local_format)
    halo = pack_halo_stack(halo_shards, dtype)

    apply_affine = None
    if plan.send_affine is not None:
        from ogl_tpu.dist.affine import build_apply_affine

        apply_affine = build_apply_affine(halo_shards)

    return DistMatrix(
        local=local,
        halo=halo,
        plan=plan,
        n_local=n_local,
        local_sizes=local_sizes,
        global_n=n,
        halo_sizes=tuple(len(h[0]) for h in halo_shards),
        apply_affine=apply_affine,
    )


def split_vector(dm: DistMatrix, x) -> np.ndarray:
    """Host-side: split a global vector into the (P, n_local) padded stack."""
    x = np.asarray(x)
    out = np.zeros((dm.n_parts, dm.n_local), x.dtype)
    off = 0
    for i, sz in enumerate(dm.local_sizes):
        out[i, :sz] = x[off : off + sz]
        off += sz
    return out


def gather_global(dm: DistMatrix, x_stack) -> np.ndarray:
    """Host-side inverse of split_vector."""
    x_stack = np.asarray(jax.device_get(x_stack))
    return np.concatenate([x_stack[i, :sz] for i, sz in enumerate(dm.local_sizes)])
