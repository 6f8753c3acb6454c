"""LDU → row-major sparse conversion (the HostMatrix layer).

Re-design of the reference's host matrix conversion
(`HostMatrix/HostMatrix.C`, `HostMatrixFreeFunctions.C`): OpenFOAM stores a
matrix as three arrays (diag, upper, lower) plus face addressing
(lowerAddr = owner cell, upperAddr = neighbour cell per internal face), and
boundary contributions as per-interface coefficient lists.  The reference
converts this to row-major COO once (sparsity is constant across time steps,
HostMatrix.H:34) and then re-scatters only coefficients each solve.

Host/device split:
  * one-time setup (this module, NumPy / native C++): build sorted
    (rows, cols) and the `ldu_permute` gather table — the vectorised
    equivalent of `init_local_sparsity` (HostMatrixFreeFunctions.C:105-201)
    and the interface merge (HostMatrix.C:469-589);
  * per-solve update (jit'd, device): `assemble_coeffs` — a single gather
    `scale * concat(upper, lower, diag, ifaces)[permute]`, replacing both
    the host scatter loops (`symmetric_update*`, HostMatrixFreeFunctions.C:
    21-102) and the device `row_gather` path (HostMatrix.C:684-704).

NOTE the reference's `symmetric_update` has an operator-precedence bug that
silently drops the scale factor (HostMatrixFreeFunctions.C:27-28).  This
implementation applies `scale` to every entry, which is the evident intent
(`symmetric_update_w_interface` does so correctly).

Source-value layout (what `permute` indexes into), matching the reference:
  symmetric:      [ upper(0:F) | diag(F:F+n) | local_iface(F+n:) ]
  non-symmetric:  [ upper(0:F) | lower(F:2F) | diag(2F:2F+n) | local_iface ]
with F = n_faces (upper_nnz).  Interface coefficients enter negated
(HostMatrix.C:204: `c = c * -1.0`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core import formats

__all__ = [
    "LocalInterface",
    "ProcInterface",
    "LduMatrix",
    "LduSparsity",
    "init_local_sparsity",
    "build_local_sparsity",
    "build_non_local_sparsity",
    "communication_pattern",
    "assemble_coeffs",
    "ldu_to_coo",
    "ldu_to_coo_host",
    "ldu_from_coo",
    "renumber",
    "partition_cells",
    "decompose",
    "decompose_with_map",
]


@dataclasses.dataclass(frozen=True)
class LocalInterface:
    """A non-processor coupled boundary (cyclic patch): couples local cell
    `rows[i]` to local cell `cols[i]` (reference HostMatrix.C:309-331)."""

    rows: np.ndarray  # face_cells (owner cell per interface face)
    cols: np.ndarray  # coupled local cell (addr.patchAddr(neighbPatchId))
    coeffs: np.ndarray  # interfaceBouCoeffs for this patch (NOT yet negated)


@dataclasses.dataclass(frozen=True)
class ProcInterface:
    """A processor boundary: couples local cell `face_cells[i]` to the i-th
    face cell of the matching interface on rank `neighbor`
    (reference HostMatrix.C:252-306, 412-436)."""

    neighbor: int
    face_cells: np.ndarray
    coeffs: np.ndarray  # interfaceBouCoeffs (NOT yet negated)


@dataclasses.dataclass(frozen=True)
class LduMatrix:
    """One rank's LDU system (host container).

    upper_addr[f] = neighbour cell of face f (column of the upper entry);
    lower_addr[f] = owner cell of face f (row of the upper entry).
    `lower` is None for symmetric matrices (the lower triangle reuses the
    upper coefficients, reference HostMatrixFreeFunctions.C:21-30).
    """

    n: int
    lower_addr: np.ndarray
    upper_addr: np.ndarray
    diag: np.ndarray
    upper: np.ndarray
    lower: np.ndarray | None = None
    local_interfaces: tuple[LocalInterface, ...] = ()
    proc_interfaces: tuple[ProcInterface, ...] = ()

    @property
    def symmetric(self) -> bool:
        return self.lower is None

    @property
    def n_faces(self) -> int:
        return int(len(self.upper_addr))


@dataclasses.dataclass(frozen=True)
class LduSparsity:
    """Precomputed sparsity + gather table for one rank's local matrix.

    rows/cols: row-major sorted local COO structure (incl. local interfaces).
    permute:   dest→source gather indices into the source-value layout above.
    The reference's `PersistentSparsityPattern` (HostMatrix.H:214-440).
    """

    n: int
    n_faces: int
    symmetric: bool
    rows: np.ndarray
    cols: np.ndarray
    permute: np.ndarray
    n_local_iface: int

    @property
    def nnz(self) -> int:
        return int(len(self.rows))


def init_local_sparsity(
    n: int,
    lower_addr: np.ndarray,
    upper_addr: np.ndarray,
    symmetric: bool,
):
    """Vectorised equivalent of the reference's `init_local_sparsity`
    (HostMatrixFreeFunctions.C:105-201): returns row-major sorted
    (rows, cols, permute) for the interior (no-interface) matrix.

    permute semantics: upper face f -> f; lower face f -> f (symmetric,
    values shared) or F + f (non-symmetric); diag row r -> after_nbrs + r,
    after_nbrs = F (symmetric) or 2F.
    """
    lower_addr = np.asarray(lower_addr, np.int64)
    upper_addr = np.asarray(upper_addr, np.int64)

    from ogl_tpu import native

    nat = native.init_local_sparsity(n, lower_addr, upper_addr, symmetric)
    if nat is not None:
        return nat  # int32 triple; LduSparsity stores int32 — no round-trip

    nf = len(upper_addr)
    after_nbrs = nf if symmetric else 2 * nf
    faces = np.arange(nf, dtype=np.int64)
    diag_idx = np.arange(n, dtype=np.int64)

    rows = np.concatenate([lower_addr, upper_addr, diag_idx])
    cols = np.concatenate([upper_addr, lower_addr, diag_idx])
    src = np.concatenate(
        [faces, faces if symmetric else nf + faces, after_nbrs + diag_idx]
    )
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], src[order]


def build_local_sparsity(ldu: LduMatrix) -> LduSparsity:
    """Full local sparsity: interior + local (cyclic) interfaces merged
    row-major (reference HostMatrix.C:469-589).  Local-interface entry i
    (in interface enumeration order) gets permute = after_nbrs + n + i."""
    rows, cols, permute = init_local_sparsity(
        ldu.n, ldu.lower_addr, ldu.upper_addr, ldu.symmetric
    )
    n_iface = sum(len(li.rows) for li in ldu.local_interfaces)
    if n_iface:
        nf = ldu.n_faces
        after_nbrs = nf if ldu.symmetric else 2 * nf
        irows = np.concatenate([np.asarray(li.rows, np.int64) for li in ldu.local_interfaces])
        icols = np.concatenate([np.asarray(li.cols, np.int64) for li in ldu.local_interfaces])
        isrc = after_nbrs + ldu.n + np.arange(n_iface, dtype=np.int64)
        rows = np.concatenate([rows, irows])
        cols = np.concatenate([cols, icols])
        permute = np.concatenate([permute, isrc])
        from ogl_tpu import native

        nat = native.sort_coo(ldu.n, rows, cols)
        if nat is not None:  # native counting sort (HostMatrix.C:506-586 role)
            r32, c32, order = nat
            rows, cols = r32.astype(np.int64), c32.astype(np.int64)
            permute = permute[order]
        else:
            order = np.lexsort((cols, rows))
            rows, cols, permute = rows[order], cols[order], permute[order]
    return LduSparsity(
        n=ldu.n,
        n_faces=ldu.n_faces,
        symmetric=ldu.symmetric,
        rows=np.asarray(rows, np.int32),
        cols=np.asarray(cols, np.int32),
        permute=np.asarray(permute, np.int32),
        n_local_iface=n_iface,
    )


def build_non_local_sparsity(ldu: LduMatrix):
    """Non-local (halo-column) sparsity (reference HostMatrix.C:438-466):
    entry i couples local row face_cells (sorted by row, stable in interface
    order) to halo-buffer slot `iface_ctr` — the position of that face in
    the natural enumeration of all processor-interface faces.  Returns
    (rows, halo_cols, permute); permute indexes the concatenated (negated)
    processor-interface coefficient array."""
    if not ldu.proc_interfaces:
        z = np.zeros(0, np.int32)
        return z, z, z
    rows = np.concatenate(
        [np.asarray(pi.face_cells, np.int64) for pi in ldu.proc_interfaces]
    )
    ctr = np.arange(len(rows), dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    return (
        rows[order].astype(np.int32),
        ctr[order].astype(np.int32),
        ctr[order].astype(np.int32),
    )


def communication_pattern(ldu: LduMatrix):
    """Per-neighbor send index sets (reference CommunicationPattern,
    HostMatrix.C:252-306): {neighbor_rank: send_idxs}, face cells of all
    interfaces to that rank concatenated in interface order; dict ordered by
    ascending rank (std::map semantics in the reference).

    Also returns `recv_slot_of_face`: for each face in natural interface
    enumeration (the halo-buffer slot used by build_non_local_sparsity),
    the (neighbor_rank, position within that neighbor's block) — needed to
    lay the per-neighbor received blocks into the halo buffer."""
    send = {}
    slot_owner = []  # (rank, pos-in-rank-block) per natural face index
    pos_in_rank: dict[int, int] = {}
    for pi in ldu.proc_interfaces:
        r = int(pi.neighbor)
        fc = np.asarray(pi.face_cells, np.int64)
        send.setdefault(r, []).append(fc)
        start = pos_in_rank.get(r, 0)
        slot_owner.extend((r, start + k) for k in range(len(fc)))
        pos_in_rank[r] = start + len(fc)
    send = {r: np.concatenate(v).astype(np.int32) for r, v in sorted(send.items())}
    return send, slot_owner


def _source_vector(ldu_arrays, symmetric: bool, n_local_iface: int):
    """Concatenate (upper[, lower], diag, -local_iface_coeffs)."""
    upper, lower, diag, iface = ldu_arrays
    parts = [upper] if symmetric else [upper, lower]
    parts.append(diag)
    if n_local_iface:
        parts.append(-iface)
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("symmetric", "n_local_iface"), donate_argnums=())
def _assemble(upper, lower, diag, iface, permute, scale, *, symmetric, n_local_iface):
    src = _source_vector((upper, lower, diag, iface), symmetric, n_local_iface)
    return scale * jnp.take(src, permute, axis=0)


@partial(jax.jit, donate_argnums=())
def _assemble_from_src(src, permute, scale):
    return scale * jnp.take(src, permute, axis=0)


def _host_blocks(sp: LduSparsity, m: LduMatrix, dtype) -> list:
    """The raw LDU source blocks [upper, (lower,) diag, (-local_iface)] as
    separate host arrays, in _host_src's concatenation order.  Kept split
    so consumers can upload only the blocks whose values changed since the
    previous step (delta updates): in transient CFD the off-diagonal
    (Laplacian) coefficients are often constant while only diag/RHS carry
    the time-step terms, and the host->device coefficient upload dominates
    the steady-state step cost."""
    parts = [np.asarray(m.upper, dtype)]
    if not sp.symmetric:
        parts.append(np.asarray(m.lower, dtype))
    parts.append(np.asarray(m.diag, dtype))
    if sp.n_local_iface:
        parts.append(-np.concatenate(
            [np.asarray(li.coeffs, dtype) for li in m.local_interfaces]))
    return parts


def _host_src(sp: LduSparsity, m: LduMatrix, dtype):
    """Concatenate the raw LDU blocks on the host (a memcpy — the
    reference's bulk copy, HostMatrix.C:684-692)."""
    parts = _host_blocks(sp, m, dtype)
    return np.concatenate(parts) if len(parts) > 1 else np.asarray(parts[0])


@partial(jax.jit, donate_argnums=())
def _assemble_from_blocks(blocks, permute, scale):
    """Device-side concat of the (persistently resident) source blocks +
    the row-major gather — the delta-update twin of _assemble_from_src."""
    src = jnp.concatenate(blocks) if len(blocks) > 1 else blocks[0]
    return scale * jnp.take(src, permute, axis=0)


def assemble_coeffs_host_src(sp: LduSparsity, m: LduMatrix, dtype, scale=1.0):
    """Coefficient update with ONE host→device transfer: host concat, one
    upload, device gather.  Preferred when only the device array is needed."""
    src = _host_src(sp, m, dtype)
    return _assemble_from_src(
        jnp.asarray(src), jnp.asarray(sp.permute),
        jnp.asarray(scale, src.dtype),
    )


def assemble_coeffs_host(sp: LduSparsity, m: LduMatrix, dtype, scale=1.0) -> np.ndarray:
    """Row-major coefficient array assembled entirely on the HOST (numpy
    gather).  Used when the values are also needed host-side in the same
    step (format conversion, preconditioner factorisation): fetching a
    device-assembled array back is a device→host transfer that can be
    orders of magnitude slower than the gather itself."""
    src = _host_src(sp, m, dtype)
    out = src[np.asarray(sp.permute)]
    if scale != 1.0:
        out = out * np.asarray(scale, src.dtype)
    return out


def assemble_coeffs(
    sp: LduSparsity,
    diag,
    upper,
    lower=None,
    local_iface_coeffs=None,
    scale=1.0,
):
    """Per-solve coefficient update: one jit'd gather producing the row-major
    value array for the local matrix (replaces symmetric_update /
    non_symmetric_update[_w_interface] and the row_gather device path).
    Interface coefficients are negated here (reference HostMatrix.C:204)."""
    dtype = jnp.asarray(diag).dtype
    if lower is None:
        lower = jnp.zeros((0,), dtype)
    if local_iface_coeffs is None:
        local_iface_coeffs = jnp.zeros((0,), dtype)
    return _assemble(
        jnp.asarray(upper),
        jnp.asarray(lower),
        jnp.asarray(diag),
        jnp.asarray(local_iface_coeffs),
        jnp.asarray(sp.permute),
        jnp.asarray(scale, dtype),
        symmetric=sp.symmetric,
        n_local_iface=sp.n_local_iface,
    )


def renumber(m: LduMatrix, perm: np.ndarray) -> LduMatrix:
    """Symmetric renumbering: the LDU system of P·A·Pᵀ, where new cell k is
    old cell perm[k] (so x_new = x_old[perm]).  Faces whose (owner,
    neighbour) pair flips orientation under the new numbering swap their
    addressing — and, for non-symmetric systems, their upper/lower
    coefficients, since `upper[f]` is by definition the A[lower_addr,
    upper_addr] entry.  Face ORDER is preserved, which keeps the pairwise
    interface contracts of decompose() intact."""
    n = m.n
    perm = np.asarray(perm, np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    lo = inv[np.asarray(m.lower_addr, np.int64)]
    up = inv[np.asarray(m.upper_addr, np.int64)]
    flip = lo > up
    if m.symmetric:
        upper, lower = np.asarray(m.upper), None
    else:
        u, l = np.asarray(m.upper), np.asarray(m.lower)
        upper, lower = np.where(flip, l, u), np.where(flip, u, l)
    locs = tuple(
        LocalInterface(rows=inv[np.asarray(li.rows, np.int64)],
                       cols=inv[np.asarray(li.cols, np.int64)],
                       coeffs=np.asarray(li.coeffs))
        for li in m.local_interfaces)
    procs = tuple(
        ProcInterface(neighbor=pi.neighbor,
                      face_cells=inv[np.asarray(pi.face_cells, np.int64)],
                      coeffs=np.asarray(pi.coeffs))
        for pi in m.proc_interfaces)
    return LduMatrix(
        n=n,
        lower_addr=np.where(flip, up, lo),
        upper_addr=np.where(flip, lo, up),
        diag=np.asarray(m.diag)[perm],
        upper=upper,
        lower=lower,
        local_interfaces=locs,
        proc_interfaces=procs,
    )


def partition_cells(m: LduMatrix, n_parts: int,
                    method: str = "scotch") -> np.ndarray:
    """cell → part map for a global LDU system.  "simple" = contiguous row
    blocks (decomposePar simple); "scotch"/"bisect"/"graph" = recursive
    level-set bisection of the cell-connectivity graph (faces + cyclic
    couplings), the decomposePar-scotch role (core/graph.py)."""
    n, p = m.n, int(n_parts)
    if method == "simple":
        bounds = [round(i * n / p) for i in range(p + 1)]
        return (np.searchsorted(bounds, np.arange(n), side="right") - 1
                ).astype(np.int32)
    if method not in ("scotch", "bisect", "graph"):
        raise ValueError(
            f"unknown decomposition {method!r}; use simple|scotch|bisect")
    from ogl_tpu.core import graph

    rows = [np.asarray(m.lower_addr, np.int64)]
    cols = [np.asarray(m.upper_addr, np.int64)]
    for li in m.local_interfaces:
        rows.append(np.asarray(li.rows, np.int64))
        cols.append(np.asarray(li.cols, np.int64))
    adj = graph.adjacency_from_edges(
        n, np.concatenate(rows), np.concatenate(cols))
    return graph.recursive_bisection(adj, p)


def partition_map(
    m: LduMatrix, n_parts: int, method: str = "simple",
) -> tuple[np.ndarray | None, list[int]]:
    """The decomposition's (perm, bounds): cell renumbering (None for the
    identity "simple" numbering) plus part boundaries in the renumbered
    order (len n_parts+1).  Part i owns renumbered cells
    [bounds[i], bounds[i+1]); new cell k = old cell perm[k].  Shared by
    decompose_with_map and DistFoamSolver so the two cannot drift."""
    n, p = m.n, int(n_parts)
    if p < 1 or p > n:
        raise ValueError(
            f"n_parts must be in [1, n_cells={n}], got {n_parts}: "
            "empty-rank decompositions are not representable")
    if method == "simple":
        return None, [round(i * n / p) for i in range(p + 1)]
    owner = partition_cells(m, p, method)
    perm = np.argsort(owner, kind="stable").astype(np.int64)
    sizes = np.bincount(owner, minlength=p)
    return perm, [0, *np.cumsum(sizes).tolist()]


def decompose_with_map(
    m: LduMatrix, n_parts: int, method: str = "simple",
    cyclic_via_halo: bool = False,
) -> tuple[list[LduMatrix], np.ndarray | None]:
    """decompose() plus the cell renumbering it applied: returns
    (parts, perm) with perm=None for the identity ("simple") numbering.
    Graph methods renumber cells part-contiguously (new cell k = old cell
    perm[k]); callers must permute global vectors accordingly (b[perm] in,
    x_out[perm] = x back — cf. the `reorder rcm` boundary in foam.solver)."""
    perm, bounds = partition_map(m, n_parts, method)
    if perm is None:
        return _decompose_blocks(m, bounds, cyclic_via_halo), None
    return _decompose_blocks(renumber(m, perm), bounds, cyclic_via_halo), perm


def decompose(m: LduMatrix, n_parts: int,
              method: str = "simple",
              cyclic_via_halo: bool = False) -> list[LduMatrix]:
    """Split a global LDU system (symmetric or not, with or without local
    cyclic interfaces) into per-rank LduMatrix systems with processor
    interfaces — the structural equivalent of decomposePar (reference
    HostMatrix.C:309-331, 412-436 handles all matrix types and interface
    kinds in parallel).  `method`: "simple" = contiguous blocks in the
    EXISTING numbering; "scotch"/"bisect" = graph-partitioned
    (decompose_with_map returns the renumbering those methods apply).

    Crossing internal faces: one ProcInterface per neighbor rank, faces in
    global face order on both sides (the OpenFOAM pairwise contract).  The
    owner (lower-rank-row) side carries the upper coefficient, the neighbour
    side the lower coefficient (== upper when symmetric): each side stores
    the A[row, remote-col] entry of ITS rows.

    Crossing cyclic-interface entries (a cyclic patch whose two sides land
    on different ranks): appended as a second ProcInterface per pair, both
    sides ordered by the canonical global pair key, relying on cyclic
    couplings coming in (i→j, j→i) pairs exactly like processor faces."""
    if method != "simple":
        return decompose_with_map(m, n_parts, method, cyclic_via_halo)[0]
    n, p = m.n, n_parts
    bounds = [round(i * n / p) for i in range(p + 1)]
    return _decompose_blocks(m, bounds, cyclic_via_halo)


def _decompose_blocks(m: LduMatrix, bounds: list[int],
                      cyclic_via_halo: bool = False) -> list[LduMatrix]:
    """Contiguous-block split at arbitrary `bounds` (len n_parts+1).

    cyclic_via_halo: route SAME-rank cyclic couplings through the halo
    exchange as paired self-neighbor ProcInterfaces (neighbor == own rank)
    instead of keeping them as explicit LocalInterface columns.  Both
    representations encode the same operator; the halo route makes the
    distributed program execute a real ppermute round even when a part
    self-neighbors — including on a ONE-device mesh, where it is the only
    way to exercise the halo-exchange hot path on a single chip (cf.
    dist.from_ranks.build_halo_plan self-pair contract)."""
    n, p = m.n, len(bounds) - 1
    owner_of = np.searchsorted(bounds, np.arange(n), side="right") - 1

    lo = np.asarray(m.lower_addr, np.int64)
    up = np.asarray(m.upper_addr, np.int64)
    upper_c = np.asarray(m.upper)
    lower_c = None if m.symmetric else np.asarray(m.lower)
    ro, ru = owner_of[lo], owner_of[up]
    interior = ro == ru

    # crossing faces per rank: {nbr: ([cells], [coeffs])} in global face order
    face_ifaces: list[dict[int, tuple[list, list]]] = [dict() for _ in range(p)]
    for f in np.nonzero(~interior)[0]:
        a, b = int(ro[f]), int(ru[f])
        # a's row is lo[f] (coeff = upper: A[lo, up]); b's row is up[f]
        # (coeff = lower for non-symmetric: A[up, lo])
        face_ifaces[a].setdefault(b, ([], []))
        face_ifaces[a][b][0].append(int(lo[f]) - bounds[a])
        face_ifaces[a][b][1].append(float(upper_c[f]))
        face_ifaces[b].setdefault(a, ([], []))
        face_ifaces[b][a][0].append(int(up[f]) - bounds[b])
        face_ifaces[b][a][1].append(float(upper_c[f] if m.symmetric else lower_c[f]))

    # local (cyclic) interface entries: same-rank stay LocalInterface;
    # crossing become a second ProcInterface per pair, canonically ordered
    local_keep: list[dict] = [dict() for _ in range(p)]  # rank -> rows/cols/coeffs
    cyc_ifaces: list[dict[int, list]] = [dict() for _ in range(p)]  # rank -> nbr -> [(key, row, coeff)]
    for li in m.local_interfaces:
        lrows = np.asarray(li.rows, np.int64)
        lcols = np.asarray(li.cols, np.int64)
        lcoef = np.asarray(li.coeffs)
        ra, rc = owner_of[lrows], owner_of[lcols]
        for e in range(len(lrows)):
            i, j = int(ra[e]), int(rc[e])
            if i == j:
                if cyclic_via_halo:
                    # self-neighbor route: collect like the crossing case
                    # (canonical pair key aligns the two sides; the A/B
                    # split into paired interfaces happens at emission)
                    gr, gc = int(lrows[e]), int(lcols[e])
                    key = (min(gr, gc), max(gr, gc))
                    cyc_ifaces[i].setdefault(i, []).append(
                        (key, gr - bounds[i], float(lcoef[e]), gr < gc)
                    )
                    continue
                d = local_keep[i].setdefault("e", ([], [], []))
                d[0].append(int(lrows[e]) - bounds[i])
                d[1].append(int(lcols[e]) - bounds[i])
                d[2].append(float(lcoef[e]))
            else:
                gr, gc = int(lrows[e]), int(lcols[e])
                key = (gr, gc) if i < j else (gc, gr)
                cyc_ifaces[i].setdefault(j, []).append(
                    (key, gr - bounds[i], float(lcoef[e]))
                )

    parts = []
    for i in range(p):
        sel = interior & (ro == i)
        base = bounds[i]
        proc = []
        # self-neighbor (cyclic_via_halo) pairs FIRST, then ascending rank:
        # every rank then lists its interfaces in the same structural order,
        # which keeps the slot enumeration SPMD-uniform so the affine
        # (slice/matmul) halo route stays available (dist.affine)
        nbrs = sorted(set(face_ifaces[i]) | set(cyc_ifaces[i]),
                      key=lambda r: (r != i, r))
        for r in nbrs:
            if r in face_ifaces[i]:
                cells, coeffs = face_ifaces[i][r]
                proc.append(ProcInterface(
                    neighbor=r,
                    face_cells=np.array(cells, np.int64),
                    coeffs=-np.array(coeffs),  # bouCoeff = -A_offdiag
                ))
            if r in cyc_ifaces[i]:
                ent = sorted(cyc_ifaces[i][r], key=lambda t: t[0])
                # LocalInterface coeffs are bouCoeffs (matrix entry =
                # -coeff); ProcInterface uses the same NOT-yet-negated
                # convention, so the coefficient carries over unchanged
                if r == i:
                    # self-neighbor (cyclic_via_halo): split the two sides
                    # into a PAIRED interface (A = lower-cell rows, B =
                    # upper-cell rows), both key-sorted so A's k-th face
                    # couples B's k-th (build_halo_plan self-pair contract)
                    side_a = [e for e in ent if e[3]]
                    side_b = [e for e in ent if not e[3]]
                    if len(side_a) != len(side_b):
                        raise ValueError(
                            "cyclic couplings must come in (i->j, j->i) "
                            f"pairs; rank {i} has {len(side_a)} vs "
                            f"{len(side_b)} sides")
                    for side in (side_a, side_b):
                        proc.append(ProcInterface(
                            neighbor=i,
                            face_cells=np.array([e[1] for e in side],
                                                np.int64),
                            coeffs=np.array([e[2] for e in side]),
                        ))
                else:
                    proc.append(ProcInterface(
                        neighbor=r,
                        face_cells=np.array([e[1] for e in ent], np.int64),
                        coeffs=np.array([e[2] for e in ent]),
                    ))
        local = ()
        if "e" in local_keep[i]:
            rws, cls, cfs = local_keep[i]["e"]
            local = (LocalInterface(
                rows=np.array(rws, np.int64),
                cols=np.array(cls, np.int64),
                coeffs=np.array(cfs),
            ),)
        parts.append(
            LduMatrix(
                n=bounds[i + 1] - bounds[i],
                lower_addr=lo[sel] - base,
                upper_addr=up[sel] - base,
                diag=np.asarray(m.diag)[bounds[i]:bounds[i + 1]].copy(),
                upper=upper_c[sel],
                lower=None if m.symmetric else lower_c[sel],
                local_interfaces=local,
                proc_interfaces=tuple(proc),
            )
        )
    return parts


def ldu_to_coo_host(ldu: LduMatrix, scale=1.0, dtype=None) -> formats.Coo:
    """Host-only assembly: returns a Coo whose fields are NumPy arrays —
    for setup pipelines (format conversion, factorisations) that would
    otherwise round-trip every value through the device.  One upload
    happens when the final device format is built."""
    sp = build_local_sparsity(ldu)
    parts = [np.asarray(ldu.upper)]
    if not ldu.symmetric:
        parts.append(np.asarray(ldu.lower))
    parts.append(np.asarray(ldu.diag))
    if ldu.local_interfaces:
        parts.append(-np.concatenate([np.asarray(li.coeffs) for li in ldu.local_interfaces]))
    src = np.concatenate(parts)
    if dtype is not None:
        src = src.astype(dtype)
    vals = (scale * src[sp.permute]).astype(src.dtype)
    return formats.Coo(rows=sp.rows, cols=sp.cols, vals=vals, shape=(ldu.n, ldu.n))


def ldu_to_coo(ldu: LduMatrix, scale=1.0, dtype=None) -> formats.Coo:
    """Convenience: full local matrix (incl. local interfaces) as row-major
    COO on device."""
    sp = build_local_sparsity(ldu)
    iface = (
        np.concatenate([np.asarray(li.coeffs) for li in ldu.local_interfaces])
        if ldu.local_interfaces
        else None
    )
    diag = np.asarray(ldu.diag)
    if dtype is not None:
        diag = diag.astype(dtype)
    vals = assemble_coeffs(
        sp,
        jnp.asarray(diag),
        jnp.asarray(np.asarray(ldu.upper, diag.dtype)),
        None if ldu.symmetric else jnp.asarray(np.asarray(ldu.lower, diag.dtype)),
        None if iface is None else jnp.asarray(iface.astype(diag.dtype)),
        scale=scale,
    )
    return formats.Coo(
        rows=jnp.asarray(sp.rows),
        cols=jnp.asarray(sp.cols),
        vals=vals,
        shape=(ldu.n, ldu.n),
    )


def ldu_from_coo(coo: formats.Coo,
                 proc_interfaces: tuple = ()) -> LduMatrix:
    """Inverse of ldu_to_coo for an assembled LOCAL matrix: split a square
    host COO back into LDU form (diag/upper/lower + face addressing).

    This is the ingestion half of the reference's export format
    (CsrMatrixWrapper.H:271-290 writes `<field>_A_local.mtx`; nothing in
    the reference reads it back) — it closes the export->replay loop for
    drop-in case validation.  Duplicate (r, c) entries are summed (the
    assembly semantics); structurally one-sided couplings get a
    zero-valued counterpart so the face addressing stays two-sided.
    """
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals)).astype(np.float64)
    n = int(coo.shape[0])
    assert coo.shape[0] == coo.shape[1], "LDU needs a square matrix"

    diag = np.zeros(n)
    on_d = rows == cols
    np.add.at(diag, rows[on_d], vals[on_d])

    r_off, c_off, v_off = rows[~on_d], cols[~on_d], vals[~on_d]
    lo = np.minimum(r_off, c_off)
    hi = np.maximum(r_off, c_off)
    pair = lo * n + hi
    pairs_u, inv = np.unique(pair, return_inverse=True)
    f = len(pairs_u)
    lower_addr = (pairs_u // n).astype(np.int32)
    upper_addr = (pairs_u % n).astype(np.int32)
    upper = np.zeros(f)
    lower = np.zeros(f)
    is_up = r_off < c_off  # entry in the strict upper triangle
    np.add.at(upper, inv[is_up], v_off[is_up])
    np.add.at(lower, inv[~is_up], v_off[~is_up])
    symmetric = np.array_equal(upper, lower)
    return LduMatrix(
        n=n,
        lower_addr=lower_addr,
        upper_addr=upper_addr,
        diag=diag,
        upper=upper,
        lower=None if symmetric else lower,
        proc_interfaces=tuple(proc_interfaces),
    )
