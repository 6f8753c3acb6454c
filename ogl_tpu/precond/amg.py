"""Algebraic multigrid via parallel graph match (PGM) aggregation —
the reference's "Multigrid" preconditioner (Preconditioner.H:260-345:
amgx_pgm coarsening, IR+scalar-Jacobi pre/post smoother with relaxation
0.9 and 2 sweeps, CG coarse solver with a fixed iteration count, v/w/f
cycle, one multigrid sweep per preconditioner application).

Structure: the level hierarchy is data-dependent, so it is built ONCE on
the host (greedy pairwise aggregation + Galerkin products in SciPy) and
baked into the compiled program as a static unrolled cycle — each level's
operator picks the densest representable format (Dia — coarsening of
stencil matrices preserves diagonal structure — then Gdia, then Ell), and
with the default "natural" consecutive-run aggregation the transfer
operators are pure reshapes (piecewise-constant P; the strength-based
"pgm" mode matches the reference's amgx_pgm semantics but pays XLA
gather/scatter transfers).  All shapes static, the whole cycle jit-safe
(SURVEY.md §7 hard part "AMG with static shapes").

Small coarse levels make the cycle cost bound by per-op launch latency
rather than bandwidth, so the cycle is engineered for op count:
  * shallow hierarchy — coarsening rate 8 per level (config coarseningRate);
  * the first pre-smooth sweep exploits the zero initial guess (no A·0);
  * the coarsest level is solved DIRECTLY by one matvec against a
    precomputed dense inverse (config coarseSolver=direct) instead of the
    reference's fixed-iteration CG (~20 latency-bound ops).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo, coo_to_ell

__all__ = ["amg", "pgm_aggregate", "build_hierarchy"]


def pgm_aggregate(a_csr) -> np.ndarray:
    """Greedy deterministic pairwise matching on strength |a_ij|
    (Ginkgo amgx_pgm with with_deterministic(true)): each unaggregated
    vertex pairs with its strongest unaggregated neighbour; leftovers join
    their strongest neighbour's aggregate; isolated vertices become
    singletons.  Returns agg[i] = coarse index."""
    n = a_csr.shape[0]
    indptr, indices, data = a_csr.indptr, a_csr.indices, np.abs(a_csr.data)

    from ogl_tpu import native

    nat = native.pgm_aggregate(n, indptr.astype(np.int64), indices, data)
    if nat is not None:
        return nat[0].astype(np.int64)

    agg = np.full(n, -1, np.int64)
    nc = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        best, best_w = -1, 0.0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j != i and agg[j] < 0 and data[p] > best_w:
                best, best_w = j, data[p]
        if best >= 0:
            agg[i] = agg[best] = nc
            nc += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        best, best_w = -1, 0.0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j != i and agg[j] >= 0 and data[p] > best_w:
                best, best_w = j, data[p]
        if best >= 0:
            agg[i] = agg[best]
        else:
            agg[i] = nc
            nc += 1
    return agg


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Level:
    mat: object  # Dia | Gdia | Ell
    inv_diag: object  # (n_l,)
    agg: object | None  # (n_l,) int32 coarse ids, None on coarsest
    n: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    # natural (consecutive-run) aggregation: transfers are reshapes, no
    # gather/scatter (the strength-based transfers need both)
    natural: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # grid (geometric 2x-per-axis) aggregation: fine dims + coarse dims
    # (nz, ny, nx, nzc, nyc, nxc); transfers are pad+reshape+reduce
    grid: tuple | None = dataclasses.field(default=None,
                                           metadata=dict(static=True))
    # aggregate size for natural aggregation (coarsening rate per level);
    # larger widths mean fewer levels — the cycle cost across the small
    # levels is per-op launch latency, not fine-level bandwidth, so a
    # shallower hierarchy can win wall-clock at a few extra outer Krylov
    # iterations
    width: int = dataclasses.field(default=2, metadata=dict(static=True))
    # dense inverse of the coarsest operator (nc=0 levels only): coarse
    # solve = one matvec instead of a latency-bound CG loop
    coarse_inv: object | None = None


def natural_aggregate(n: int, width: int = 2) -> np.ndarray:
    """Group `width` consecutive rows: aggregate c = {w·c, …, w·c+w−1}.  On
    RCM/structured orderings the strongest neighbour is usually adjacent, so
    this is a semi-coarsening variant of pairwise matching whose transfer
    operators are pure reshapes."""
    return np.arange(n, dtype=np.int64) // width


def grid_dims_of(offsets, n: int):
    """Recover (nz, ny, nx) of a lexicographic box-grid stencil operator
    from its diagonal offsets: a 7-point operator has offsets
    {0, ±1, ±nx, ±nx·ny} (5-point: {0, ±1, ±nx}; 1-D: {0, ±1}).  Returns
    None when the offsets are not of that form or n does not factor —
    callers fall back to 1-D natural aggregation."""
    pos = sorted(o for o in offsets if o > 0)
    neg = sorted(-o for o in offsets if o < 0)
    if pos != neg or len(pos) > 3 or 0 not in offsets:
        return None
    if not pos:
        return None
    if pos[0] != 1:
        return None
    if len(pos) == 1:
        return (1, 1, n)
    nx = pos[1]
    if len(pos) == 2:
        if n % nx:
            return None
        return (1, n // nx, nx)
    s2 = pos[2]
    if s2 % nx or n % s2:
        return None
    return (n // s2, s2 // nx, nx)


def grid_aggregate(dims):
    """2×-per-axis block aggregation of a (nz, ny, nx) lexicographic grid
    (true geometric coarsening — rate 8 in 3-D, 4 in 2-D).  Odd axes get a
    trailing partial block (ceil).  Returns (agg ids, coarse dims).

    The 1-D `natural` consecutive-run default semicoarsens ONLY x on a 3-D
    grid, and its convergence degrades with size (96 CG+AMG iterations at
    8.4M DOF vs ~20 grid-independent for real 3-D coarsening).  Block
    aggregation keeps a face-coupled (7-point) operator face-coupled on
    the coarse grid — every level stays DIA — and the transfers are pad +
    reshape + reduce (no gather/scatter; see _restrict/_prolong)."""
    nz, ny, nx = dims
    n = nz * ny * nx
    i = np.arange(n, dtype=np.int64)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    nxc = (nx + 1) // 2 if nx > 1 else 1
    nyc = (ny + 1) // 2 if ny > 1 else 1
    nzc = (nz + 1) // 2 if nz > 1 else 1
    cx = np.minimum(ix // 2, nxc - 1) if nx > 1 else ix * 0
    cy = np.minimum(iy // 2, nyc - 1) if ny > 1 else iy * 0
    cz = np.minimum(iz // 2, nzc - 1) if nz > 1 else iz * 0
    agg = (cz * nyc + cy) * nxc + cx
    return agg, (nzc, nyc, nxc)


def build_hierarchy(coo: Coo, max_levels: int, min_coarse_rows: int,
                    aggregation: str = "natural", width: int = 2,
                    coarse_solver: str = "direct",
                    dense_coarse_max: int = 4096):
    import scipy.sparse as sp

    # keep the container's own dtypes end-to-end: the f64/int64 round-trip
    # copied every array twice and doubled the hierarchy's memory traffic
    # (a preconditioner setup gains nothing from f64 Galerkin sums)
    rows = np.asarray(jax.device_get(coo.rows))
    cols = np.asarray(jax.device_get(coo.cols))
    vals = np.asarray(jax.device_get(coo.vals))
    dtype = vals.dtype
    a = sp.csr_matrix((vals, (rows, cols)), shape=coo.shape)
    natural = aggregation == "natural"
    # "auto"/"grid": geometric 2x-per-axis block aggregation when the
    # operator is a box-grid stencil (dims recoverable from its offsets);
    # falls back to 1-D natural otherwise.  "grid" asks for it explicitly
    # (still falls back rather than failing: padded distributed shards
    # don't factor).
    grid_dims = None
    if aggregation in ("auto", "grid"):
        diffs = np.unique(np.subtract(cols, rows, dtype=np.int64))
        grid_dims = grid_dims_of([int(d) for d in diffs], a.shape[0])
        natural = grid_dims is None

    # with a direct coarse solve, coarsening below the dense-solve size only
    # adds latency-bound levels: stop as soon as one dense matvec can finish
    # the job (min_coarse_rows stays a lower bound, reference semantics).
    # n0//16 keeps small problems coarsening a couple of levels so the
    # hierarchy is still exercised (and the dense block stays tiny).
    stop_rows = min_coarse_rows
    if coarse_solver == "direct":
        n0 = a.shape[0]
        stop_rows = max(min_coarse_rows, min(dense_coarse_max // 2, n0 // 16))

    levels: list[_Level] = []
    for _ in range(max_levels):
        n = a.shape[0]
        if n <= stop_rows:
            break
        gtuple = None
        if grid_dims is not None:
            agg, coarse_dims = grid_aggregate(grid_dims)
            gtuple = tuple(grid_dims) + tuple(coarse_dims)
        elif natural:
            agg = natural_aggregate(n, width)
        else:
            agg = pgm_aggregate(a)
        nc = int(agg.max()) + 1
        if nc >= n:  # no coarsening progress
            break
        d = a.diagonal()
        d = np.where(np.abs(d) > 1e-300, d, 1.0)
        mat = _ell_of(a, dtype)
        inv_diag = jnp.asarray((1.0 / d).astype(dtype))
        levels.append(
            _Level(
                mat=mat,
                inv_diag=inv_diag,
                agg=None if (natural or gtuple is not None)
                else jnp.asarray(agg.astype(np.int32)),
                n=n,
                nc=nc,
                natural=natural,
                grid=gtuple,
                width=width,
            )
        )
        if grid_dims is not None:
            grid_dims = coarse_dims
        # Galerkin product with a one-hot aggregation P is just the
        # index-mapped duplicate-sum A_c[agg[r], agg[c]] += A[r, c] — the
        # generic spgemm chain (p.T @ a @ p) did the same thing ~10x
        # slower and dominated first-solve latency at 1M DOF
        ac = a.tocoo()
        a = sp.csr_matrix((ac.data, (agg[ac.row], agg[ac.col])),
                          shape=(nc, nc))
        a.sum_duplicates()
    # coarsest level: dense inverse when small (one dense matvec per cycle
    # instead of a latency-bound fixed-iteration CG; exact, so it also
    # strengthens the coarse-grid correction)
    d = a.diagonal()
    d = np.where(np.abs(d) > 1e-300, d, 1.0)
    n_c = a.shape[0]
    coarse_inv = None
    if coarse_solver == "direct" and n_c <= dense_coarse_max:
        dense = a.toarray().astype(np.float64)
        # FV pressure systems are often singular up to the constant vector
        # (pure-Neumann): regularise tiny/zero pivots via pseudo-inverse
        try:
            inv = np.linalg.inv(dense)
            if not np.all(np.isfinite(inv)):
                raise np.linalg.LinAlgError
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(dense, rcond=1e-12)
        coarse_inv = jnp.asarray(inv.astype(dtype))
    levels.append(
        _Level(
            mat=_ell_of(a, dtype),
            inv_diag=jnp.asarray((1.0 / d).astype(dtype)),
            agg=None,
            n=n_c,
            nc=0,
            coarse_inv=coarse_inv,
        )
    )
    return levels


def grid_restrict(g, r):
    """Block-sum restriction for a grid level tuple
    (nz, ny, nx, nzc, nyc, nxc): pad odd axes to the 2x block grid (zeros
    contribute nothing to the block sums), then one reshape+reduce — no
    gather/scatter."""
    nz, ny, nx, nzc, nyc, nxc = g
    bz, by, bx = (2 if nz > 1 else 1), (2 if ny > 1 else 1), (2 if nx > 1 else 1)
    r3 = jnp.pad(r.reshape(nz, ny, nx),
                 ((0, bz * nzc - nz), (0, by * nyc - ny), (0, bx * nxc - nx)))
    return r3.reshape(nzc, bz, nyc, by, nxc, bx).sum(axis=(1, 3, 5)).reshape(-1)


def grid_prolong(g, ec):
    """Piecewise-constant injection (the exact transpose of
    grid_restrict)."""
    nz, ny, nx, nzc, nyc, nxc = g
    bz, by, bx = (2 if nz > 1 else 1), (2 if ny > 1 else 1), (2 if nx > 1 else 1)
    e = jnp.broadcast_to(
        ec.reshape(nzc, 1, nyc, 1, nxc, 1),
        (nzc, bz, nyc, by, nxc, bx)).reshape(nzc * bz, nyc * by, nxc * bx)
    return e[:nz, :ny, :nx].reshape(-1)


def _restrict(level: _Level, r):
    if level.grid is not None:
        return grid_restrict(level.grid, r)
    if level.natural:
        w = level.width
        rp = jnp.pad(r, (0, w * level.nc - level.n))
        return rp.reshape(level.nc, w).sum(axis=1)
    return jax.ops.segment_sum(r, level.agg, num_segments=level.nc)


def _prolong(level: _Level, ec):
    if level.grid is not None:
        return grid_prolong(level.grid, ec)
    if level.natural:
        w = level.width
        e = jnp.broadcast_to(ec[:, None], (level.nc, w)).reshape(-1)
        return e[: level.n]
    return jnp.take(ec, level.agg, axis=0)


def _ell_of(a_csr, dtype):
    """Level operator, fastest representable format: Dia (static slices, no
    gather — PGM coarsening of stencil matrices preserves the diagonal
    structure exactly) → Gdia (lane gathers, bounded planes) → Ell."""
    from ogl_tpu.core.formats import coo_to_dia

    a_csr.sort_indices()  # no-op when already canonical
    a = a_csr.tocoo()  # canonical CSR -> already row-major sorted
    coo = Coo(
        rows=a.row.astype(np.int32, copy=False),
        cols=a.col.astype(np.int32, copy=False),
        vals=a.data.astype(dtype, copy=False),
        shape=a.shape,
    )
    # distinct-offset count via presence table (no nnz sort)
    diffs = np.subtract(coo.cols, coo.rows, dtype=np.int64)
    present = np.zeros(2 * a.shape[0] - 1, np.bool_)
    present[diffs + (a.shape[0] - 1)] = True
    n_offs = int(present.sum())
    if n_offs <= 64:
        return coo_to_dia(coo)
    try:
        from ogl_tpu.kernels.gdia import gdia_from_coo

        return gdia_from_coo(coo, max_planes=48)
    except ValueError:
        pass
    coo = Coo(rows=jnp.asarray(coo.rows), cols=jnp.asarray(coo.cols),
              vals=jnp.asarray(coo.vals), shape=coo.shape)
    return coo_to_ell(coo)


def _apply_mat(level: "_Level", x):
    """Level SpMV (format-dispatched XLA path)."""
    from ogl_tpu.kernels.spmv import spmv as _spmv

    return _spmv(level.mat, x)


def _smooth(level: _Level, x, b, relax, iters: int, x_is_zero: bool = False):
    """IR with scalar Jacobi: x ← x + relax·D⁻¹(b − A x)  (reference
    smoother_gen: relaxation_factor 0.9, 2 iterations).  When the incoming
    x is identically zero (every pre-smooth: the cycle starts from a zero
    guess) the first sweep's A·0 SpMV is skipped — x₁ = relax·D⁻¹ b."""
    for it in range(iters):
        if it == 0 and x_is_zero:
            x = relax * level.inv_diag.astype(b.dtype) * b
            continue
        x = x + relax * level.inv_diag.astype(b.dtype) * (b - _apply_mat(level, x))
    return x


def _coarse_solve(level: _Level, b, iters: int):
    """Coarsest-level solve.  Preferred: one dense-inverse matvec (exact;
    a single op vs ~20 latency-bound ops for a CG loop), at HIGHEST
    precision so an f32 product is not rounded through TF32.  Fallback:
    fixed-iteration CG (reference coarsest_gen: CG with Iteration
    criterion only)."""
    if level.coarse_inv is not None:
        return jnp.matmul(level.coarse_inv.astype(b.dtype), b,
                          precision=jax.lax.Precision.HIGHEST).astype(b.dtype)
    return _coarse_cg(level, b, iters)


def cg_fixed_iters(apply_fn, b, iters: int):
    """Fixed-iteration CG from a zero guess — static fori_loop,
    breakdown-guarded.  Shared by the single-device and distributed
    (Schwarz) coarse solves."""
    tiny = 1e-30

    def body(_, carry):
        x, r, p, rho = carry
        q = apply_fn(p)
        pq = jnp.sum(p * q)
        alpha = rho / jnp.where(jnp.abs(pq) > tiny, pq, 1.0)
        alpha = jnp.where(jnp.abs(pq) > tiny, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * q
        rho_new = jnp.sum(r * r)
        beta = rho_new / jnp.where(rho > tiny, rho, 1.0)
        p = r + jnp.where(rho > tiny, beta, 0.0) * p
        return x, r, p, rho_new

    x0 = jnp.zeros_like(b)
    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, b, b, jnp.sum(b * b)))
    return x


def _coarse_cg(level: _Level, b, iters: int):
    return cg_fixed_iters(lambda v: _apply_mat(level, v), b, iters)


def amg(
    coo: Coo,
    max_levels: int = 9,
    min_coarse_rows: int = 10,
    cycle: str = "v",
    coarse_solver_iters: int = 4,
    relax: float = 0.9,
    smooth_iters: int = 2,
    aggregation: str = "natural",
    width: int = 8,
    coarse_solver: str = "direct",
):
    from ogl_tpu.precond import PrecondOp

    levels = build_hierarchy(coo, max_levels, min_coarse_rows, aggregation,
                             width=width, coarse_solver=coarse_solver)
    n_levels = len(levels)

    def run_level(lvls, li: int, b, w_mode: bool):
        level = lvls[li]
        if li == n_levels - 1:
            return _coarse_solve(level, b, coarse_solver_iters)
        recurse = 2 if (w_mode and li < n_levels - 2) else 1
        x = _smooth(level, jnp.zeros_like(b), b, relax, smooth_iters,
                    x_is_zero=True)
        for cyc in range(recurse):
            r = b - _apply_mat(level, x)
            rc = _restrict(level, r)
            ec = run_level(lvls, li + 1, rc, w_mode or (cycle == "f" and cyc == 0))
            x = x + _prolong(level, ec)
            x = _smooth(level, x, b, relax, smooth_iters)
        return x

    def apply(lvls, r):
        # one multigrid sweep with zero initial guess (with_criteria
        # Iteration max_iters 1 + zeroGuess, reference :314-345)
        return run_level(lvls, 0, r, cycle == "w").astype(r.dtype)

    return PrecondOp(apply, tuple(levels))
