"""Distributed additive-Schwarz preconditioners.

The reference wraps EVERY local preconditioner in an additive Schwarz over
the distributed matrix's local block in parallel runs
(Preconditioner.H:47-81 wrap_schwarz): each rank generates its
preconditioner from its own diagonal block and applies it to its shard of
the residual.  That is embarrassingly parallel under shard_map — the only
requirement is that every shard runs the SAME program, so per-shard factor
operators are packed into one format with uniform (union) structure and
stacked on the parts axis.

State layout contract: every state leaf carries a leading parts axis; the
shard body slices it off, leaving valid per-shard containers (Dia/Ell whose
static shape is the local block).  Applies reuse the single-device sweep /
SpMV code paths (ogl_tpu.precond.ilu semantics: Jacobi-sweep triangular
solves, the structure of the reference's IRILU, Preconditioner.H:146-178).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ogl_tpu.core.formats import Coo, Dia, Ell
from ogl_tpu.dist.partition import DiaStack, pack_local_stack

__all__ = ["build_schwarz", "SCHWARZ_NAMES"]

SCHWARZ_NAMES = ("BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI",
                 "Multigrid")


def _stacked_operator(shards, n_local: int, dtype):
    """Per-shard (rows, cols, vals) triples -> ONE format container whose
    leaves carry a leading parts axis (a valid Dia/Ell per shard after the
    slice inside shard_map)."""
    stack, _ = pack_local_stack(shards, n_local, dtype, fmt="auto")
    if isinstance(stack, DiaStack):
        return Dia(data=stack.data, offsets=stack.offsets,
                   shape=(n_local, n_local))
    return Ell(cols=stack.cols, vals=stack.vals, shape=(n_local, n_local))


def _coo_of(shard, n_local):
    rows, cols, vals = shard
    return Coo(rows=np.asarray(rows, np.int32), cols=np.asarray(cols, np.int32),
               vals=np.asarray(vals, np.float64), shape=(n_local, n_local))


def _safe_inv(d):
    return np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)


def _build_lu(shards, n_local, dtype, sweeps, variant, exact=False):
    """ILU-family: per-shard (L_strict, U_strict, 1/diag(U)) stacks.  With
    exact=True the sweep counts are the max factor depths across shards
    (exact substitution on every shard; SPMD needs one static count)."""
    from ogl_tpu.precond.ilu import factor_depth, ilu0_factors

    ls_shards, us_shards, inv_ud = [], [], np.ones((len(shards), n_local))
    d_l = d_u = 1
    for i, shard in enumerate(shards):
        coo = _coo_of(shard, n_local)
        if variant == "ILUT":
            lu = _ilut_factors(coo)
        else:
            lu = ilu0_factors(coo)
        (lr, lc, lv), (ur, uc, uv), ud = lu
        if exact:
            d_l = max(d_l, factor_depth(lr, lc, n_local))
            d_u = max(d_u, factor_depth(ur, uc, n_local))
        ls_shards.append((lr, lc, lv.astype(dtype)))
        us_shards.append((ur, uc, uv.astype(dtype)))
        nz = np.nonzero(ud)[0]
        inv_ud[i, nz] = 1.0 / ud[nz]
    Ls = _stacked_operator(ls_shards, n_local, dtype)
    Us = _stacked_operator(us_shards, n_local, dtype)
    state = (Ls, Us, jnp.asarray(inv_ud, dtype))
    from ogl_tpu.precond.ilu import make_lu_apply

    if exact:
        sweeps, sweeps_u = _agree_sweeps(d_l, d_u)
    else:
        sweeps_u = sweeps
    return make_lu_apply(sweeps, sweeps_u), state


def _agree_sweeps(d_l: int, d_u: int) -> tuple[int, int]:
    """Multi-process builds: every process must bake the SAME (static)
    exact-sweep counts into its compiled shard program, so the per-process
    factor depths are max-agreed through the structure hook (extra sweeps
    beyond a shard's own depth are exact no-ops)."""
    from ogl_tpu.dist import partition as _part

    hook = _part._STRUCT_AGREE_HOOK
    if hook is not None:
        d_l, d_u = hook("sweeps", d_l, d_u)
    return d_l, d_u


def _ilut_factors(coo: Coo):
    """Per-shard threshold ILU — the SAME factorisation the single-device
    path uses (native C++ ILUT when available, SuperLU fallback, ILU(0) as
    last resort), so distributed and serial ILUT agree for one config."""
    from ogl_tpu.precond.ilu import ilut_factors

    return ilut_factors(coo)


def _build_ic(shards, n_local, dtype, sweeps, variant, exact=False):
    """IC-family: per-shard (L_strict, Lᵀ_strict, 1/diag(L)) stacks."""
    from ogl_tpu.precond.ilu import factor_depth, ic0_factor

    ls_shards, lst_shards, inv_d = [], [], np.ones((len(shards), n_local))
    d_max = 1
    for i, shard in enumerate(shards):
        coo = _coo_of(shard, n_local)
        if variant == "ICT":
            (lr, lc, lv), ld = _ict_factor(coo)
        else:
            (lr, lc, lv), ld = ic0_factor(coo)
        if exact:
            d_max = max(d_max, factor_depth(lr, lc, n_local))
        ls_shards.append((lr, lc, lv.astype(dtype)))
        lst_shards.append((lc, lr, lv.astype(dtype)))
        nz = np.nonzero(ld)[0]
        inv_d[i, nz] = 1.0 / ld[nz]
    Ls = _stacked_operator(ls_shards, n_local, dtype)
    Lst = _stacked_operator(lst_shards, n_local, dtype)
    state = (Ls, Lst, jnp.asarray(inv_d, dtype))
    from ogl_tpu.precond.ilu import make_ic_apply

    if exact:
        sweeps, _ = _agree_sweeps(d_max, d_max)
    return make_ic_apply(sweeps, sweeps), state


def _ict_factor(coo: Coo):
    """Threshold IC factor triples for one shard; IC(0) on failure (same
    sweep apply either way)."""
    from ogl_tpu.precond.ilu import ic0_factor, ict_factor

    try:
        return ict_factor(coo)
    except Exception:
        return ic0_factor(coo)


def _build_isai(shards, n_local, dtype, sparsity_power, spd):
    """ISAI/GISAI: per-shard approximate inverse, stacked; apply = SpMV."""
    from ogl_tpu.precond.isai import isai_triples

    m_shards, mt_shards = [], []
    for shard in shards:
        coo = _coo_of(shard, n_local)
        mr, mc, mv = isai_triples(coo, sparsity_power=sparsity_power)
        m_shards.append((mr, mc, mv.astype(dtype)))
        mt_shards.append((mc, mr, mv.astype(dtype)))
    M = _stacked_operator(m_shards, n_local, dtype)
    if not spd:
        def apply_g(s, r):
            from ogl_tpu.kernels.spmv import spmv

            return spmv(s, r).astype(r.dtype)

        return apply_g, M
    Mt = _stacked_operator(mt_shards, n_local, dtype)

    def apply_spd(s, r):
        from ogl_tpu.kernels.spmv import spmv

        m, mt = s
        return (0.5 * (spmv(m, r) + spmv(mt, r))).astype(r.dtype)

    return apply_spd, (M, Mt)


def _build_bj(shards, n_local, dtype, block_size):
    """Per-shard block Jacobi: host-extracted contiguous blocks, batched
    inverse, stacked (P, nb, bs, bs)."""
    bs = max(int(block_size), 1)
    nb = -(-n_local // bs)
    p = len(shards)
    inv = np.zeros((p, nb, bs, bs), dtype)
    for i, (rows, cols, vals) in enumerate(shards):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        blocks = np.zeros((nb, bs, bs))
        sel = (rows // bs) == (cols // bs)
        np.add.at(blocks, (rows[sel] // bs, rows[sel] % bs, cols[sel] % bs),
                  np.asarray(vals)[sel])
        # identity-pad empty diagonal positions (rows beyond the true size)
        d = np.abs(np.einsum("bii->bi", blocks))
        blocks += np.einsum("bi,ij->bij", (d == 0).astype(np.float64), np.eye(bs))
        inv[i] = np.linalg.inv(blocks).astype(dtype)

    state = jnp.asarray(inv)

    def apply(s, r):
        rp = jnp.pad(r, (0, nb * bs - n_local)).reshape(nb, bs)
        y = jnp.einsum("bij,bj->bi", s.astype(r.dtype), rp,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)[: n_local]

    return apply, state


def _build_amg(shards, n_local, dtype, cfg):
    """Per-shard local AMG under additive Schwarz (the reference wraps its
    Multigrid preconditioner like any other local preconditioner,
    Preconditioner.H:47-81).  Structure uniformity across shards — required
    so every shard runs the same program — comes from (a) padding every
    local block to n_local with unit diagonals, (b) natural (consecutive-
    run) aggregation with a fixed width, giving identical level sizes, and
    (c) union-offset Dia / common-width Ell level operators
    (_stacked_operator).  Coarse solve = stacked dense inverses, one
    einsum.

    Aggregation: geometric 2x-per-axis blocks when the AGREED union
    offsets of the level-0 stacked operator form a box-grid stencil and
    n_local factors (contiguous-range slab shards of a lexicographic
    grid); 1-D consecutive runs otherwise.  pack_local_stack has already
    unified those offsets across processes via the structure-agreement
    hook, so every process (and every shard) lands on the same
    aggregation and the same level sizes."""
    import scipy.sparse as sp

    from ogl_tpu.precond.amg import (grid_aggregate, grid_dims_of,
                                     grid_prolong, grid_restrict)

    w = max(2, cfg.coarsening_rate)
    relax = 0.9
    sweeps = max(1, cfg.smoother_sweeps)

    mats = []
    for shard in shards:
        rows, cols, vals = (np.asarray(x) for x in shard)
        a = sp.csr_matrix(
            (vals.astype(np.float64), (rows.astype(np.int64), cols.astype(np.int64))),
            shape=(n_local, n_local))
        d = a.diagonal()
        fix = np.nonzero(d == 0)[0]
        if len(fix):
            a = (a + sp.csr_matrix((np.ones(len(fix)), (fix, fix)),
                                   shape=a.shape)).tocsr()
        mats.append(a)

    stop = max(cfg.min_coarse_rows, min(2048, max(1, n_local // 16)))
    level_meta = []  # (offsets-static op template, n_l, nc) via closure lists
    level_ops = []
    level_invd = []
    n_l = n_local
    level_grid = []  # per-level (nz, ny, nx, nzc, nyc, nxc) or None
    grid_dims = None
    for li in range(cfg.max_levels):
        if n_l <= stop:
            break
        triples = []
        for a in mats:
            c = a.tocoo()
            order = np.lexsort((c.col, c.row))
            triples.append((c.row[order], c.col[order], c.data[order]))
        op = _stacked_operator(triples, n_l, dtype)
        if li == 0 and cfg.aggregation in ("auto", "grid") and isinstance(op, Dia):
            grid_dims = grid_dims_of([int(o) for o in np.asarray(op.offsets)],
                                     n_l)
        if grid_dims is not None:
            agg, coarse_dims = grid_aggregate(grid_dims)
            nc = int(np.prod(coarse_dims))
            gtuple = tuple(grid_dims) + tuple(coarse_dims)
        else:
            agg = np.arange(n_l, dtype=np.int64) // w
            nc = -(-n_l // w)
            gtuple = None
        invd = np.stack([_safe_inv(a.diagonal()) for a in mats]).astype(dtype)
        level_ops.append(op)
        level_invd.append(jnp.asarray(invd))
        level_meta.append((n_l, nc))
        level_grid.append(gtuple)
        pm = sp.csr_matrix(
            (np.ones(n_l), (np.arange(n_l), agg)), shape=(n_l, nc))
        mats = [(pm.T @ a @ pm).tocsr() for a in mats]
        if grid_dims is not None:
            grid_dims = coarse_dims
        n_l = nc

    # dense inverse only when the coarsest level is small enough (same cap
    # as the single-device build_hierarchy); otherwise fall back to a
    # fixed-iteration coarse CG on the stacked operator
    dense_coarse_max = 4096
    n_coarse = mats[0].shape[0]
    if n_coarse <= dense_coarse_max:
        coarse_state = jnp.asarray(np.stack(
            [np.linalg.pinv(a.toarray(), rcond=1e-12) for a in mats]).astype(dtype))
        coarse_is_dense = True
    else:
        triples = []
        for a in mats:
            c = a.tocoo()
            order = np.lexsort((c.col, c.row))
            triples.append((c.row[order], c.col[order], c.data[order]))
        coarse_state = _stacked_operator(triples, n_coarse, dtype)
        coarse_is_dense = False
    coarse_iters = max(4, cfg.coarse_solver_iters)

    state = (tuple(level_ops), tuple(level_invd), coarse_state)
    n_levels = len(level_meta)

    def _coarse_cg(op, bvec):
        from ogl_tpu.kernels.spmv import spmv as _spmv
        from ogl_tpu.precond.amg import cg_fixed_iters

        return cg_fixed_iters(lambda v: _spmv(op, v), bvec, coarse_iters)

    def apply(s, r):
        ops_, invds, cinv = s

        def smooth(li, x, bvec, x_is_zero=False):
            invd = invds[li].astype(bvec.dtype)
            for it in range(sweeps):
                if it == 0 and x_is_zero:
                    x = relax * invd * bvec
                else:
                    from ogl_tpu.kernels.spmv import spmv as _spmv

                    x = x + relax * invd * (bvec - _spmv(ops_[li], x))
            return x

        def cyc(li, bvec):
            from ogl_tpu.kernels.spmv import spmv as _spmv

            if li == n_levels:
                if coarse_is_dense:
                    return jnp.matmul(
                        cinv.astype(bvec.dtype), bvec,
                        precision=jax.lax.Precision.HIGHEST).astype(bvec.dtype)
                return _coarse_cg(cinv, bvec)
            nl, nc = level_meta[li]
            x = smooth(li, None, bvec, x_is_zero=True)
            res = bvec - _spmv(ops_[li], x)
            rc = (grid_restrict(level_grid[li], res)
                  if level_grid[li] is not None else
                  jnp.pad(res, (0, nc * w - nl)).reshape(nc, w).sum(axis=1))
            ec = cyc(li + 1, rc)
            ef = (grid_prolong(level_grid[li], ec)
                  if level_grid[li] is not None else
                  jnp.broadcast_to(ec[:, None], (nc, w)).reshape(-1)[:nl])
            x = x + ef
            return smooth(li, x, bvec)

        return cyc(0, r).astype(r.dtype)

    return apply, state


def build_schwarz(cfg, shards, n_local: int, dtype):
    """Factory for the distributed (additive-Schwarz-wrapped) preconditioner
    set — the parallel counterpart of precond.build, mirroring the
    reference's init_preconditioner_impl + wrap_schwarz
    (Preconditioner.H:47-81, :83-351).

    shards: per-shard local-block COO triples (host rows, cols, vals).
    Returns (apply_fn, state_stack) for dist_solve's `precond=`.
    """
    built = _build_schwarz_impl(cfg, shards, n_local, dtype)
    if built is not None and cfg.value_precision in ("float32", "bfloat16"):
        # reduced-precision state (fvSolution key `precision`) — same
        # trade as the single-device path (precond.build): the Schwarz
        # apply accumulates against the f32 residual, only the stored
        # per-shard operators narrow
        from ogl_tpu.core.formats import cast_values

        apply_fn, state = built
        return apply_fn, cast_values(state, jnp.dtype(cfg.value_precision))
    return built


def _build_schwarz_impl(cfg, shards, n_local: int, dtype):
    name = cfg.name
    if name == "none":
        return None
    if name == "BJ":
        return _build_bj(shards, n_local, dtype, cfg.max_block_size)
    if name in ("ILU", "ILUT", "IRILU"):
        sweeps = 5 if name == "IRILU" else cfg.tri_solve_sweeps
        exact = name != "IRILU" and cfg.tri_solve == "exact"
        return _build_lu(shards, n_local, dtype, sweeps, name, exact=exact)
    if name in ("IC", "ICT"):
        return _build_ic(shards, n_local, dtype, cfg.tri_solve_sweeps, name,
                         exact=cfg.tri_solve == "exact")
    if name == "ISAI":
        return _build_isai(shards, n_local, dtype, cfg.sparsity_power, spd=True)
    if name == "GISAI":
        return _build_isai(shards, n_local, dtype, cfg.sparsity_power, spd=False)
    if name == "Multigrid":
        return _build_amg(shards, n_local, dtype, cfg)
    raise ValueError(
        f"unsupported distributed preconditioner: {name}; valid: "
        f"none, {', '.join(SCHWARZ_NAMES)}"
    )
