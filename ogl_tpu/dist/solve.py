"""Distributed solve: shard_map'd Krylov loops over a device mesh.

The reference's distributed solve (`solve_multi_gpu_impl`,
lduLduBase.H:189-308) maps as:
  Ginkgo dist Matrix::apply (local + non-local SpMV w/ sparse_communicator)
      -> `dist_ops`: per-shard fast-format local SpMV (Dia: gather-free;
         Ell fallback) + ppermute halo rounds + surface-sized COO halo apply
  dist Vector compute_norm1/compute_mean (device reduce + MPI allreduce)
      -> jnp reductions + lax.psum over the mesh axis
  MPI_Comm + executor pairing -> jax Mesh + shard_map

The SAME solver bodies (ogl_tpu.solve.*) run inside shard_map — only the
Ops bundle changes.  Every shard executes an identical program (SPMD); the
stopping criterion state is replicated because every reduction is psum'd.

Preconditioning is additive Schwarz exactly like the reference wraps every
local preconditioner in parallel runs (Preconditioner.H:47-81): per-shard
states are stacked on the parts axis and applied inside shard_map (see
ogl_tpu.dist.precond).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ogl_tpu.core.formats import Dia
from ogl_tpu.dist.partition import DistMatrix, HaloPlan, shard_local_matrix
from ogl_tpu.solve import bicgstab, cg, gmres, ir
from ogl_tpu.solve.cg_pipe import cg_pipelined
from ogl_tpu.solve.krylov import Ops

__all__ = ["halo_exchange", "dist_ops", "dist_solve", "local_diag",
           "schwarz_jacobi_builder", "schwarz_block_jacobi_builder"]


def local_diag(m):
    """Diagonal of a per-shard local matrix (Dia, Xell or Ell container)."""
    if isinstance(m, Dia):
        if 0 in m.offsets:
            return m.data[m.offsets.index(0)]
        return jnp.zeros((m.shape[0],), m.dtype)
    if type(m).__name__ == "Gdia":
        # diag entries live in planes with block-row offset 0 where the
        # stored source lane equals the destination lane
        idx0 = [k for k, q in enumerate(m.plane_offsets) if q == 0]
        r_, lanes_ = int(m.vals.shape[1]), int(m.vals.shape[2])
        lane = jax.lax.broadcasted_iota(jnp.int32, (r_, lanes_), 1)
        d = jnp.zeros((r_, lanes_), m.vals.dtype)
        for k in idx0:
            d = d + jnp.where(m.lidx[k].astype(jnp.int32) == lane,
                              m.vals[k], 0.0)
        return d.reshape(-1)[: m.shape[0]]
    if type(m).__name__ == "Xell":
        # row r = (tile*TB + t)*LANES + l is diagonal when the slot's
        # stage-2 source lane is l AND its stage-1 window-relative block is
        # the row's own block (wrel = t -> wloc = t + c_left*128)
        nt, k, tb, lanes = m.vals.shape
        t_idx = jax.lax.broadcasted_iota(jnp.int32, (nt, k, tb, lanes), 2)
        l_idx = jax.lax.broadcasted_iota(jnp.int32, (nt, k, tb, lanes), 3)
        bb = jnp.swapaxes(m.bbT, 2, 3).astype(jnp.int32)  # (nt,k,TB,LANES)
        is_diag = ((m.ll.astype(jnp.int32) == l_idx)
                   & (bb == t_idx + m.c_left * 128))
        d = jnp.sum(jnp.where(is_diag, m.vals, 0.0), axis=1)
        d = d.reshape(-1)[: m.shape[0]]
        if int(m.spill.vals.shape[0]):
            d = d + jax.ops.segment_sum(
                jnp.where(m.spill.rows == m.spill.cols, m.spill.vals, 0.0),
                m.spill.rows, num_segments=m.shape[0])
        return d
    row_ids = jnp.arange(m.shape[0])[:, None]
    return jnp.sum(jnp.where(m.cols == row_ids, m.vals, 0.0), axis=1)


def schwarz_jacobi_builder(local_m):
    """Per-shard scalar Jacobi (additive Schwarz, the parallel default of
    the reference's wrap_schwarz, Preconditioner.H:47-81)."""
    diag = local_diag(local_m)
    inv = jnp.where(jnp.abs(diag) > 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 0.0)
    return lambda r: inv * r


def schwarz_block_jacobi_builder(block_size: int):
    """Per-shard BLOCK Jacobi under additive Schwarz: contiguous blocks of
    `block_size` rows of the shard-local matrix, inverted with a batched
    dense solve inside the shard (regenerated per solve like the reference
    with caching=0)."""
    bs = int(block_size)
    if bs <= 1:
        return schwarz_jacobi_builder

    def builder(local_m):
        n_local = local_m.shape[0]
        nb = -(-n_local // bs)
        blocks = jnp.zeros((nb + 1, bs, bs), local_m.dtype)
        if isinstance(local_m, Dia):
            i = jnp.arange(n_local)
            for k, off in enumerate(local_m.offsets):
                j = i + off
                in_block = (j >= 0) & (j < n_local) & (j // bs == i // bs)
                bidx = jnp.where(in_block, i // bs, nb)
                jc = jnp.clip(j, 0, n_local - 1)
                blocks = blocks.at[bidx, i % bs, jc % bs].add(
                    jnp.where(in_block, local_m.data[k], 0.0)
                )
        else:
            cols = local_m.cols
            vals = local_m.vals
            n_local, width = cols.shape
            rows = jnp.repeat(jnp.arange(n_local), width).reshape(n_local, width)
            in_block = (rows // bs) == (cols // bs)
            bidx = jnp.where(in_block, rows // bs, nb)
            blocks = blocks.at[bidx, rows % bs, cols % bs].add(
                jnp.where(in_block, vals, 0.0)
            )
        blocks = blocks[:nb]
        # identity-pad empty diagonal positions (padded rows beyond n_local)
        eye = jnp.eye(bs, dtype=blocks.dtype)
        diag_abs = jnp.abs(jnp.einsum("bii->bi", blocks))
        fix = (diag_abs == 0).astype(blocks.dtype)
        blocks = blocks + fix[:, :, None] * eye[None]
        inv = jnp.linalg.inv(blocks)

        def apply(r):
            rp = jnp.pad(r, (0, nb * bs - n_local)).reshape(nb, bs)
            y = jnp.einsum("bij,bj->bi", inv.astype(r.dtype), rp,
                           precision=jax.lax.Precision.HIGHEST)
            return y.reshape(-1)[:n_local]

        return apply

    return builder


_SOLVERS = {"GKOCG": cg, "GKOBiCGStab": bicgstab, "GKOGMRES": gmres,
            "GKOIR": ir,
            # single-reduction Chronopoulos–Gear CG: ONE psum per iteration
            # instead of three (solve/cg_pipe.py; `pipelinedCG true` in the
            # foam front end, or solver="GKOPipeCG" here directly)
            "GKOPipeCG": cg_pipelined}


def halo_exchange(x, plan: HaloPlan, axis: str):
    """Fill this shard's halo buffer from neighbour shards: one ppermute per
    static ring-offset class (the compiled form of the reference's
    sparse_communicator neighbour sends)."""
    p = plan.n_parts
    h = jnp.zeros((plan.halo_size + 1,), x.dtype)  # +1 = parking slot for pads
    for off, sidx, rpos in zip(plan.offsets, plan.send_idx, plan.recv_pos):
        my = jax.lax.axis_index(axis)
        payload = jnp.take(x, sidx[my], axis=0)
        perm = [(i, (i + off) % p) for i in range(p)]
        recvd = jax.lax.ppermute(payload, axis, perm)
        h = h.at[rpos[my]].set(recvd)
    return h[: plan.halo_size]


def _halo_apply(halo_rows, halo_cols, halo_vals, h, n_local: int):
    """Surface-sized non-local apply: y += A_halo @ h (pads: val 0)."""
    contrib = halo_vals * jnp.take(h, halo_cols, axis=0)
    return jax.ops.segment_sum(contrib, halo_rows, num_segments=n_local)


def dist_ops(local_m, halo, plan: HaloPlan, global_n: int, axis: str,
             precond=None, apply_affine=None, e_true: int = 0) -> Ops:
    """Ops bundle for use INSIDE shard_map.  `local_m` is the per-shard
    local matrix (Dia/Ell container); `halo` the per-shard COO triple
    (rows, cols, vals) with leading axes already stripped; reductions psum
    over `axis`.  With an affine plan (+ apply_affine/e_true from the
    DistMatrix) and a 128-aligned shard, the exchange and halo apply run
    the slice/matmul route (dist.affine) instead of XLA's element-serial
    gathers."""
    from ogl_tpu.kernels.spmv import spmv

    n_local = local_m.shape[0]
    h_rows, h_cols, h_vals = halo
    affine_ok = (plan.send_affine is not None and apply_affine is not None
                 and n_local % 128 == 0)
    if affine_ok and plan.offsets:
        # slot-order value permutation hoisted out of the iteration loop
        # (dist_ops is built once per solve, mv runs per iteration)
        _my = jax.lax.axis_index(axis)
        _vals_so = jnp.take(h_vals[:e_true], apply_affine.entry_perm[_my],
                            axis=0)

    def mv(x):
        y = spmv(local_m, x)
        if plan.offsets:
            if affine_ok:
                from ogl_tpu.dist.affine import (affine_apply,
                                                 affine_exchange)

                my = jax.lax.axis_index(axis)
                h = affine_exchange(
                    x.reshape(-1, 128), plan.send_affine, plan.recv_affine,
                    plan.offsets, plan.halo_size, plan.n_parts, axis, my)
                y2, _ = affine_apply(y.reshape(-1, 128), None, h, _vals_so,
                                     apply_affine.rows, my)
                return y2.reshape(-1)
            h = halo_exchange(x, plan, axis)
            y = y + _halo_apply(h_rows, h_cols, h_vals, h, n_local)
        return y

    return Ops(
        matvec=mv,
        precond=precond if precond is not None else (lambda r: r),
        sum=lambda v: jax.lax.psum(jnp.sum(v), axis),
        global_size=global_n,
        allreduce=lambda v: jax.lax.psum(v, axis),
    )


def dist_solve(
    dm: DistMatrix,
    b_stack,
    x0_stack,
    stopping_params,
    mesh: Mesh,
    axis: str = "x",
    solver: str = "GKOCG",
    precond_builder=None,
    precond=None,
    krylov_dim: int = 100,
):
    """Run a Krylov solve over the mesh.  b/x0 are (P, n_local) stacks
    (padded rows zero).

    Preconditioning (additive-Schwarz semantics, each shard preconditions
    with its local block only — reference Preconditioner.H:47-81
    wrap_schwarz), either of:
      precond_builder: maps the per-shard local matrix container to an
                       apply closure (built inside the shard program);
      precond:         (apply_fn, state_stack) — host-built per-shard
                       states stacked on the parts axis (see
                       ogl_tpu.dist.precond); apply_fn(state, r) -> z.

    Returns (x_stack, SolveResult-of-replicated-scalars).
    """
    pc_apply, pc_stack = precond if precond is not None else (None, ())
    fn = make_dist_solve_fn(dm, mesh, axis=axis, solver=solver,
                            precond_builder=precond_builder,
                            pc_apply=pc_apply, krylov_dim=krylov_dim)
    return fn(dm.local, dm.halo, b_stack, x0_stack, stopping_params, pc_stack)


def make_dist_solve_fn(dm: DistMatrix, mesh: Mesh, axis: str = "x",
                       solver: str = "GKOCG", precond_builder=None,
                       pc_apply=None, krylov_dim: int = 100,
                       history_len: int = 0, inner_params=None,
                       inner_precision: str = "default",
                       basis_dtype=None):
    """Build ONCE the jitted shard_map program for distributed solves.

    The returned fn(local_stack, halo_stack, b_stack, x0_stack,
    stopping_params, pc_state_stack) -> (x_stack, SolveResult) treats
    matrix values, vectors, stopping controls, and preconditioner state as
    TRACED arguments, so steady-state coefficient updates, adaptMinIter
    changes, and TTL preconditioner regeneration all reuse the compiled
    program (the FoamSolver._compiled design; rebuilding the closure per
    solve would recompile every call).  Only the dm's STATIC parts (plan,
    sizes, format structure) are baked in."""
    solve_fn = _SOLVERS[solver]
    kw = {"krylov_dim": krylov_dim} if solver == "GKOGMRES" else {}
    if solver == "GKOGMRES" and basis_dtype is not None:
        # bf16 Krylov-basis storage (basisPrecision bfloat16): halves each
        # shard's dominant per-iteration V stream; H/Givens/dots/x stay
        # full precision (solve/gmres.py)
        kw["basis_dtype"] = basis_dtype
    if history_len > 0:
        # per-iteration residual history (reference export_res,
        # StoppingCriterion.C:115-117) — replicated, so P() out spec
        kw["history_len"] = history_len
    n_local, global_n, plan = dm.n_local, dm.global_n, dm.plan
    aff = dm.apply_affine
    e_true = dm.halo_sizes[0] if dm.halo_sizes else 0

    def shard_body(local, halo, b, x0, sp, pc_state):
        local_m = shard_local_matrix(local, n_local)
        halo_t = (halo.rows[0], halo.cols[0], halo.vals[0])
        b, x0 = b[0], x0[0]
        if pc_apply is not None:
            state = jax.tree.map(lambda a: a[0], pc_state)
            pc = lambda r: pc_apply(state, r)
        elif precond_builder is not None:
            pc = precond_builder(local_m)
        else:
            pc = None
        ops = dist_ops(local_m, halo_t, plan, global_n, axis, precond=pc,
                       apply_affine=aff, e_true=e_true)
        if solver == "GKOIR" and inner_params is not None:
            # inner CG with its own OpenFOAM criterion (reference
            # create_default, GKOIR.H:58-78), distributed: the inner matvec
            # still halo-exchanges and psums over the mesh; the Schwarz
            # preconditioner steers the INNER iteration.  With
            # inner_precision bfloat16 the inner streams half-width local
            # and halo operators; the outer residual uses full precision
            # (mixed-precision defect correction, cf. foam/solver.py).
            idt = {"bfloat16": jnp.bfloat16,
                   "float32": jnp.float32}.get(inner_precision)
            if idt is not None:
                from ogl_tpu.core.formats import cast_values

                i_ops = dist_ops(
                    cast_values(local_m, idt),
                    (halo_t[0], halo_t[1], halo_t[2].astype(idt)),
                    plan, global_n, axis, precond=pc,
                    apply_affine=aff, e_true=e_true)
            else:
                i_ops = ops
            o_ops = dist_ops(local_m, halo_t, plan, global_n, axis,
                             apply_affine=aff, e_true=e_true)

            def inner(r):
                return cg(i_ops, r, jnp.zeros_like(r), inner_params).x

            res = ir(o_ops, b, x0, sp, inner_solve=inner,
                     history_len=kw.get("history_len", 0))
        else:
            res = solve_fn(ops, b, x0, sp, **kw)
        hist = res.history if res.history is not None else jnp.zeros((1,), b.dtype)
        return (
            res.x[None],
            res.iters,
            res.init_res_norm,
            res.final_res_norm,
            res.converged,
            hist,
        )

    spec_stack = P(axis)
    mapped = jax.jit(jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(spec_stack, spec_stack, spec_stack, spec_stack, P(),
                  spec_stack),
        out_specs=(spec_stack, P(), P(), P(), P(), P()),
        check_vma=False,
    ))

    def run(local, halo, b_stack, x0_stack, stopping_params, pc_stack=()):
        x, iters, init_rn, final_rn, conv, hist = mapped(
            local, halo, b_stack, x0_stack, stopping_params, pc_stack)
        from ogl_tpu.solve.cg import SolveResult

        return x, SolveResult(x=x, iters=iters, init_res_norm=init_rn,
                              final_res_norm=final_rn, converged=conv,
                              history=hist if history_len > 0 else None)

    return run
