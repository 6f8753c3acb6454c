"""Distributed (shard_map) tests on the 8-device virtual CPU mesh —
the analogue of the reference's oversubscribed-MPI CI
(integration-tests.yml: multi-rank without a cluster)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from ogl_tpu import dist
from ogl_tpu import testing as problems
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import formats, ldu
from ogl_tpu.dist.partition import (
    DiaStack, gather_global, partition_coo, shard_local_matrix, split_vector,
)
from ogl_tpu.solve.stopping import StoppingParams


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def _poisson_coo(dims):
    return ldu.ldu_to_coo(problems.poisson_ldu(dims)), problems.poisson_dense(dims)


def dist_matvec(dm, mesh, xs):
    """Helper: y = A @ x over the mesh through the public dist_ops path."""

    def body(local, halo, xv):
        lm = shard_local_matrix(local, dm.n_local)
        ops = dist.dist_ops(lm, (halo.rows[0], halo.cols[0], halo.vals[0]),
                            dm.plan, dm.global_n, "x")
        return ops.matvec(xv[0])[None]

    return jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
                      out_specs=P("x"), check_vma=False)
    )(dm.local, dm.halo, xs)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
@pytest.mark.parametrize("local_format", ["auto", "Ell"])
def test_dist_matvec_matches_global(n_parts, local_format):
    coo, a = _poisson_coo((16, 16))
    dm = partition_coo(coo, n_parts, local_format=local_format)
    if local_format == "auto":
        # a stencil matrix's contiguous shards are banded -> Dia local blocks
        assert isinstance(dm.local, DiaStack)
    rng = np.random.default_rng(0)
    x = rng.normal(size=a.shape[0])
    xs = jnp.asarray(split_vector(dm, x))
    y = dist_matvec(dm, _mesh(n_parts), xs)
    np.testing.assert_allclose(gather_global(dm, y), a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_parts", [2, 8])
def test_dist_reductions(n_parts):
    coo, a = _poisson_coo((8, 8))
    dm = partition_coo(coo, n_parts)
    rng = np.random.default_rng(1)
    v = rng.normal(size=a.shape[0])
    vs = jnp.asarray(split_vector(dm, v))
    mesh = _mesh(n_parts)
    dummy = formats.Dia(data=jnp.zeros((1, dm.n_local)), offsets=(0,),
                        shape=(dm.n_local, dm.n_local))
    halo0 = (jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), jnp.zeros(1))

    def body(x):
        ops = dist.dist_ops(dummy, halo0, dm.plan, dm.global_n, "x")
        return jnp.stack([ops.norm1(x[0]), ops.sum(x[0] * x[0]), ops.mean(x[0])])[None]

    out = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                      check_vma=False)
    )(vs)
    out = np.asarray(out)
    for row in out:  # replicated across shards
        np.testing.assert_allclose(row[0], np.abs(v).sum(), rtol=1e-12)
        np.testing.assert_allclose(row[1], (v * v).sum(), rtol=1e-12)
        np.testing.assert_allclose(row[2], v.sum() / a.shape[0], rtol=1e-12)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOBiCGStab", "GKOGMRES",
                                    "GKOPipeCG"])
def test_dist_solve_matches_single_device(solver):
    coo, a = _poisson_coo((16, 16))
    n = a.shape[0]
    dm = partition_coo(coo, 4)
    rng = np.random.default_rng(2)
    x_true = rng.normal(size=n)
    b = a @ x_true
    bs = jnp.asarray(split_vector(dm, b))
    x0 = jnp.zeros_like(bs)
    mesh = _mesh(4)
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=600))
    kw = {"krylov_dim": 40} if solver == "GKOGMRES" else {}
    x, res = dist.dist_solve(dm, bs, x0, sp, mesh, solver=solver, **kw)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_allclose(gather_global(dm, x), x_true, atol=1e-6)
    # iteration parity with single-device solve of the same system
    from ogl_tpu.kernels import spmv
    from ogl_tpu.solve import cg as cg_fn, bicgstab as bi_fn, gmres as gm_fn
    from ogl_tpu.solve.cg_pipe import cg_pipelined
    from ogl_tpu.solve.krylov import single_device_ops

    ops = single_device_ops(spmv.matvec(coo), n)
    fn = {"GKOCG": cg_fn, "GKOBiCGStab": bi_fn, "GKOGMRES": gm_fn,
          "GKOPipeCG": cg_pipelined}[solver]
    ref = fn(ops, jnp.asarray(b), jnp.zeros(n), StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=600), **kw)
    it_dist, it_ref = int(np.asarray(res.iters).ravel()[0]), int(ref.iters)
    if solver == "GKOBiCGStab":
        # BiCGStab's convergence tail is sensitive to reduction order;
        # psum order differs from a single-device sum, so allow slack
        assert abs(it_dist - it_ref) <= max(5, it_ref // 10), (it_dist, it_ref)
    else:
        assert it_dist == it_ref


def test_dist_solve_schwarz_jacobi():
    """Additive-Schwarz block preconditioning: per-shard scalar Jacobi
    (the diagonal is shard-local, so Schwarz-Jacobi == global Jacobi)."""
    coo, a = _poisson_coo((16, 16))
    dm = partition_coo(coo, 4)
    rng = np.random.default_rng(3)
    x_true = rng.normal(size=a.shape[0])
    b = a @ x_true
    bs = jnp.asarray(split_vector(dm, b))
    mesh = _mesh(4)
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=600))

    x, res = dist.dist_solve(dm, bs, jnp.zeros_like(bs), sp, mesh,
                             solver="GKOCG",
                             precond_builder=dist.schwarz_jacobi_builder)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_allclose(gather_global(dm, x), x_true, atol=1e-6)


def test_partition_pads_are_inert():
    # 10 rows over 4 parts -> uneven 3/2/3/2 with padding
    coo, a = _poisson_coo((10,))
    dm = partition_coo(coo, 4)
    assert dm.local_sizes == (2, 3, 2, 3) or sum(dm.local_sizes) == 10
    rng = np.random.default_rng(4)
    x = rng.normal(size=10)
    xs = jnp.asarray(split_vector(dm, x))
    y = dist_matvec(dm, _mesh(4), xs)
    np.testing.assert_allclose(gather_global(dm, y), a @ x, atol=1e-12)
    # padded slots stay exactly zero
    y = np.asarray(y)
    for i, sz in enumerate(dm.local_sizes):
        assert np.all(y[i, sz:] == 0.0)


def test_runtime_stage_stack():
    """Multi-host staging path: per-device shards assemble into the
    parts-stacked global array without a full-stack host copy, and the
    staged stack drives a distributed solve."""
    from ogl_tpu.dist import runtime

    assert runtime.init_distributed() is False  # single-process: no-op
    coo, a = _poisson_coo((16, 8))
    dm = partition_coo(coo, 8)
    mesh = runtime.global_mesh()
    rng = np.random.default_rng(9)
    x_true = rng.normal(size=a.shape[0])
    b_parts = list(split_vector(dm, a @ x_true))
    bs = runtime.stage_stack(b_parts, mesh)
    assert bs.shape == (8, dm.n_local)
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=600))
    x, res = dist.dist_solve(dm, bs, jnp.zeros((8, dm.n_local)), sp, mesh)
    assert bool(np.asarray(res.converged).all())
    np.testing.assert_allclose(gather_global(dm, x), x_true, atol=1e-6)


def test_pack_local_stack_unsorted_triples():
    """The ELL fallback must accept triples in ANY order (factor/inverse
    patterns arrive transposed or column-major from the preconditioner
    builders) — regression: unsorted rows made the slot computation go
    negative, crashing or silently corrupting the stacked operator."""
    from ogl_tpu.core.formats import Ell
    from ogl_tpu.dist.partition import EllStack, pack_local_stack
    from ogl_tpu.kernels.spmv import spmv

    rng = np.random.default_rng(5)
    n = 24
    dense = (rng.random((n, n)) < 0.2) * rng.normal(size=(n, n))
    np.fill_diagonal(dense, 3.0)
    r, c = np.nonzero(dense)
    v = dense[r, c]
    perm = rng.permutation(len(r))  # scramble entry order
    shards = [(r[perm], c[perm], v[perm])]
    stack, dest = pack_local_stack(shards, n, np.float64, fmt="Ell")
    assert isinstance(stack, EllStack)
    ell = Ell(cols=stack.cols[0], vals=stack.vals[0], shape=(n, n))
    x = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(spmv(ell, jnp.asarray(x))),
                               dense @ x, rtol=1e-12)
    # dest maps ORIGINAL entry order to slots
    flat = np.zeros(n * stack.vals.shape[-1] + 1)
    np.add.at(flat, np.asarray(dest[0]), v[perm])
    np.testing.assert_allclose(
        flat[:-1].reshape(n, -1).sum(axis=1), dense.sum(axis=1), rtol=1e-12)


def test_dist_gdia_local_stack():
    """Unstructured shards (bandwidth too wide for DIA after partitioning)
    pack into a GdiaStack — the lane-gather local format — and solve to
    the right answer, including the steady-state value update."""
    import dataclasses

    from ogl_tpu.config import StoppingConfig
    from ogl_tpu.dist.from_ranks import DistAssembler
    from ogl_tpu.dist.partition import GdiaStack, gather_global, split_vector
    from ogl_tpu.dist.solve import dist_solve
    from ogl_tpu.solve.stopping import StoppingParams

    # a stencil plus a long-range symmetric coupling per row: > 64 distinct
    # diagonal offsets, well-bounded Gdia plane table
    m0 = problems.poisson_ldu((64, 32))
    rng = np.random.default_rng(8)
    n = m0.n
    # short enough to stay INSIDE a 512-row shard, varied enough to exceed
    # the 64-offset DIA cap
    extra_rows = np.arange(0, n - 101)
    extra_cols = extra_rows + 30 + (extra_rows % 70)
    keep = (extra_rows // 512) == (extra_cols // 512)  # intra-shard only
    extra_rows, extra_cols = extra_rows[keep], extra_cols[keep]
    la = np.concatenate([m0.lower_addr, extra_rows])
    ua = np.concatenate([m0.upper_addr, extra_cols])
    order = np.lexsort((ua, la))
    up = np.concatenate([m0.upper, np.full(len(extra_rows), -0.01)])[order]
    diag = m0.diag + 0.1  # keep diagonally dominant
    m = ldu.LduMatrix(n=n, lower_addr=la[order], upper_addr=ua[order],
                      diag=diag, upper=up)
    parts = ldu.decompose(m, 4)
    asm = DistAssembler(parts, dtype=np.float64)
    assert isinstance(asm.dm.local, GdiaStack), type(asm.dm.local)

    from ogl_tpu.core import formats as _f

    a = _f.to_dense(ldu.ldu_to_coo_host(m))
    x_true = rng.normal(size=n)
    b = a @ x_true
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-11, rel_tol=0.0,
                                          max_iter=2000))
    bs = jnp.asarray(split_vector(asm.dm, b))
    x, res = dist_solve(asm.dm, bs, jnp.zeros_like(bs), sp, mesh)
    np.testing.assert_allclose(gather_global(asm.dm, x), x_true, atol=1e-7)

    # steady-state value update through the Gdia dest map
    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    asm.update(ldu.decompose(m2, 4))
    x2, res2 = dist_solve(asm.dm, bs, jnp.zeros_like(bs), sp, mesh)
    np.testing.assert_allclose(gather_global(asm.dm, x2), x_true / 2,
                               atol=1e-7)


# ---- self-neighbor halo: forced/self halo routes execute a real
# ppermute round even on a one-device mesh -------------------------------------------------------


def _periodic_ring_coo(n, diag=2.1):
    i = np.arange(n)
    rows = np.concatenate([i, i, i])
    cols = np.concatenate([i, (i + 1) % n, (i - 1) % n])
    vals = np.concatenate([np.full(n, diag), np.full(n, -1.0),
                           np.full(n, -1.0)])
    a = np.zeros((n, n))
    a[rows, cols] += vals
    return formats.Coo(rows=rows, cols=cols, vals=vals, shape=(n, n)), a


@pytest.mark.parametrize("n_parts", [1, 2])
def test_partition_coo_force_halo_self_neighbor(n_parts):
    """force_halo routes periodic wrap couplings through the exchange: a
    d=0 (self-permutation) ppermute class appears, and solutions and
    iteration counts match the all-local representation exactly."""
    coo, a = _periodic_ring_coo(64)
    # p=1: only the periodic wraps are forced; p>1: wraps already cross
    # parts, so force EVERY off-diagonal to guarantee same-part (d=0)
    # forced entries alongside the genuine cross-part classes
    if n_parts == 1:
        mask = np.abs(np.asarray(coo.cols) - np.asarray(coo.rows)) > 1
    else:
        mask = np.asarray(coo.cols) != np.asarray(coo.rows)
    dm = partition_coo(coo, n_parts, force_halo=mask)
    assert 0 in dm.plan.offsets  # the self class exists
    assert all(h > 0 for h in dm.halo_sizes)
    rng = np.random.default_rng(0)
    x_true = rng.normal(size=64)
    b = a @ x_true
    mesh = _mesh(n_parts)
    sp = StoppingParams.of(StoppingConfig(
        tolerance=1e-10, rel_tol=0.0, max_iter=500, frequency=1))
    bs = jnp.asarray(split_vector(dm, b))
    xs, res = dist.dist_solve(dm, bs, jnp.zeros_like(bs), sp, mesh)
    np.testing.assert_allclose(gather_global(dm, xs), x_true, atol=1e-8)

    dm0 = partition_coo(coo, n_parts)  # wraps as local (or cross) columns
    xs0, res0 = dist.dist_solve(dm0, jnp.asarray(split_vector(dm0, b)),
                                jnp.zeros_like(bs), sp, mesh)
    it, it0 = int(np.ravel(res.iters)[0]), int(np.ravel(res0.iters)[0])
    assert abs(it - it0) <= 2, (it, it0)


def test_partition_coo_force_halo_bad_mask():
    coo, _ = _periodic_ring_coo(16)
    with pytest.raises(ValueError, match="force_halo"):
        partition_coo(coo, 2, force_halo=np.ones(3, bool))


def test_force_halo_matvec_matches_dense():
    """The forced-halo representation reproduces A @ x exactly (gather →
    self-ppermute → scatter roundtrip is value-preserving)."""
    coo, a = _periodic_ring_coo(48)
    wrap = np.abs(np.asarray(coo.cols) - np.asarray(coo.rows)) > 1
    for p in (1, 3):
        dm = partition_coo(coo, p, force_halo=wrap)
        rng = np.random.default_rng(p)
        x = rng.normal(size=48)
        xs = jnp.asarray(split_vector(dm, x))
        y = dist_matvec(dm, _mesh(p), xs)
        np.testing.assert_allclose(gather_global(dm, y), a @ x, atol=1e-12)
