"""Preconditioner tests: each must (a) be a reasonable approximate inverse,
(b) accelerate CG/GMRES on Poisson vs unpreconditioned, (c) keep solver
convergence intact.  Mirrors the reference's integration matrix
{none, BJ, GISAI, ILU} × solvers (test/integration.yaml:29-87), extended
with IC/ICT/ILUT/ISAI/Multigrid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import precond
from ogl_tpu import testing as problems
from ogl_tpu.config import PrecondConfig, StoppingConfig
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels import spmv
from ogl_tpu.solve import cg, gmres
from ogl_tpu.solve.krylov import single_device_ops


@pytest.fixture(scope="module")
def poisson():
    m = problems.poisson_ldu((16, 16))
    coo = ldu.ldu_to_coo(m)
    a = problems.poisson_dense((16, 16))
    rng = np.random.default_rng(7)
    x_true = rng.normal(size=m.n)
    b = jnp.asarray(a @ x_true)
    return coo, a, b, x_true


CFG = StoppingConfig(tolerance=1e-10, rel_tol=0.0, max_iter=600)

ALL_NAMES = ["BJ", "ILU", "ILUT", "IRILU", "IC", "ICT", "ISAI", "GISAI", "Multigrid"]


def _iters(coo, b, apply=None, solver=cg, **kw):
    ops = single_device_ops(spmv.matvec(coo), b.shape[0], precond=apply)
    res = solver(ops, b, jnp.zeros_like(b), CFG, **kw)
    assert bool(res.converged)
    return int(res.iters), res


@pytest.mark.parametrize("name", ALL_NAMES)
def test_precond_accelerates_cg(poisson, name):
    coo, a, b, x_true = poisson
    if name == "ILUT":
        # ILUT's filled factors make the GMRES+8-sweep-trisolve compile
        # explode on the CPU backend (~15 min); a smaller case tests the
        # same code path
        m = problems.poisson_ldu((8, 8))
        coo = ldu.ldu_to_coo(m)
        a = problems.poisson_dense((8, 8))
        rng = np.random.default_rng(7)
        x_true = rng.normal(size=m.n)
        b = jnp.asarray(a @ x_true)
    cfg = PrecondConfig(name=name, max_block_size=4, sparsity_power=2)
    apply = precond.build(cfg, coo)
    base_iters, _ = _iters(coo, b)
    solver, kw = (cg, {})
    if name in ("ILU", "ILUT", "IRILU"):  # unsymmetric M: use GMRES
        solver, kw = gmres, {"krylov_dim": 30 if name == "ILUT" else 60}
    it, res = _iters(coo, b, apply, solver=solver, **kw)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    assert it <= base_iters, f"{name}: {it} vs unpreconditioned {base_iters}"


def test_bj_scalar_is_diag_inverse(poisson):
    coo, a, b, _ = poisson
    apply = precond.build(PrecondConfig(name="BJ", max_block_size=1), coo)
    r = jnp.asarray(np.random.default_rng(0).normal(size=coo.shape[0]))
    np.testing.assert_allclose(np.asarray(apply(r)), np.asarray(r) / np.diag(a), rtol=1e-12)


def test_bj_block_exact_on_block_diagonal():
    # block-diagonal matrix: BJ with matching block size is an exact inverse
    rng = np.random.default_rng(1)
    bs, nb = 4, 6
    blocks = rng.normal(size=(nb, bs, bs)) + 5 * np.eye(bs)
    a = np.zeros((nb * bs, nb * bs))
    for i in range(nb):
        a[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = blocks[i]
    coo = formats.coo_from_dense(a)
    apply = precond.build(PrecondConfig(name="BJ", max_block_size=bs), coo)
    r = rng.normal(size=nb * bs)
    np.testing.assert_allclose(np.asarray(apply(jnp.asarray(r))), np.linalg.solve(a, r), atol=1e-10)


def test_ilu0_exact_when_no_fill():
    # tridiagonal: ILU(0) == exact LU; many sweeps converge to exact solve
    n = 32
    a = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    coo = formats.coo_from_dense(a)
    apply = precond.ilu0(coo, sweeps=n)  # enough sweeps for exact trisolve
    rng = np.random.default_rng(2)
    r = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(apply(jnp.asarray(r))), np.linalg.solve(a, r), atol=1e-8)


def test_ic0_exact_when_no_fill():
    n = 32
    a = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    coo = formats.coo_from_dense(a)
    apply = precond.ic0(coo, sweeps=n)
    rng = np.random.default_rng(2)
    r = rng.normal(size=n)
    np.testing.assert_allclose(np.asarray(apply(jnp.asarray(r))), np.linalg.solve(a, r), atol=1e-8)


def test_isai_is_approximate_inverse(poisson):
    coo, a, b, _ = poisson
    apply = precond.isai(coo, sparsity_power=1, spd=False)
    n = coo.shape[0]
    # reconstruct M columnwise; ||I - M A||_2 must be well below 1
    M = np.stack([np.asarray(apply(jnp.asarray(col))) for col in np.eye(n).T]).T
    err = np.linalg.norm(np.eye(n) - M @ a, 2)
    assert err < 1.0, err


def test_amg_hierarchy_coarsens(poisson):
    coo, _, _, _ = poisson
    from ogl_tpu.precond.amg import build_hierarchy

    lv = build_hierarchy(coo, max_levels=9, min_coarse_rows=10)
    sizes = [l.n for l in lv]
    assert sizes[0] == coo.shape[0]
    assert all(sizes[i + 1] < sizes[i] for i in range(len(sizes) - 1))
    assert sizes[-1] <= max(10, sizes[0])  # terminated by min_coarse_rows or stall
    # aggregation at least halves (pairwise matching)
    assert sizes[1] <= (2 * sizes[0]) // 3 + 1


def test_amg_cuts_iterations_dramatically():
    m = problems.poisson_ldu((32, 32))
    coo = ldu.ldu_to_coo(m)
    a = problems.poisson_dense((32, 32))
    rng = np.random.default_rng(3)
    x_true = rng.normal(size=m.n)
    b = jnp.asarray(a @ x_true)
    base, _ = _iters(coo, b)
    apply = precond.amg(coo)
    it, res = _iters(coo, b, apply)
    assert it < base / 2, (it, base)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


@pytest.mark.parametrize("cycle", ["v", "w", "f"])
def test_amg_cycles(poisson, cycle):
    coo, a, b, x_true = poisson
    apply = precond.build(PrecondConfig(name="Multigrid", cycle=cycle), coo)
    it, res = _iters(coo, b, apply)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


def test_unknown_name_raises(poisson):
    coo, *_ = poisson
    with pytest.raises(ValueError, match="Valid choices"):
        precond.build(PrecondConfig(name="FancyNew"), coo)


@pytest.mark.parametrize("aggregation", ["natural", "pgm", "auto", "grid"])
def test_amg_aggregation_modes(poisson, aggregation):
    coo, a, b, x_true = poisson
    apply = precond.amg(coo, aggregation=aggregation)
    it, res = _iters(coo, b, apply)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    base, _ = _iters(coo, b)
    assert it < base  # every aggregation must still accelerate


def test_grid_dims_recovered_from_offsets():
    """grid_dims_of recovers (nz, ny, nx) from a box-grid stencil's
    diagonal offsets and rejects non-grid offset sets."""
    from ogl_tpu.precond.amg import grid_dims_of

    assert grid_dims_of([0, 1, -1, 12, -12, 96, -96], 96 * 5) == (5, 8, 12)
    assert grid_dims_of([0, 1, -1, 16, -16], 16 * 9) == (1, 9, 16)
    assert grid_dims_of([0, 1, -1], 37) == (1, 1, 37)
    # asymmetric offsets / missing unit stride / non-factoring n -> None
    assert grid_dims_of([0, 1, -1, 12], 60) is None
    assert grid_dims_of([0, 2, -2], 10) is None
    assert grid_dims_of([0, 1, -1, 12, -12], 61) is None
    assert grid_dims_of([0], 8) is None


def test_grid_aggregate_blocks():
    """2x-per-axis block aggregation: every aggregate is a geometric
    block, ids are a valid partition, odd axes get ceil'd coarse dims."""
    from ogl_tpu.precond.amg import grid_aggregate

    agg, (nzc, nyc, nxc) = grid_aggregate((1, 4, 6))
    assert (nzc, nyc, nxc) == (1, 2, 3)
    assert agg.shape == (24,) and agg.min() == 0 and agg.max() == 5
    # cell (iy, ix) -> aggregate (iy//2)*nxc + ix//2
    iy, ix = np.divmod(np.arange(24), 6)
    np.testing.assert_array_equal(agg, (iy // 2) * 3 + ix // 2)
    # odd axis: trailing partial block folds into the last coarse cell
    agg5, (_, _, nxc5) = grid_aggregate((1, 1, 5))
    assert nxc5 == 3
    np.testing.assert_array_equal(agg5, [0, 0, 1, 1, 2])


def test_grid_transfers_are_transposes():
    """_restrict is the exact transpose of _prolong for grid levels
    (piecewise-constant P: restrict = block-sum, prolong = injection)."""
    from ogl_tpu.precond.amg import _Level, _restrict, _prolong, grid_aggregate

    dims = (3, 4, 5)
    agg, cdims = grid_aggregate(dims)
    n = int(np.prod(dims))
    nc = int(np.prod(cdims))
    lv = _Level(mat=None, inv_diag=None, agg=None, n=n, nc=nc,
                grid=tuple(dims) + tuple(cdims))
    rng = np.random.default_rng(0)
    u = rng.normal(size=n)
    v = rng.normal(size=nc)
    lhs = float(np.dot(np.asarray(_restrict(lv, jnp.asarray(u))), v))
    rhs = float(np.dot(u, np.asarray(_prolong(lv, jnp.asarray(v)))))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    # restrict really is the one-hot block sum
    r = np.zeros(nc)
    np.add.at(r, agg, u)
    np.testing.assert_allclose(np.asarray(_restrict(lv, jnp.asarray(u))), r,
                               rtol=1e-6)


def test_grid_amg_beats_natural_and_scales():
    """Geometric 2x-per-axis coarsening must (a) converge in fewer CG
    iterations than 1-D natural aggregation and (b) be near
    grid-independent (iters grow slowly with size) — the property 1-D
    natural aggregation lacks (96 iterations at 8.4M)."""
    iters = {}
    for dims in [(16, 16), (32, 32)]:
        m = problems.poisson_ldu(dims)
        coo = ldu.ldu_to_coo(m)
        rng = np.random.default_rng(5)
        x_true = rng.normal(size=m.n)
        import scipy.sparse as sp
        A = sp.csr_matrix((np.asarray(coo.vals),
                           (np.asarray(coo.rows), np.asarray(coo.cols))),
                          shape=coo.shape)
        b = jnp.asarray(A @ x_true)
        it_g, res = _iters(coo, b, precond.amg(coo, aggregation="grid"))
        it_n, _ = _iters(coo, b, precond.amg(coo, aggregation="natural"))
        np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
        assert it_g <= it_n, (dims, it_g, it_n)
        iters[dims] = it_g
    # grid-independence: doubling each axis adds at most a few iterations
    assert iters[(32, 32)] <= iters[(16, 16)] + 5, iters


def test_amg_cycle_f32_tracks_f64(poisson):
    """One AMG cycle applied in f32 agrees with the same cycle in f64 to
    f32 rounding: the dense coarse solve and the smoothers run at full
    f32 precision (no reduced-precision matmul)."""
    coo, a, b, x_true = poisson
    op64 = precond.amg(coo, width=4)
    coo32 = formats.Coo(rows=coo.rows, cols=coo.cols,
                        vals=jnp.asarray(np.asarray(coo.vals), jnp.float32),
                        shape=coo.shape)
    op32 = precond.amg(coo32, width=4)
    r = np.asarray(b, np.float64)
    z64 = np.asarray(op64(jnp.asarray(r)))
    z32 = np.asarray(op32(jnp.asarray(r, jnp.float32)))
    assert z32.dtype == np.float32
    np.testing.assert_allclose(z32, z64, rtol=1e-4,
                               atol=1e-4 * np.abs(z64).max())


def test_amg_coarse_direct_vs_cg(poisson):
    """Dense-inverse coarse solve converges at least as fast as coarse CG."""
    coo, a, b, x_true = poisson
    it_d, res_d = _iters(coo, b, precond.amg(coo, coarse_solver="direct"))
    it_c, res_c = _iters(coo, b, precond.amg(coo, coarse_solver="cg"))
    assert it_d <= it_c + 1, (it_d, it_c)
    np.testing.assert_allclose(np.asarray(res_d.x), x_true, atol=1e-6)


@pytest.mark.parametrize("width", [2, 4, 8])
def test_amg_coarsening_widths(poisson, width):
    coo, a, b, x_true = poisson
    apply = precond.amg(coo, width=width)
    it, res = _iters(coo, b, apply)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    base, _ = _iters(coo, b)
    assert it < base


def test_ilu_sums_duplicate_entries():
    """Duplicate (row,col) COO entries (a face plus a cyclic coupling of
    the same cell pair) must be SUMMED before factorisation — the kernels'
    scatter would otherwise silently factor the wrong matrix."""
    import jax.numpy as jnp

    from ogl_tpu.core.formats import Coo
    from ogl_tpu.precond.ilu import ilu0_factors

    # A = [[4,-2],[-2,4]] expressed with the off-diagonals duplicated
    rows = np.array([0, 0, 0, 1, 1, 1], np.int32)
    cols = np.array([0, 1, 1, 0, 0, 1], np.int32)
    vals = np.array([4.0, -1.0, -1.0, -1.0, -1.0, 4.0])
    coo = Coo(rows=rows, cols=cols, vals=vals, shape=(2, 2))
    (lr, lc, lv), (ur, uc, uv), ud = ilu0_factors(coo)
    np.testing.assert_allclose(ud, [4.0, 4.0 - (-2.0) * (-2.0 / 4.0)])
    np.testing.assert_allclose(lv, [-0.5])  # -2/4, not -1/4


def test_skip_sorting_false_sorts_input():
    """skipSorting false defensively sorts the factorisation input (the
    Ginkgo with_skip_sorting(false) semantic, Preconditioner.H:88-112);
    a shuffled COO must then produce bit-identical factors to sorted
    input."""
    import jax

    from ogl_tpu import testing as problems
    from ogl_tpu.config import PrecondConfig
    from ogl_tpu.core import ldu
    from ogl_tpu.core.formats import Coo
    from ogl_tpu import precond as precond_mod

    coo = ldu.ldu_to_coo_host(problems.poisson_ldu((8, 8)))
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(np.asarray(coo.rows)))
    shuffled = Coo(rows=np.asarray(coo.rows)[perm],
                   cols=np.asarray(coo.cols)[perm],
                   vals=np.asarray(coo.vals)[perm], shape=coo.shape)
    for name in ("ILU", "IC", "GISAI"):
        ref = precond_mod.build(PrecondConfig(name=name), coo)
        got = precond_mod.build(
            PrecondConfig(name=name, skip_sorting=False), shuffled)
        for a, b in zip(jax.tree_util.tree_leaves(ref.state),
                        jax.tree_util.tree_leaves(got.state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ALL_NAMES)
def test_precond_bf16_state(poisson, name):
    """`precision bfloat16`: every floating state leaf narrows, the solve
    still converges to the (full-precision) tolerance, and the iteration
    count stays close to the f32 preconditioner's."""
    coo, a, b, x_true = poisson
    coof = formats.Coo(rows=coo.rows, cols=coo.cols,
                       vals=jnp.asarray(coo.vals, jnp.float32), shape=coo.shape)
    bf = jnp.asarray(b, jnp.float32)
    base, _ = _iters(coof, bf, precond.build(PrecondConfig(name=name), coof))
    op = precond.build(PrecondConfig(name=name, value_precision="bfloat16"), coof)
    fl = [l for l in jax.tree_util.tree_leaves(op.state)
          if jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating)]
    assert fl and all(l.dtype == jnp.bfloat16 for l in fl)
    it, res = _iters(coof, bf, op)
    # a preconditioner only steers the iteration: convergence is checked
    # against the full-precision residual, so accuracy is unchanged and
    # the rounding costs at most a few extra iterations
    assert it <= int(base * 1.5) + 8
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=5e-3)
