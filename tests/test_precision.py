"""Every float32 contraction on the solve path carries an explicit
`Precision.HIGHEST`: on a GPU an f32 dot_general may otherwise run in
TF32 (~10 mantissa bits), which would, e.g., round the halo values the
affine route selects with one-hot matmuls.  Checked on the jaxpr, so it
holds whatever device the tests run on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ogl_tpu import precond
from ogl_tpu import testing as problems
from ogl_tpu.config import PrecondConfig, StoppingConfig
from ogl_tpu.core import formats, ldu
from ogl_tpu.dist import dist_from_ldu_ranks
from ogl_tpu.dist.partition import split_vector
from ogl_tpu.kernels import spmv
from ogl_tpu.solve import gmres
from ogl_tpu.solve.krylov import single_device_ops
from ogl_tpu.solve.stopping import StoppingParams

HIGHEST = jax.lax.Precision.HIGHEST


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]


def _assert_all_highest(fn, *args, expect_min=1):
    precs = _dot_precisions(fn, *args)
    assert len(precs) >= expect_min, precs
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), precs


def _poisson_coo(dims, dtype=np.float32):
    return ldu.ldu_to_coo_host(problems.poisson_ldu(dims), dtype=dtype)


def test_block_jacobi_apply_highest():
    op = precond.block_jacobi(_poisson_coo((16, 8)), block_size=4)
    r = jnp.ones(128, jnp.float32)
    _assert_all_highest(op, r)


def test_amg_dense_coarse_solve_highest():
    coo = _poisson_coo((16, 16))
    op = precond.amg(coo, coarse_solver="direct")
    _assert_all_highest(op, jnp.ones(256, jnp.float32))


def test_gmres_basis_ops_highest():
    coo = _poisson_coo((16, 8))
    mat = formats.coo_to_dia(coo)
    ops = single_device_ops(spmv.matvec(mat), 128)
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-6, rel_tol=0.0,
                                          max_iter=50))
    b = jnp.ones(128, jnp.float32)
    _assert_all_highest(
        lambda bb: gmres(ops, bb, jnp.zeros_like(bb), sp, krylov_dim=8).x, b,
        expect_min=2)


def _dist_fn(dm, n_parts, **kw):
    from ogl_tpu.dist.solve import make_dist_solve_fn

    mesh = Mesh(np.array(jax.devices()[:n_parts]), ("x",))
    fn = make_dist_solve_fn(dm, mesh, **kw)
    sp = StoppingParams.of(StoppingConfig(tolerance=1e-6, rel_tol=0.0,
                                          max_iter=20))
    bs = jnp.ones((n_parts, dm.n_local), jnp.float32)
    return fn, (dm.local, dm.halo, bs, jnp.zeros_like(bs), sp)


def test_affine_halo_route_highest():
    m = problems.channel_ldu((128, 4, 2))
    dm = dist_from_ldu_ranks(ldu.decompose(m, 1, cyclic_via_halo=True),
                             dtype=np.float32)
    assert dm.plan.send_affine is not None and dm.apply_affine is not None
    fn, args = _dist_fn(dm, 1)
    # the lane one-hot selections of the send and of the apply
    _assert_all_highest(lambda *a: fn(*a)[0], *args, expect_min=2)


def test_dist_block_jacobi_builder_highest():
    from ogl_tpu.dist.solve import schwarz_block_jacobi_builder

    dm = dist_from_ldu_ranks(ldu.decompose(problems.poisson_ldu((16, 8)), 2),
                             dtype=np.float32)
    fn, args = _dist_fn(dm, 2, precond_builder=schwarz_block_jacobi_builder(4))
    _assert_all_highest(lambda *a: fn(*a)[0], *args)


@pytest.mark.parametrize("name,extra", [
    ("BJ", {"max_block_size": 4}),
    ("Multigrid", {}),
])
def test_dist_schwarz_state_apply_highest(name, extra):
    from ogl_tpu.dist.precond import build_schwarz

    dm = dist_from_ldu_ranks(ldu.decompose(problems.poisson_ldu((16, 16)), 2),
                             dtype=np.float32)
    shards = []
    for part in ldu.decompose(problems.poisson_ldu((16, 16)), 2):
        c = ldu.ldu_to_coo_host(part, dtype=np.float32)
        shards.append((np.asarray(c.rows), np.asarray(c.cols),
                       np.asarray(c.vals)))
    apply, state = build_schwarz(PrecondConfig(name=name, **extra), shards,
                                 dm.n_local, np.float32)
    one = jax.tree.map(lambda a: a[0], state)
    _assert_all_highest(apply, one, jnp.ones(dm.n_local, jnp.float32))


def test_affine_selection_is_exact_in_f32():
    """The affine route reproduces the generic gather route bit for bit in
    float32 (a reduced-precision one-hot product would not)."""
    from ogl_tpu.dist.partition import gather_global

    m = problems.channel_ldu((128, 4, 2))
    parts = ldu.decompose(m, 1, cyclic_via_halo=True)
    dm = dist_from_ldu_ranks(parts, dtype=np.float32)
    x = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    outs = []
    for d in (dm, dm.__class__(**{**dm.__dict__, "apply_affine": None,
                                  "plan": dm.plan.__class__(
                                      **{**dm.plan.__dict__,
                                         "send_affine": None})})):
        fn, args = _dist_fn(d, 1)
        bs = jnp.asarray(split_vector(d, x))
        sp = StoppingParams.of(StoppingConfig(tolerance=0.0, rel_tol=0.0,
                                              min_iter=5, max_iter=5))
        xs, _ = fn(d.local, d.halo, bs, jnp.zeros_like(bs), sp)
        outs.append(gather_global(d, xs))
    np.testing.assert_array_equal(outs[0], outs[1])
