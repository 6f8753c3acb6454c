"""Affine (separable) halo fast path (dist.affine): run detection, the
slice/matmul exchange + apply, and bit-level equivalence against the
generic gather route.  The structured halo sets of slab/cyclic
decompositions are lifted into slices and lane one-hot matmuls, which must
select values exactly (HIGHEST precision)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ogl_tpu import testing as problems
from ogl_tpu.config import StoppingConfig
from ogl_tpu.core import ldu
from ogl_tpu.dist import affine
from ogl_tpu.dist.from_ranks import dist_from_ldu_ranks
from ogl_tpu.dist.partition import gather_global, split_vector
from ogl_tpu.solve.stopping import StoppingParams


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def _strip_affine(dm):
    """The same DistMatrix forced onto the generic gather route."""
    plan = dataclasses.replace(dm.plan, send_affine=None, recv_affine=None)
    return dataclasses.replace(dm, plan=plan, apply_affine=None)


def test_detect_runs():
    meta, starts, lanes = affine.detect_runs(
        [np.concatenate([np.arange(0, 1024, 128),      # stride-128 lane 0
                         np.arange(256, 512)])])       # aligned slab
    assert meta == ((128, 8), (1, 256))
    assert starts.tolist() == [[0, 256]]
    # misaligned slab -> None (frame indices)
    assert affine.detect_runs([np.arange(5, 37)]) is None
    # ... but fine for flat-buffer indices
    assert affine.detect_runs([np.arange(5, 37)], frame_aligned=False) is not None
    # parts with different structure -> None
    assert affine.detect_runs([np.arange(0, 256),
                               np.arange(0, 1024, 128)]) is None


@pytest.mark.parametrize("n_parts", [1, 2])
def test_affine_matvec_matches_generic(n_parts):
    """Channel cyclic-via-halo: the affine route and the generic gather
    route produce the SAME distributed matvec (f64: exact)."""
    m = problems.channel_ldu((128, 4, 2))
    parts = ldu.decompose(m, n_parts, cyclic_via_halo=True)
    dm = dist_from_ldu_ranks(parts, dtype=np.float64)
    assert dm.plan.send_affine is not None and dm.apply_affine is not None
    dm0 = _strip_affine(dm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=m.n)
    mesh = _mesh(n_parts)

    def run(d):
        def body(local, halo, xv):
            from ogl_tpu.dist.solve import dist_ops, shard_local_matrix

            lm = shard_local_matrix(local, d.n_local)
            ops = dist_ops(lm, (halo.rows[0], halo.cols[0], halo.vals[0]),
                           d.plan, d.global_n, "x",
                           apply_affine=d.apply_affine,
                           e_true=d.halo_sizes[0] if d.halo_sizes else 0)
            return ops.matvec(xv[0])[None]

        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),) * 3,
                                  out_specs=P("x"), check_vma=False))
        xs = jnp.asarray(split_vector(d, x))
        return gather_global(d, f(d.local, d.halo, xs))

    ya, yg = run(dm), run(dm0)
    np.testing.assert_allclose(ya, yg, atol=0, rtol=0)
    a = problems.to_dense_ldu(m)
    np.testing.assert_allclose(ya, a @ x, atol=1e-10)


@pytest.mark.parametrize("solver", ["GKOCG", "GKOPipeCG"])
def test_affine_dist_cg_matches_generic(solver):
    """Jacobi-preconditioned dist-CG (classical and single-reduction)
    through the affine halo route reaches the same iteration count and
    solution as the generic gather route, in f32."""
    from ogl_tpu import dist

    m = problems.channel_ldu((128, 4, 2))
    a = problems.to_dense_ldu(m)
    rng = np.random.default_rng(1)
    x_true = rng.normal(size=m.n)
    b = (a @ x_true).astype(np.float32)
    parts = ldu.decompose(m, 1, cyclic_via_halo=True)
    dm = dist_from_ldu_ranks(parts, dtype=np.float32)
    assert dm.plan.send_affine is not None and dm.apply_affine is not None
    mesh = _mesh(1)
    sp = StoppingParams.of(StoppingConfig(
        tolerance=1e-5, rel_tol=0.0, max_iter=800, frequency=1))

    out = {}
    for tag, d in (("affine", dm), ("generic", _strip_affine(dm))):
        bs = jnp.asarray(split_vector(d, b), jnp.float32)
        xs, res = dist.dist_solve(
            d, bs, jnp.zeros_like(bs), sp, mesh, solver=solver,
            precond_builder=dist.schwarz_jacobi_builder)
        assert bool(np.ravel(res.converged)[0])
        # the anisotropic periodic channel is ill-conditioned: f32 CG at
        # tol 1e-5 leaves an O(0.1) solution error on BOTH routes — the
        # assertion that matters is route PARITY, checked below
        err = np.abs(gather_global(d, xs) - x_true).max()
        assert err < 0.5, (tag, err)
        out[tag] = (int(np.ravel(res.iters)[0]),
                    np.asarray(gather_global(d, xs)))
    assert out["affine"][0] == out["generic"][0], (
        out["affine"][0], out["generic"][0])
    np.testing.assert_allclose(out["affine"][1], out["generic"][1],
                               atol=1e-4)


def test_affine_dist_solve_end_to_end():
    """Whole-stack: foam.solve_distributed on a cyclic-via-halo channel
    takes the affine route (plan annotated) and matches the dense truth;
    a steady-state coefficient update keeps using it."""
    from ogl_tpu import foam, registry

    m = problems.channel_ldu((128, 4, 2))
    a = problems.to_dense_ldu(m)
    rng = np.random.default_rng(2)
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    controls = {"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
                "maxIter": 1200, "dtype": "float64", "cyclicViaHalo": True}
    x, perf = foam.solve_distributed("paff", m, b, controls, mesh=_mesh(2))
    slv = registry.global_registry.get_or_init("paff_dist_solver",
                                               lambda: None)
    assert slv.assembler.dm.plan.send_affine is not None
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.5)
    b2 = problems.to_dense_ldu(m2) @ x_true
    x2, p2 = foam.solve_distributed("paff", m2, b2, {})
    assert p2.converged
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)
