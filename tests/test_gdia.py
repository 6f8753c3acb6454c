"""Gdia (generalized block-row DIA with lane gathers) — a banded
unstructured SpMV format — plus RCM renumbering."""

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu
from ogl_tpu.core.reorder import bandwidth, permute_coo, rcm_permutation
from ogl_tpu.kernels import spmv
from ogl_tpu.kernels.gdia import gdia_from_coo, spmv_gdia


def _random_sparse(rng, n=300, density=0.02):
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < density)
    a = a + a.T  # symmetric pattern for RCM
    np.fill_diagonal(a, 5.0)
    return a


def test_gdia_structured_matches_dense(rng):
    m = problems.poisson_ldu((64, 4, 2))
    coo = ldu.ldu_to_coo_host(m, dtype=np.float64)
    g = gdia_from_coo(coo)
    a = formats.to_dense(coo)
    x = rng.normal(size=m.n)
    y = spmv_gdia(g, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-12)
    # structured stencils stay cheap: few planes
    assert len(g.plane_offsets) <= 10


def test_gdia_unstructured_with_rcm(rng):
    a = _random_sparse(rng)
    coo = formats.coo_from_dense(a)
    perm = rcm_permutation(coo)
    pc = permute_coo(coo, perm)
    assert bandwidth(pc) <= bandwidth(coo)
    g = gdia_from_coo(pc, max_planes=512)
    x = rng.normal(size=a.shape[0])
    y = spmv_gdia(g, jnp.asarray(x[perm]))
    np.testing.assert_allclose(np.asarray(y), (a @ x)[perm], rtol=1e-10, atol=1e-10)


def test_gdia_plane_cap():
    rng = np.random.default_rng(0)
    # adversarial: dense random coupling -> huge bandwidth
    a = rng.normal(size=(600, 600)) * (rng.random((600, 600)) < 0.05)
    np.fill_diagonal(a, 5.0)
    coo = formats.coo_from_dense(a)
    with pytest.raises(ValueError, match="renumber"):
        gdia_from_coo(coo, max_planes=4)


def test_gdia_collision_planes(rng):
    # two entries in the same row whose sources share the block-row class
    a = np.eye(8) * 4.0
    a[0, 1] = -1.0
    a[0, 2] = -2.0  # same destination slot class q=0, two planes
    coo = formats.coo_from_dense(a)
    g = gdia_from_coo(coo)
    x = rng.normal(size=8)
    np.testing.assert_allclose(np.asarray(spmv_gdia(g, jnp.asarray(x))), a @ x, atol=1e-12)


@pytest.mark.parametrize("dims", [(64, 4, 2), (200,)])
def test_gdia_matvec_matches_dense(rng, dims):
    """The format-dispatched matvec on a Gdia container equals the dense
    operator at f32 (the dispatch the solvers capture in their loops)."""
    m = problems.poisson_ldu(dims)
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    g = gdia_from_coo(coo)
    x = rng.normal(size=m.n).astype(np.float32)
    y = np.asarray(spmv.matvec(g)(jnp.asarray(x)))
    ref = formats.to_dense(coo).astype(np.float64) @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * max(1, np.abs(ref).max()))


def test_gdia_matvec_unstructured_rcm(rng):
    a = _random_sparse(rng, n=400)
    coo = formats.coo_from_dense(a.astype(np.float32))
    perm = rcm_permutation(coo)
    pc = permute_coo(coo, perm)
    g = gdia_from_coo(pc, max_planes=512)
    x = rng.normal(size=400).astype(np.float32)
    y = np.asarray(spmv.matvec(g)(jnp.asarray(x[perm])))
    ref = (a @ x)[perm]
    np.testing.assert_allclose(y, ref, atol=1e-3 * max(1, np.abs(ref).max()))
