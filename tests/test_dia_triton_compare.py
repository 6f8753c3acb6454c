"""scripts/dia_triton_compare.py on the CPU: its Pallas-Triton Dia SpMV in
interpret mode against `spmv_dia`, and the routing of GKOCG-Dia through
it."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu.core import formats
from ogl_tpu.kernels import spmv

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "dia_triton_compare.py")


@pytest.fixture(scope="module")
def dtc():
    spec = importlib.util.spec_from_file_location("dia_triton_compare",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dims,block", [((12, 10, 8), 64),
                                        ((12, 10, 8), 256),
                                        ((7, 5, 3), 32),
                                        ((33,), 16)])
def test_kernel_matches_spmv_dia(dtc, dims, block):
    """Every row block, including a last one cut by the edge, and the
    masked shifts at both ends of x."""
    mat = dtc.dia_of(dims)
    x = jnp.asarray(np.random.default_rng(0).normal(size=mat.shape[0])
                    .astype(np.float32))
    y = dtc.dia_spmv_triton(mat, x, block, interpret=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(spmv.spmv_dia(mat, x)),
                               rtol=1e-6, atol=1e-6)


def test_dia_route_restores_dispatch(dtc):
    before = spmv._DISPATCH[formats.Dia]
    with pytest.raises(RuntimeError):
        with dtc.dia_route(lambda m, x: x):
            assert spmv._DISPATCH[formats.Dia] is not before
            raise RuntimeError
    assert spmv._DISPATCH[formats.Dia] is before


def test_gkocg_routes_through_the_kernel(dtc):
    iters = dtc.end_to_end((10, 8, 6), 64, executor="cpu", interpret=True,
                           timed=False)
    assert iters["XLA"] == iters["Triton"] > 0
