"""Roofline measurement harness: the numbers the benchmark publishes must
come from defensible machinery (a >100%-of-peak readout is a harness bug,
not a win), against a published peak looked up by device kind."""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels import roofline, spmv


def test_measure_chained_absolute_and_positive():
    m = problems.poisson_ldu((24, 24))
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(m, dtype=np.float32))
    mv = spmv.matvec(mat)
    r = roofline.measure_chained(
        mv, jnp.ones((m.n,), jnp.float32), iters=64,
        bytes_moved=roofline.spmv_bytes(mat),
        flops=roofline.spmv_flops(mat))
    assert r.seconds > 0 and np.isfinite(r.gbps)
    # the fixed dispatch cost is subtracted but never over-subtracted:
    # a longer chain cannot report a larger per-iteration time scale-up
    r2 = roofline.measure_chained(
        mv, jnp.ones((m.n,), jnp.float32), iters=256,
        bytes_moved=roofline.spmv_bytes(mat))
    assert r2.seconds < 20 * r.seconds  # same order of magnitude


def test_measure_chained_auto_iters():
    m = problems.poisson_ldu((16, 16))
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(m, dtype=np.float32))
    mv = spmv.matvec(mat)
    r = roofline.measure_chained(mv, jnp.ones((m.n,), jnp.float32),
                                 target_seconds=0.05,
                                 bytes_moved=roofline.spmv_bytes(mat))
    assert r.seconds > 0


def test_copy_gbps_from_device_time(monkeypatch):
    """The copy's GB/s is 2 words per element per chained step over the
    device time measure_device_chained reports."""
    seen = {}

    def fake(fn, x, iters, operands=()):
        seen["iters"], seen["n"] = iters, x.shape[0]
        np.testing.assert_array_equal(np.asarray(fn(x)), 1.0)
        return 1e-3

    monkeypatch.setattr(roofline, "measure_device_chained", fake)
    assert roofline.measure_copy_gbps(n=1 << 10, iters=7) == \
        2 * (1 << 10) * 4 / 1e-3 / 1e9
    assert seen == {"iters": 7, "n": 1 << 10}


def test_copy_gbps_needs_a_device_timeline():
    """On the CPU the trace has no accelerator plane: an error, never a
    host-clock stand-in."""
    with pytest.raises(RuntimeError, match="no accelerator plane"):
        roofline.measure_copy_gbps(n=1 << 10, iters=2)


@pytest.mark.parametrize("kind,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0)])
def test_peak_table_known_h100(kind, gbps):
    dev = types.SimpleNamespace(device_kind=kind, platform="gpu")
    assert roofline.hbm_peak_gbps(dev) == gbps
    assert roofline.HBM_PEAK[kind].source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100", ""])
def test_peak_table_unknown_kind_raises(kind):
    dev = types.SimpleNamespace(device_kind=kind, platform="gpu")
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        roofline.hbm_peak_gbps(dev)


def test_sell_bytes_tracks_buckets():
    """spmv_bytes for SELL must use the bucketed footprint, not a
    global-max-width product."""
    m = problems.poisson_ldu((20, 20))
    coo = ldu.ldu_to_coo_host(m)
    sell = formats.coo_to_sell(coo, slice_height=8)
    bytes_ = roofline.spmv_bytes(sell)
    vs = np.dtype(sell.dtype).itemsize
    assert bytes_ == sell.stored * (vs + 4) + 2 * m.n * vs
