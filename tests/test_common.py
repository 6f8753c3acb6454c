"""Utility-layer tests: logging/timing (reference common/common.H), the
registry property store (common.C:75-146), roofline bookkeeping, and
MatrixMarket symmetric input."""

import numpy as np

from ogl_tpu import common, registry
from ogl_tpu.core import formats, mtx


def test_log_levels(capsys):
    common.log(0, 0, "hidden")
    common.log(1, 0, "shown")
    common.log(2, 1, "also shown")
    out = capsys.readouterr().out
    assert "hidden" not in out
    assert "shown" in out and "also shown" in out


def test_timed_sink_and_print(capsys):
    sink = common.Timings()
    with common.timed("phase", verbose=1, field="p", sink=sink):
        pass
    assert "phase" in sink and sink["phase"] >= 0.0
    out = capsys.readouterr().out
    assert "p: phase:" in out and "[ms]" in out


def test_registry_properties_persist():
    r = registry.Registry()
    p = r.properties("p")
    p.prev_solve_iters = 42
    p.precond_caching_left = 3
    assert r.properties("p").prev_solve_iters == 42
    assert r.properties("u").prev_solve_iters == 0  # independent fields
    r.put("k", 1)
    assert "k" in r and r.pop("k") == 1 and r.get("k") is None
    r.clear()
    assert r.properties("p").prev_solve_iters == 0


def test_roofline_fraction():
    from ogl_tpu.kernels.roofline import Roofline

    r = Roofline(seconds=1e-4, bytes=335_000_000, flops=0)
    assert abs(r.gbps - 3350.0) < 1e-6
    assert abs(r.fraction_of(3350.0) - 1.0) < 1e-9


def test_mtx_symmetric_read(tmp_path):
    p = str(tmp_path / "s.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("3 3 4\n1 1 2.0\n2 2 2.0\n3 3 2.0\n2 1 -1.0\n")
    a = formats.to_dense(mtx.read(p))
    exp = np.array([[2, -1, 0], [-1, 2, 0], [0, 0, 2.0]])
    np.testing.assert_allclose(a, exp)


def test_bench_poisson_dia_matches_conversion():
    """bench._poisson_dia (analytic construction for the roofline problem)
    must equal the framework conversion path exactly."""
    import sys

    sys.path.insert(0, ".")
    import numpy as np

    from bench import _poisson_dia
    from ogl_tpu import testing as problems
    from ogl_tpu.core import formats, ldu

    for dims in ((5, 4, 3), (8, 1, 1), (6, 5, 1)):
        ref = formats.coo_to_dia(
            ldu.ldu_to_coo_host(problems.poisson_ldu(dims), dtype=np.float32))
        got = _poisson_dia(dims)
        assert got.offsets == ref.offsets
        np.testing.assert_array_equal(np.asarray(got.data),
                                      np.asarray(ref.data))
