"""uploadPrecision bfloat16: error-feedback bf16
delta encoding of the steady-state coefficient/RHS uploads.

The mirror advances by exactly the quantised delta the device adds, so
host and device stay bit-identical and error does not accumulate; blocks
whose residual error would exceed uploadDeltaTol fall back to full-width
f32 (automatic refresh).  No reference analogue — HostMatrix.C:684-692
re-copies everything full-width every step."""

import dataclasses

import numpy as np
import pytest

from ogl_tpu import foam, registry
from ogl_tpu import testing as problems
from ogl_tpu.core import ldu


@pytest.fixture(autouse=True)
def _clear():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


BASE = {"solver": "GKOCG", "tolerance": 1e-7, "relTol": 0.0,
        "maxIter": 3000, "uploadPrecision": "bfloat16"}


def _case(dims=(12, 10, 6), seed=0):
    m = problems.poisson_ldu(dims)
    rng = np.random.default_rng(seed)
    b = rng.normal(size=m.n).astype(np.float32)
    return m, b


def _step(m, i, rel=1e-6):
    """A transient-CFD-like coefficient nudge: small relative change."""
    f = 1.0 + rel * (i + 1)
    return dataclasses.replace(m, diag=m.diag * f, upper=m.upper * f)


def test_bf16_delta_engages_and_stays_accurate():
    m, b = _case()
    slv = foam.FoamSolver("c", BASE)
    slv.solve(m, b)
    slv.solve(_step(m, 99), b)  # first steady step stages full-width
    for i in range(6):
        m2 = _step(m, i)
        x, perf = slv.solve(m2, b)
        assert perf.converged
        bf, nb = slv.last_blocks_bf16
        up, _ = slv.last_blocks_uploaded
        if i == 0:
            # the jump back from the i=99 state is a ~1e-4 relative delta:
            # larger than the tolerance-tied bf16 error bound
            # (min(uploadDeltaTol, tolerance/10) — advisor r04), so it must
            # refresh FULL-WIDTH; the small steady deltas after it ride bf16
            assert bf == 0 and up > 0, \
                f"step 0: large delta should refresh full-width ({bf}/{up})"
            continue
        assert bf == up > 0, f"step {i}: bf16 deltas not used ({bf}/{up})"
        # device operator tracks the exact coefficients within the tol:
        # solution checks against the TRUE (un-quantised) system
        coo = ldu.ldu_to_coo_host(m2, dtype=np.float64)
        import scipy.sparse as sp

        a64 = sp.csr_matrix((np.asarray(coo.vals),
                             (np.asarray(coo.rows), np.asarray(coo.cols))),
                            shape=coo.shape)
        res = np.abs(b - a64 @ np.asarray(x, np.float64)).sum() / np.abs(b).sum()
        assert res < 1e-5, f"step {i}: residual vs exact operator {res:.2e}"


def test_upload_bytes_halved():
    m, b = _case(seed=1)
    slv = foam.FoamSolver("c", BASE)
    slv32 = foam.FoamSolver("c32", {k: v for k, v in BASE.items()
                                    if k != "uploadPrecision"})
    slv.solve(m, b)
    slv32.solve(m, b)
    slv.solve(_step(m, 0), b)   # stages the device blocks (full-width)
    slv32.solve(_step(m, 0), b)
    slv.solve(_step(m, 1), b)   # now the deltas ride bf16
    slv32.solve(_step(m, 1), b)
    assert slv.last_upload_bytes * 2 == slv32.last_upload_bytes


def test_large_change_full_refresh():
    """A change too big for the tolerance must fall back to f32 upload."""
    m, b = _case(seed=2)
    slv = foam.FoamSolver("c", BASE)
    slv.solve(m, b)
    m2 = dataclasses.replace(m, diag=m.diag * 2.0)  # 100% change
    x, perf = slv.solve(m2, b)
    bf, _ = slv.last_blocks_bf16
    assert bf == 0, "bf16 delta accepted a change beyond uploadDeltaTol"
    assert perf.converged


def test_no_drift_over_many_steps():
    """Error feedback: 40 steps of bf16 deltas, then compare the DEVICE
    coefficient values bitwise against the host mirror and within tol of
    the exact values."""
    m, b = _case(seed=3)
    slv = foam.FoamSolver("c", BASE)
    slv.solve(m, b)
    m2 = m
    for i in range(40):
        m2 = _step(m, i, rel=3e-7)
        slv.solve(m2, b)
    # the mirror IS the device state (bit-exact by construction)
    for mir, dev in zip(slv._blocks_mirror, slv._blocks_dev):
        np.testing.assert_array_equal(mir, np.asarray(dev))
    # match exact blocks by shape (block order is an ldu._host_blocks detail)
    exact = [np.asarray(m2.diag, np.float32), np.asarray(m2.upper, np.float32)]
    for ex in exact:
        mir = next(mm for mm in slv._blocks_mirror if mm.shape == ex.shape)
        rel = np.max(np.abs(mir - ex)) / np.max(np.abs(ex))
        assert rel <= 1.1e-5, f"accumulated drift {rel:.2e}"


def test_rhs_bf16_path():
    m, b = _case(seed=4)
    slv = foam.FoamSolver("c", BASE)
    slv.solve(m, b)
    # small RHS change -> bf16 delta
    x, perf = slv.solve(m, b * (1.0 + np.float32(1e-6)))
    assert slv.last_rhs_uploaded and slv.last_rhs_bf16
    assert perf.converged
    # a large NON-bf16-representable change -> full-width refresh (note
    # b + 1.0 would be accepted: 1.0 is bf16-exact, so the delta encodes
    # losslessly — the guard is about residual ERROR, not delta size)
    b2 = np.random.default_rng(6).normal(size=m.n).astype(np.float32) * 5
    slv.solve(m, b2)
    assert slv.last_rhs_uploaded and not slv.last_rhs_bf16


def test_f64_route_unaffected():
    """uploadPrecision only applies to f32 containers; the x64 (f64) path
    must ignore it rather than corrupt double coefficients."""
    m, b = _case(seed=5)
    slv = foam.FoamSolver("c64", {**BASE, "dtype": "float64"})
    slv.solve(m, b)
    _, perf = slv.solve(_step(m, 0), b)
    bf, _ = slv.last_blocks_bf16
    assert bf == 0
    assert perf.converged


def test_explicit_tol_honored_from_dataclass():
    """Regression (round-5 review): explicitness lives in the VALUE
    (upload_delta_tol None = default-and-capped), so a SolverConfig built
    directly — or via dataclasses.replace — with a loose explicit
    tolerance is honored, not silently tightened to tolerance/10."""
    from ogl_tpu.config import parse_controls

    m, b = _case(seed=7)
    cfg = dataclasses.replace(parse_controls(BASE), upload_delta_tol=5e-2)
    slv = foam.FoamSolver("cx", cfg)
    slv.solve(m, b)
    slv.solve(_step(m, 0), b)            # stage blocks full-width
    m2 = dataclasses.replace(m, diag=m.diag * np.float32(1.001),
                             upper=m.upper * np.float32(1.001))
    slv.solve(m2, b)                     # 1e-3 delta: > tolerance/10 cap,
    bf, up = slv.last_blocks_bf16        # < the explicit 5e-2 -> bf16 rides
    assert bf == up > 0, f"explicit loose uploadDeltaTol ignored ({bf}/{up})"

    # and the dict key still counts as explicit (parse path)
    registry.global_registry.clear()
    slv2 = foam.FoamSolver("cy", {**BASE, "uploadDeltaTol": 5e-2})
    slv2.solve(m, b)
    slv2.solve(_step(m, 0), b)
    slv2.solve(m2, b)
    bf2, up2 = slv2.last_blocks_bf16
    assert bf2 == up2 > 0
