"""chip_smoke.py: its phase functions at tiny sizes on the CPU, its
refusal to run without a GPU, and (marked `chip`) a solve on the card."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ogl_tpu import foam
from ogl_tpu import testing as problems

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cs():
    return _load()


def _env_without_platform():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_script_fails_without_gpu(where, tmp_path):
    """On a host without a GPU (and with only the script, no package) the
    script exits non-zero and prints no result line."""
    script = SCRIPT
    cwd = REPO
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
        cwd = str(tmp_path)
        env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_openfoam_residual_matches_solver(cs):
    m = problems.poisson_ldu((16, 12))
    csr = cs.csr_of(m)
    b = csr @ np.random.default_rng(0).normal(size=m.n)
    x, perf = foam.solve("p", m, b, {"executor": "reference",
                                     "dtype": "float64", "tolerance": 1e-9,
                                     "relTol": 0})
    np.testing.assert_allclose(cs.openfoam_residual(csr, np.asarray(x), b),
                               perf.final_residual, rtol=1e-6)


def test_check_solution_rejects_a_wrong_answer(cs):
    m = problems.poisson_ldu((16, 12))
    csr = cs.csr_of(m)
    x_true = np.random.default_rng(1).normal(size=m.n)
    b = csr @ x_true
    cs.check_solution("exact", csr, b, x_true, x_true)
    with pytest.raises(AssertionError, match="true residual"):
        cs.check_solution("wrong", csr, b, x_true * 1.01, x_true)
    # an answer that meets the residual bound but disagrees with the
    # reference beyond REL_ERR (here: a reference that went wrong)
    with pytest.raises(AssertionError, match="rel error"):
        cs.check_solution("wrong reference", csr, b, x_true,
                          x_true * (1 + 2 * cs.REL_ERR))


@pytest.mark.parametrize("tag,extra", [
    ("Coo", {}),
    ("Dia+BJ", {"matrixFormat": "Dia", "preconditioner": "BJ"}),
])
def test_main_path_phase_tiny(cs, tag, extra):
    slv, recs = cs.run_main_path(tag, (12, 10, 8), extra, steps=2,
                                 executor="cpu")
    assert len(recs) == 3
    assert all(r["iters"] == r["cpu_iters"] for r in recs)
    assert all(r["res"] < cs.RES_FACTOR * cs.TOL for r in recs)
    assert slv.matrix.__class__.__name__ == extra.get("matrixFormat", "Coo")


def test_matrix_phase_tiny(cs):
    res = cs.run_matrix((12, 12, 6), executor="cpu")
    assert len(res) == len(cs.MATRIX_CASES) + 1
    assert all(err < cs.MATRIX_ERR for _, err in res.values())


def test_spmv_phases_tiny(cs, monkeypatch):
    """The SpMV phase's checks and bookkeeping; the CPU has no device
    timeline, so the host clock stands in for it here."""
    from ogl_tpu.kernels import roofline

    monkeypatch.setattr(cs, "device_seconds", lambda fn, x, iters, ops:
                        roofline.measure_chained(fn, x, iters=10,
                                                 operands=ops).seconds)
    fmts = cs.spmv_formats((10, 8, 6))
    assert set(fmts) == {"Coo", "Csr", "Ell", "Sell", "Dia"}
    assert cs.dia_kernel_decision((10, 8, 6), 3350.0, 1000.0) > 0


def test_multichip_phase_tiny(cs, capsys):
    rows = list(cs.run_multichip((16, 16, 8), 4, executor="cpu"))
    assert len(rows) == 4
    assert {(r[0], r[1]) for r in rows} == {
        (s, d) for s in ("GKOCG", "pipelinedCG") for d in ("simple", "scotch")}
    assert all(abs(r[3] - r[4]) <= 2 for r in rows)


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    """Skip unless this host has an NVIDIA GPU (decided here, never while
    the module is imported).  The test process itself stays on the CPU,
    so a child process can take the card."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this host (nvidia-smi not found)")
    p = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    if p.returncode != 0 or "GPU" not in p.stdout:
        pytest.skip("no NVIDIA GPU on this host")


@pytest.mark.chip
def test_gkocg_on_the_card(card):
    code = (
        "import numpy as np, jax\n"
        "from ogl_tpu import foam, testing\n"
        "m = testing.poisson_ldu((32, 32, 16))\n"
        "x, p = foam.solve('p', m, np.ones(m.n), {'executor': 'cuda',"
        " 'matrixFormat': 'Dia', 'tolerance': 1e-6, 'relTol': 0})\n"
        "assert p.converged, p\n"
        "assert {d.platform for d in x.devices()} == {'gpu'}\n"
        "print('OK', p.n_iterations)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_env_without_platform(), capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0 and "OK" in p.stdout, p.stderr[-3000:]
