"""Device choice, compile-cache placement and the controls that went with
the removed merged kernels.

The `executor` key maps to a device explicitly: `cuda` is the GPU and
raises where JAX has none (never a silent CPU fallback), `tpu` raises and
names `cuda`, `reference`/`omp`/`cpu` are the CPU, and no key means JAX's
default device (JAX_PLATFORMS puts these tests on the CPU)."""

import os

import jax
import numpy as np
import pytest

from ogl_tpu import common, foam
from ogl_tpu import testing as problems
from ogl_tpu.config import parse_controls
from ogl_tpu.foam.solver import FoamSolver, _device_for


@pytest.mark.parametrize("executor", ["reference", "omp", "cpu"])
def test_cpu_executors_map_to_cpu(executor):
    assert _device_for(executor).platform == "cpu"
    fs = FoamSolver("p", {"executor": executor})
    assert fs.device.platform == "cpu"


def test_no_executor_is_jax_default_device():
    cfg = parse_controls({})
    assert cfg.executor is None
    assert _device_for(None) == jax.devices()[0]
    assert FoamSolver("p", {}).device == jax.devices()[0]


def test_cuda_executor_requires_a_gpu():
    # this suite runs with JAX_PLATFORMS=cpu: there is no GPU to take
    with pytest.raises(RuntimeError, match="gpu"):
        _device_for("cuda")
    with pytest.raises(RuntimeError, match="gpu"):
        FoamSolver("p", {"executor": "cuda"})


def test_tpu_executor_names_cuda():
    with pytest.raises(ValueError, match="cuda"):
        _device_for("tpu")
    m = problems.poisson_ldu((8, 8))
    with pytest.raises(ValueError, match="cuda"):
        foam.solve("p", m, np.ones(m.n), {"executor": "tpu"})


@pytest.mark.parametrize("executor", ["hip", "dpcpp", "gpu0"])
def test_unknown_executor_raises(executor):
    with pytest.raises(ValueError, match="unknown executor"):
        _device_for(executor)


def test_solve_runs_on_the_executor_device():
    m = problems.poisson_ldu((12, 12))
    x, perf = foam.solve("p", m, np.ones(m.n), {"executor": "cpu"})
    assert perf.converged
    assert {d.platform for d in x.devices()} == {"cpu"}


@pytest.mark.parametrize("key", ["fusedCG", "fusedBiCGStab"])
@pytest.mark.parametrize("value", [True, False])
def test_removed_fused_keys_parse_and_are_ignored(key, value):
    """fvSolution files written for the merged kernels still parse; the
    key selects nothing."""
    m = problems.poisson_ldu((16, 8))
    b = np.random.default_rng(0).normal(size=m.n)
    ctl = {"solver": "GKOCG", "executor": "reference", "tolerance": 1e-8,
           "relTol": 0, "matrixFormat": "Dia"}
    cfg = parse_controls({**ctl, key: value})
    assert cfg == parse_controls(ctl)
    x1, p1 = foam.solve("a", m, b, {**ctl, key: value})
    x2, p2 = foam.solve("b", m, b, ctl)
    assert p1.n_iterations == p2.n_iterations
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


# --- compile cache ------------------------------------------------------------

@pytest.fixture
def fresh_cache_state(monkeypatch):
    """Let ensure_compilation_cache run again, and restore jax's cache
    directory afterwards."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(common, "_cache_set", False)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert common.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert common.compilation_cache_dir() == os.path.join(repo, ".jax_cache")


def test_ensure_cache_sets_nothing_when_env_set(monkeypatch, tmp_path,
                                                fresh_cache_state):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    jax.config.update("jax_compilation_cache_dir", None)
    common.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / "env").exists()


def test_ensure_cache_default_placement(monkeypatch, tmp_path,
                                        fresh_cache_state):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(common, "_DEFAULT_CACHE_DIR", str(tmp_path / "c"))
    jax.config.update("jax_compilation_cache_dir", None)
    common.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_ensure_cache_keeps_a_configured_dir(monkeypatch, tmp_path,
                                             fresh_cache_state):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "user"))
    common.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "user")


def test_disable_compilation_cache(fresh_cache_state):
    common.disable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None
    common.ensure_compilation_cache()  # a no-op from now on
    assert jax.config.jax_compilation_cache_dir is None
