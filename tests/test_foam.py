"""Front-end tests: OpenFOAM dictionary parsing, fvSolution->config, the
GKO* solver API with registry caching, adaptMinIter across solves, export."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from ogl_tpu import foam, registry
from ogl_tpu import testing as problems
from ogl_tpu.config import parse_controls
from ogl_tpu.core import ldu, mtx
from ogl_tpu.foam import dictionary
from ogl_tpu.kernels import spmv

FV_SOLUTION = """
// fvSolution-style input
solvers
{
    p
    {
        solver          GKOCG;
        executor        reference;   // cpu path
        matrixFormat    Csr;
        tolerance       1e-08;
        relTol          0;
        maxIter         500;
        verbose         0;
        adaptMinIter    yes;
        preconditioner  { preconditioner BJ; maxBlockSize 1; caching 10; }
    }
    "(U|UFinal)"
    {
        solver          GKOBiCGStab;
        executor        reference;
        tolerance       1e-07;
        preconditioner  none;
    }
}
"""


def test_dictionary_parser():
    d = dictionary.parse(FV_SOLUTION)
    p = d["solvers"]["p"]
    assert p["solver"] == "GKOCG"
    assert p["tolerance"] == 1e-08
    assert p["relTol"] == 0
    assert p["adaptMinIter"] is True
    assert p["preconditioner"]["preconditioner"] == "BJ"
    assert p["preconditioner"]["caching"] == 10


def test_dictionary_lists_and_comments():
    d = dictionary.parse("""
    /* block comment { not a dict } */
    key1 (1 2 3);
    key2 (a (b c));
    key3 "quoted string";
    switch on;
    """)
    assert d["key1"] == [1, 2, 3]
    assert d["key2"] == ["a", ["b", "c"]]
    assert d["key3"] == "quoted string"
    assert d["switch"] is True


def test_regex_solver_key():
    d = dictionary.parse(FV_SOLUTION)
    u = dictionary.solver_controls(d, "UFinal")
    assert u["solver"] == "GKOBiCGStab"
    with pytest.raises(KeyError):
        dictionary.solver_controls(d, "nonexistent")


def test_parse_controls_from_dictionary():
    d = dictionary.parse(FV_SOLUTION)
    cfg = parse_controls(dictionary.solver_controls(d, "p"))
    assert cfg.solver == "GKOCG"
    assert cfg.matrix_format == "Csr"
    assert cfg.stopping.tolerance == 1e-8
    assert cfg.precond.name == "BJ"
    assert cfg.precond.caching == 10
    # BiCGStab doubles maxIter (reference StoppingCriterion.H:188)
    cfg_u = parse_controls(dictionary.solver_controls(d, "U"))
    assert cfg_u.stopping.max_iter == 2000


def _problem(dims=(12, 12)):
    m = problems.poisson_ldu(dims)
    a = problems.poisson_dense(dims)
    rng = np.random.default_rng(5)
    x_true = rng.normal(size=m.n)
    return m, a @ x_true, x_true


@pytest.mark.parametrize("solver_name", ["GKOCG", "GKOBiCGStab", "GKOGMRES", "GKOIR", "GKOMultigrid"])
def test_foam_solve_api(solver_name):
    m, b, x_true = _problem()
    controls = {
        "solver": solver_name,
        "executor": "reference",
        "tolerance": 1e-9,
        "relTol": 0,
        "maxIter": 3000,
        "dtype": "float64",
        "preconditioner": "BJ" if solver_name == "GKOIR" else "none",
    }
    x, perf = foam.solve("p", m, b, controls)
    assert perf.converged
    assert perf.n_iterations > 0
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    assert perf.final_residual < 1e-9


def test_steady_state_reuses_solver_and_adapts():
    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-9,
        "relTol": 0, "maxIter": 500, "dtype": "float64", "adaptMinIter": True,
    }
    x1, perf1 = foam.solve("p", m, b, controls)
    solver1 = registry.global_registry.get("p_solver")
    x2, perf2 = foam.solve("p", m, b, {})  # controls ignored on registry hit
    solver2 = registry.global_registry.get("p_solver")
    assert solver1 is solver2
    props = registry.global_registry.properties("p")
    assert props.prev_solve_iters == perf2.n_iterations
    # adaptMinIter: second solve must run at least relax*prev iterations
    assert perf2.n_iterations >= int(0.6 * perf1.n_iterations)
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)


def test_update_sys_matrix_false_keeps_old_coeffs():
    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "maxIter": 500, "dtype": "float64",
        "updateSysMatrix": False,
    }
    x1, _ = foam.solve("p", m, b, controls)
    # scale the matrix 2x; with updateSysMatrix false the solve still uses A
    import dataclasses

    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    x2, _ = foam.solve("p", m2, b, controls)
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)  # NOT x_true/2


def test_coefficient_update_changes_solution():
    """Steady-state path: same sparsity, new coefficients — the compiled
    program must see the NEW values (regression: closure-captured matrices
    would silently freeze the operator)."""
    import dataclasses

    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "maxIter": 500, "dtype": "float64",
        "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 1},
    }
    x1, _ = foam.solve("p", m, b, controls)
    np.testing.assert_allclose(np.asarray(x1), x_true, atol=1e-6)
    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)  # A' = 2A
    x2, perf2 = foam.solve("p", m2, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true / 2.0, atol=1e-6)
    assert perf2.converged


def test_delta_block_upload():
    """Steady-state delta uploads: only changed LDU blocks cross the
    host->device boundary (unchanged blocks are compared equal and their
    HBM-resident upload is reused), and the solve still sees exactly the
    current coefficients."""
    import dataclasses

    from ogl_tpu import registry

    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "maxIter": 500, "dtype": "float64",
    }
    x1, _ = foam.solve("pDelta", m, b, controls)
    np.testing.assert_allclose(np.asarray(x1), x_true, atol=1e-6)
    slv = registry.global_registry.get_or_init("pDelta_solver", lambda: None)

    # step 2: first delta-tracked step seeds the baseline (all blocks up);
    # step 2b: identical coefficients — nothing crosses the boundary
    foam.solve("pDelta", dataclasses.replace(m), b, {})
    assert slv.last_blocks_uploaded == (2, 2)  # (uploaded, total[upper,diag])
    foam.solve("pDelta", dataclasses.replace(m), b, {})
    assert slv.last_blocks_uploaded == (0, 2)

    # step 3: diag-only change — exactly one block uploads, solution exact
    m3 = dataclasses.replace(m, diag=m.diag + 1.0)
    x3, perf3 = foam.solve("pDelta", m3, b, {})
    assert slv.last_blocks_uploaded == (1, 2)
    assert perf3.converged
    a3 = _dense_of(m3)
    np.testing.assert_allclose(
        np.asarray(x3), np.linalg.solve(a3, np.asarray(b)), atol=1e-6)

    # unchanged RHS is also delta-skipped; a changed one re-uploads
    assert slv.last_rhs_uploaded is False
    b2 = np.asarray(b) * 2.0
    x3b, _ = foam.solve("pDelta", m3, b2, {})
    assert slv.last_rhs_uploaded is True
    np.testing.assert_allclose(np.asarray(x3b), 2.0 * np.asarray(x3), atol=1e-5)

    # step 4: off-diagonal change — upper uploads too
    m4 = dataclasses.replace(m3, upper=m3.upper * 1.5)
    x4, perf4 = foam.solve("pDelta", m4, b2, {})
    assert slv.last_blocks_uploaded[0] >= 1
    assert perf4.converged
    a4 = _dense_of(m4)
    np.testing.assert_allclose(
        np.asarray(x4), np.linalg.solve(a4, np.asarray(b2)), atol=1e-6)


def _dense_of(m):
    from ogl_tpu.core import formats as _f
    from ogl_tpu.core import ldu as _l

    return np.asarray(_f.to_dense(_l.ldu_to_coo_host(m, dtype=np.float64)))


def test_precond_skip_when_operator_unchanged():
    """When the operator coefficients are bitwise unchanged between solves
    (delta-upload bookkeeping says nothing crossed the boundary),
    preconditioner regeneration is a deterministic no-op and is skipped
    even with caching=0 (the reference regenerates from identical inputs,
    Preconditioner.H:405-417 — pure waste).  A changed operator still
    triggers regeneration."""
    import dataclasses

    from ogl_tpu import registry

    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "maxIter": 500, "dtype": "float64",
        "preconditioner": {"preconditioner": "Multigrid", "caching": 0},
    }
    x1, _ = foam.solve("pPcSkip", m, b, controls)
    np.testing.assert_allclose(np.asarray(x1), x_true, atol=1e-6)
    slv = registry.global_registry.get("pPcSkip_solver")
    pc1 = slv._precond_op
    assert pc1 is not None

    # identical coefficients: the SAME preconditioner object survives
    foam.solve("pPcSkip", dataclasses.replace(m), b, {})
    assert slv._precond_op is pc1
    assert slv.last_blocks_changed == (0, 2)

    # changed diag: regeneration fires and the solve tracks the operator
    m2 = dataclasses.replace(m, diag=m.diag + 1.0)
    x2, perf2 = foam.solve("pPcSkip", m2, b, {})
    assert slv._precond_op is not pc1
    assert perf2.converged
    np.testing.assert_allclose(
        np.asarray(x2), np.linalg.solve(_dense_of(m2), np.asarray(b)),
        atol=1e-6)


def test_export_writes_mtx(tmp_path):
    m, b, _ = _problem((6, 6))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        controls = {
            "solver": "GKOCG", "executor": "reference", "tolerance": 1e-8,
            "relTol": 0, "dtype": "float64", "export": True,
        }
        foam.solve("p", m, b, controls)
        assert os.path.exists("processor0/0/p_A_local.mtx")
        assert os.path.exists("processor0/0/p_b.mtx")
        a_back = mtx.read("processor0/0/p_A_local.mtx")
        np.testing.assert_allclose(
            np.asarray(a_back.vals).sum(), problems.poisson_dense((6, 6)).sum(), atol=1e-10
        )
    finally:
        os.chdir(cwd)


def test_scaling_config():
    """`scaling` multiplies BOTH the matrix (reference HostMatrix.C:33) and
    the RHS (lduLduBase.H:244-252 dist_b->scale) — the solution must be
    invariant.  A drop-in user with `scaling` set gets identical fields."""
    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "dtype": "float64", "scaling": 2.0, "maxIter": 500,
    }
    x, perf = foam.solve("p", m, b, controls)
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    # steady-state path (device value update) keeps the same semantics
    x2, perf2 = foam.solve("p", m, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)


def test_scaling_config_distributed():
    """Distributed solves honor `scaling` identically: matrix AND RHS scaled,
    solution invariant — on the construction path and the steady-state
    coefficient-update path."""
    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "dtype": "float64", "scaling": 2.0, "maxIter": 500,
    }
    x, perf = foam.solve_distributed("pscal", m, b, controls)
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    x2, _ = foam.solve_distributed("pscal", m, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)


def test_gdia_format_and_rcm_reorder():
    """matrixFormat Gdia + reorder rcm: the general unstructured path."""
    m, b, x_true = _problem()
    controls = {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-9,
        "relTol": 0, "maxIter": 600, "dtype": "float64",
        "matrixFormat": "Gdia", "reorder": "rcm",
    }
    x, perf = foam.solve("p", m, b, controls)
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    # steady state with changed coefficients keeps the permutation coherent
    import dataclasses

    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    x2, perf2 = foam.solve("p", m2, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true / 2, atol=1e-6)


def test_bad_solver_name():
    m, b, _ = _problem((4, 4))
    with pytest.raises(ValueError, match="unknown solver"):
        foam.solve("p", m, b, {"solver": "GKOFancy", "executor": "reference"})


def test_foam_nonsymmetric_ldu():
    """Momentum-equation-like asymmetric LDU through the foam layer."""
    import dataclasses

    m = problems.poisson_ldu((10, 10))
    rng = np.random.default_rng(9)
    m = dataclasses.replace(m, lower=m.upper * (0.5 + 0.1 * rng.random(m.n_faces)))
    from ogl_tpu.core import formats as _f

    a = _f.to_dense(ldu.ldu_to_coo_host(m))
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    x, perf = foam.solve("u", m, b, {
        "solver": "GKOBiCGStab", "executor": "reference", "tolerance": 1e-9,
        "relTol": 0, "maxIter": 800, "dtype": "float64",
    })
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)


def test_foam_cyclic_interface():
    """Local (cyclic) interfaces enter the matrix with negated coefficients
    and survive steady-state updates (reference HostMatrix.C:204,469-589)."""
    m0 = problems.poisson_ldu((12,))
    iface = ldu.LocalInterface(
        rows=np.array([0, 11]), cols=np.array([11, 0]), coeffs=np.array([1.0, 1.0])
    )
    import dataclasses

    m = dataclasses.replace(m0, local_interfaces=(iface,),
                            diag=m0.diag + 1.0)  # keep SPD with the -(-1) coupling
    from ogl_tpu.core import formats as _f

    a = _f.to_dense(ldu.ldu_to_coo_host(m))
    assert a[0, 11] == -1.0 and a[11, 0] == -1.0  # negated bouCoeffs
    rng = np.random.default_rng(10)
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    x, perf = foam.solve("pc", m, b, {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
        "relTol": 0, "maxIter": 300, "dtype": "float64",
    })
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-7)


def test_update_rhs_false_reuses_cached_b():
    """updateRHS false: later solves ignore the provided b (reference
    PersistentVector gating, lduLduBase.H:224)."""
    m, b, x_true = _problem()
    controls = {"solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
                "relTol": 0, "maxIter": 500, "dtype": "float64",
                "updateRHS": False}
    x1, _ = foam.solve("p", m, b, controls)
    x2, _ = foam.solve("p", m, 5 * b, {})  # new b ignored
    np.testing.assert_allclose(np.asarray(x2), x_true, atol=1e-6)


def test_regenerate_forces_rebuild():
    m, b, x_true = _problem()
    controls = {"solver": "GKOCG", "executor": "reference", "tolerance": 1e-10,
                "relTol": 0, "maxIter": 500, "dtype": "float64",
                "regenerate": True}
    x1, _ = foam.solve("p", m, b, controls)
    import dataclasses

    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    x2, _ = foam.solve("p", m2, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true / 2, atol=1e-6)


@pytest.mark.parametrize("fmt", [None, "Coo", "Csr", "Ell", "Dia", "Sell"])
def test_matrix_format_is_used_as_named(fmt):
    """The device format is the one `matrixFormat` names, on every device;
    unset means the reference default Coo (no platform-dependent
    re-routing)."""
    from ogl_tpu import testing as problems
    from ogl_tpu.core import formats, ldu
    from ogl_tpu.foam.solver import FoamSolver

    coo = ldu.ldu_to_coo_host(problems.poisson_ldu((12, 12)))
    controls = {"solver": "GKOCG", "executor": "reference"}
    if fmt is not None:
        controls["matrixFormat"] = fmt
    fs = FoamSolver(f"fmt_{fmt}", controls)
    mat = fs._convert(coo)
    want = fmt or "Coo"
    assert type(mat).__name__ == want and fs._fmt_used == want
    x = np.random.default_rng(0).normal(size=coo.shape[0])
    np.testing.assert_allclose(
        np.asarray(spmv.spmv(mat, jnp.asarray(x))),
        formats.to_dense(coo) @ x, atol=1e-10)


def test_foam_matrix_format_hybrid():
    """matrixFormat Hybrid end-to-end (ELL bulk + COO tail; the reference
    advertises Hybrid but ships it disabled, CsrMatrixWrapper.H:150-153)."""
    m, b, x_true = _problem()
    controls = {"solver": "GKOCG", "executor": "reference",
                "matrixFormat": "Hybrid", "tolerance": 1e-10, "relTol": 0,
                "maxIter": 600, "dtype": "float64"}
    x, perf = foam.solve("phyb", m, b, controls)
    assert perf.converged and perf.solver_name.endswith("Hybrid")
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    # steady-state update goes through the jit'd value map
    import dataclasses as dc

    m2 = dc.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    x2, perf2 = foam.solve("phyb", m2, b, {})
    np.testing.assert_allclose(np.asarray(x2), x_true / 2, atol=1e-6)


def test_dictionary_regex_last_match_wins():
    """OpenFOAM searches pattern keys in reverse insertion order — a later
    overlapping regex entry overrides an earlier one."""
    from ogl_tpu.foam import dictionary

    fv = dictionary.parse("""
solvers
{
    "(p|pFinal)" { solver GKOCG; }
    "p.*"        { solver GKOBiCGStab; }
}
""")
    c = dictionary.solver_controls(fv, "pFinal")
    assert c["solver"] == "GKOBiCGStab"
    # exact key still beats patterns
    fv2 = dictionary.parse("""
solvers
{
    "p.*" { solver GKOBiCGStab; }
    pFinal { solver GKOCG; }
}
""")
    assert dictionary.solver_controls(fv2, "pFinal")["solver"] == "GKOCG"


def test_adapt_min_iter_relaxation_factor_one():
    """relaxationFactor 1 must not divide by zero in the adaptMinIter
    policy (clamped into [0, 0.99))."""
    from ogl_tpu.config import StoppingConfig

    cfg = StoppingConfig(relaxation_factor=1.0, adapt_min_iter=True)
    adapted = cfg.adapted(prev_solve_iters=50, prev_rel_cost=0.5, export_res=False)
    assert adapted.min_iter == 49  # 50 * 0.99 -> 49
    assert adapted.frequency >= 1


def test_log_parsing_and_validation(capsys):
    """solverPerformance log round trip (the reference's postProcessLogs /
    obr-query validation path, test/postProcessLogs.py)."""
    from ogl_tpu.foam import logs

    m, b, x_true = _problem()
    _, perf = foam.solve("plog", m, b, {
        "solver": "GKOCG", "executor": "reference", "tolerance": 1e-9,
        "relTol": 0, "maxIter": 500, "dtype": "float64"})
    perf.print()
    out = capsys.readouterr().out
    recs = logs.validate_log(out, "plog", tolerance=1e-8)
    assert recs[0].n_iterations == perf.n_iterations
    assert recs[0].solver.startswith("GKOCG")
    # coupled (vector-residual) lines parse too
    B = np.stack([b, 2 * b], axis=1)
    X, perfc = foam.solve_coupled("ulog", m, B, {
        "executor": "reference", "tolerance": 1e-9, "relTol": 0,
        "maxIter": 500, "dtype": "float64"})
    perfc.print()
    out2 = capsys.readouterr().out
    recs2 = logs.validate_log(out2, "ulog", tolerance=1e-8)
    assert recs2[0].n_iterations == perfc.n_iterations
    assert isinstance(recs2[0].final_residual, tuple)
    # a failing log raises
    import pytest as _pt

    with _pt.raises(AssertionError):
        logs.validate_log("GKOCG:  Solving for p, Initial residual = 1, "
                          "Final residual = 2, No Iterations 5", "p")


def test_ir_inner_cg():
    """GKOIR with an `inner` sub-dict runs an inner CG with its own
    OpenFOAM criterion (reference create_default, GKOIR.H:58-78): far
    fewer outer iterations than preconditioned Richardson."""
    m, b, x_true = _problem()
    base = {"solver": "GKOIR", "executor": "reference", "tolerance": 1e-9,
            "relTol": 0, "maxIter": 3000, "dtype": "float64"}
    _, perf_rich = foam.solve("pIrPlain", m, b, {**base, "preconditioner": "BJ"})
    x, perf = foam.solve("pIrInner", m, b, {
        **base, "inner": {"tolerance": 1e-2, "relTol": 0, "maxIter": 200}})
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)
    assert perf.final_residual < 1e-9
    # each outer step removes ~2 orders of magnitude: outer count is tiny
    assert perf.n_iterations < perf_rich.n_iterations / 4


def test_ir_inner_bf16_defect_correction():
    """Mixed precision: a bfloat16-packed inner operator still converges
    the OUTER iteration to f32 accuracy — the outer residual is computed
    against the full-precision matrix (defect correction)."""
    m, b, x_true = _problem()
    x, perf = foam.solve("pIrBf16", m, b, {
        "solver": "GKOIR", "executor": "reference", "tolerance": 1e-6,
        "relTol": 0, "maxIter": 3000, "dtype": "float32",
        "inner": {"tolerance": 1e-2, "relTol": 0, "maxIter": 200,
                  "precision": "bfloat16"}})
    assert perf.converged
    assert perf.final_residual < 1e-6  # f32 tolerance despite bf16 inner
    np.testing.assert_allclose(np.asarray(x), x_true, atol=2e-3)


def test_parse_inner_controls():
    cfg = parse_controls({"solver": "GKOIR",
                          "inner": {"tolerance": 1e-3, "maxIter": 77,
                                    "precision": "bfloat16"}})
    assert cfg.inner_stopping is not None
    assert cfg.inner_stopping.tolerance == 1e-3
    assert cfg.inner_stopping.max_iter == 77
    assert cfg.inner_stopping.adapt_min_iter is False
    assert cfg.inner_precision == "bfloat16"
    assert parse_controls({"solver": "GKOIR"}).inner_stopping is None
    with pytest.raises(ValueError, match="precision"):
        parse_controls({"solver": "GKOIR", "inner": {"precision": "fp8"}})


def test_fv_solution_text_inner_and_precision():
    """The fvSolution TEXT surface round-trips the GKOIR `inner` sub-dict
    and the `precision` knobs into the parsed config."""
    text = """
    solvers
    {
        p
        {
            solver          GKOIR;
            executor        cpu;
            tolerance       1e-06;
            inner
            {
                tolerance   1e-02;
                maxIter     150;
                precision   bfloat16;
            }
            preconditioner
            {
                preconditioner  Multigrid;
                precision       bfloat16;
            }
        }
    }
    """
    controls = dictionary.solver_controls(dictionary.parse(text), "p")
    cfg = parse_controls(controls)
    assert cfg.inner_stopping.tolerance == 1e-2
    assert cfg.inner_stopping.max_iter == 150
    assert cfg.inner_precision == "bfloat16"
    assert cfg.precond.name == "Multigrid"
    assert cfg.precond.value_precision == "bfloat16"


def test_pipelined_cg_front_end():
    """`pipelinedCG true` routes GKOCG onto the single-reduction variant
    (solve/cg_pipe.py) with identical results and near-identical iteration
    counts."""
    m, b, x_true = _problem()
    base = {"solver": "GKOCG", "executor": "reference", "tolerance": 1e-9,
            "relTol": 0, "maxIter": 3000, "dtype": "float64",
            "preconditioner": "BJ"}
    x_ref, perf_ref = foam.solve("pcgRef", m, b, base)
    x_pipe, perf_pipe = foam.solve("pcgPipe", m, b,
                                   {**base, "pipelinedCG": True})
    assert perf_pipe.converged
    np.testing.assert_allclose(np.asarray(x_pipe), x_true, atol=1e-6)
    assert abs(perf_pipe.n_iterations - perf_ref.n_iterations) <= 2
