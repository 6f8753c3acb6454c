"""Exporter→consumer interop loop: export a decomposed
case in the reference's processor?/<time>/ format, validate the artifacts in
the style of the reference's test/data_validation.py:53-121 (existence,
uniqueness across steps, diag signs), ingest them back into per-rank
LduMatrix systems, and replay the solve with matching solutions across the
{CG, BiCGStab, GMRES} × {BJ, ILU, GISAI} matrix."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from ogl_tpu import foam, registry
from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu, mtx
from ogl_tpu.foam import case

FV_SOLUTION = """
solvers
{
    p
    {
        solver          GKOCG;
        executor        reference;
        tolerance       1e-10;
        relTol          0;
        maxIter         600;
        dtype           float64;
        preconditioner  BJ;
    }
}
"""


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.fixture()
def exported_case(tmp_path):
    """A 4-rank exported case with two time steps (changed coefficients)."""
    m = problems.poisson_ldu((16, 12))
    a = problems.poisson_dense((16, 12))
    rng = np.random.default_rng(7)
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
        controls = {"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
                    "maxIter": 600, "dtype": "float64", "export": True,
                    "preconditioner": "BJ"}
        registry.global_registry.clear()
        _, perf1 = foam.solve_distributed("p", m, b, controls, mesh=mesh)
        _, perf2 = foam.solve_distributed("p", m2, b, {}, time_value="0.01")
        os.makedirs("system", exist_ok=True)
        with open("system/fvSolution", "w") as f:
            f.write(FV_SOLUTION)
        registry.global_registry.clear()
    finally:
        os.chdir(cwd)
    return dict(case_dir=str(tmp_path), m=m, m2=m2, a=a, b=b, x_true=x_true,
                iters=(perf1.n_iterations, perf2.n_iterations))


def test_export_artifacts_valid(exported_case):
    """data_validation.py-style checks: per-rank files exist for every
    step, are unique ACROSS steps (coefficient updates must reach the
    export — md5), and the cavity-style sign structure holds (positive
    diag, non-positive off-diag for the Poisson system)."""
    cd = exported_case["case_dir"]
    for t in ("0", "0.01"):
        for i in range(4):
            pre = os.path.join(cd, f"processor{i}", t, "p")
            for suffix in ("_A_local.mtx", "_A_non_local.mtx", "_b.mtx",
                           "_comm.json"):
                assert os.path.exists(pre + suffix), pre + suffix
    for i in range(4):
        h0 = _md5(os.path.join(cd, f"processor{i}", "0", "p_A_local.mtx"))
        h1 = _md5(os.path.join(cd, f"processor{i}", "0.01", "p_A_local.mtx"))
        assert h0 != h1, f"processor{i}: export identical across steps"
        local = mtx.read(os.path.join(cd, f"processor{i}", "0", "p_A_local.mtx"))
        r = np.asarray(local.rows)
        c = np.asarray(local.cols)
        v = np.asarray(local.vals)
        assert (v[r == c] > 0).all(), "diag must be positive"
        assert (v[r != c] <= 0).all(), "off-diag must be non-positive"


def test_roundtrip_matrix_exact(exported_case):
    """Reassembling the ingested per-rank systems reproduces the original
    global operator exactly (both steps)."""
    cd = exported_case["case_dir"]
    for t, m_ref in (("0", exported_case["m"]), ("0.01", exported_case["m2"])):
        ranks, b = case.read_exported_case(cd, "p", t)
        assert len(ranks) == 4
        # stitch the global matrix back together: local blocks on the
        # diagonal, interface couplings via the pairwise face contract
        n = sum(r.n for r in ranks)
        offs = np.cumsum([0] + [r.n for r in ranks])
        dense = np.zeros((n, n))
        for i, r in enumerate(ranks):
            co = ldu.ldu_to_coo_host(r)
            dense[offs[i]:offs[i + 1], offs[i]:offs[i + 1]] += formats.to_dense(co)
        # interface couplings: face k of i->j pairs with face k of j->i
        for i, r in enumerate(ranks):
            for pi in r.proc_interfaces:
                j = pi.neighbor
                back = [q for q in ranks[j].proc_interfaces if q.neighbor == i]
                assert back and len(back[0].face_cells) == len(pi.face_cells)
                for k, (cell, cf) in enumerate(zip(pi.face_cells, pi.coeffs)):
                    dense[offs[i] + cell, offs[j] + back[0].face_cells[k]] += -cf
        ref = formats.to_dense(ldu.ldu_to_coo_host(m_ref))
        np.testing.assert_allclose(dense, ref, atol=1e-12)
        np.testing.assert_allclose(b, exported_case["b"], atol=1e-12)


@pytest.mark.parametrize("solver,precond", [
    ("GKOCG", "BJ"), ("GKOCG", "ILU"), ("GKOCG", "GISAI"),
    ("GKOBiCGStab", "BJ"), ("GKOBiCGStab", "ILU"), ("GKOBiCGStab", "GISAI"),
    ("GKOGMRES", "BJ"), ("GKOGMRES", "ILU"), ("GKOGMRES", "GISAI"),
])
def test_replay_solver_matrix(exported_case, solver, precond):
    """Replay the exported step 0 through the full solver × preconditioner
    matrix; every combination must converge to the original solution."""
    cd = exported_case["case_dir"]
    registry.global_registry.clear()
    controls = {"solver": solver, "tolerance": 1e-9, "relTol": 0,
                "maxIter": 800, "dtype": "float64",
                "preconditioner": precond}
    x, perf = case.solve_exported_case(cd, "p", "0", controls=controls)
    assert perf.converged, perf
    np.testing.assert_allclose(np.asarray(x), exported_case["x_true"],
                               atol=1e-6)


def test_replay_from_fv_solution_iteration_parity(exported_case):
    """Controls come from the case's own system/fvSolution file; the
    replayed solve matches the original export-producing solve's iteration
    count (same operator, same stopping criterion)."""
    cd = exported_case["case_dir"]
    registry.global_registry.clear()
    x, perf = case.solve_exported_case(cd, "p", "0")
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), exported_case["x_true"],
                               atol=1e-6)
    assert abs(perf.n_iterations - exported_case["iters"][0]) <= 2, (
        perf.n_iterations, exported_case["iters"])


def test_single_rank_export_replay(tmp_path):
    """Single-processor exports (FoamSolver) replay through the same
    consumer."""
    m = problems.poisson_ldu((10, 10))
    a = problems.poisson_dense((10, 10))
    rng = np.random.default_rng(1)
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        registry.global_registry.clear()
        foam.solve("q", m, b, {"solver": "GKOCG", "executor": "reference",
                               "tolerance": 1e-10, "relTol": 0,
                               "dtype": "float64", "export": True})
        registry.global_registry.clear()
        x, perf = case.solve_exported_case(
            str(tmp_path), "q", "0",
            controls={"solver": "GKOCG", "executor": "reference",
                      "tolerance": 1e-10, "relTol": 0, "dtype": "float64"})
    finally:
        os.chdir(cwd)
    assert perf.converged
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)


def test_graph_decomposed_export_records_cell_addressing(tmp_path):
    """Graph-decomposed exports write cellProcAddressing: the
    exported case is in the renumbered order, and the addressing maps a
    replayed solution back to the exporter's original field ordering."""
    m = problems.poisson_ldu((16, 12))
    a = problems.poisson_dense((16, 12))
    rng = np.random.default_rng(13)
    x_true = rng.normal(size=m.n)
    b = a @ x_true
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
        registry.global_registry.clear()
        controls = {"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
                    "maxIter": 600, "dtype": "float64", "export": True,
                    "decomposition": "scotch"}
        x0, _ = foam.solve_distributed("p", m, b, controls, mesh=mesh)
        registry.global_registry.clear()
        addr = case.read_cell_addressing(str(tmp_path), "p", "0")
        assert addr is not None and sorted(addr.tolist()) == list(range(m.n))
        xr, perf = case.solve_exported_case(
            str(tmp_path), "p", "0",
            controls={"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
                      "maxIter": 600, "dtype": "float64"}, mesh=mesh)
        registry.global_registry.clear()
    finally:
        os.chdir(cwd)
    assert perf.converged
    # the replayed x is in the export's renumbered order; the addressing
    # maps it back to the caller's ordering
    x_orig = np.empty(m.n)
    x_orig[addr] = np.asarray(xr)
    np.testing.assert_allclose(x_orig, x_true, atol=1e-6)
    np.testing.assert_allclose(np.asarray(x0), x_true, atol=1e-6)
    # a simple-decomposed export has no addressing sidecar
    assert case.read_cell_addressing(str(tmp_path), "nosuch", "0") is None


# ---------------------------------------------------------------------------
# sidecar-free ingest: a TRUE reference export carries
# no _comm.json — the halo mapping must come from the artifacts alone
# ---------------------------------------------------------------------------


def _varying_poisson(dims, seed=11):
    """SPD Poisson with NON-uniform face coefficients (generic reals): the
    reconstructible case.  diag = strict row-dominance over the perturbed
    couplings."""
    m = problems.poisson_ldu(dims)
    rng = np.random.default_rng(seed)
    upper = np.asarray(m.upper) * rng.uniform(0.5, 1.5, size=len(m.upper))
    diag = np.full(m.n, 0.5)
    np.add.at(diag, np.asarray(m.lower_addr), np.abs(upper))
    np.add.at(diag, np.asarray(m.upper_addr), np.abs(upper))
    return dataclasses.replace(m, diag=diag, upper=upper)


def _export_then_strip_sidecars(tmp_path, m, b, n_ranks=4):
    """Export through DistFoamSolver, then delete every _comm.json so the
    on-disk layout is exactly the reference's
    (processor?/<time>/<field>_A_{local,non_local}.mtx + <field>_b.mtx,
    CsrMatrixWrapper.H:271-290)."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        mesh = Mesh(np.array(jax.devices()[:n_ranks]), ("x",))
        registry.global_registry.clear()
        foam.solve_distributed(
            "p", m, b,
            {"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
             "maxIter": 900, "dtype": "float64", "export": True,
             "preconditioner": "BJ"}, mesh=mesh)
        registry.global_registry.clear()
    finally:
        os.chdir(cwd)
    sidecars = []
    for i in range(n_ranks):
        p = os.path.join(tmp_path, f"processor{i}", "0", "p_comm.json")
        with open(p) as f:
            sidecars.append(json.load(f))
        os.remove(p)
    return sidecars


def test_reconstruct_comm_matches_sidecar(tmp_path):
    """The reconstruction must reproduce the exporter's own communication
    pattern exactly on a generic-coefficient case."""
    m = _varying_poisson((16, 12))
    a = np.asarray(
        formats.to_dense(ldu.ldu_to_coo_host(m, dtype=np.float64)))
    b = a @ np.random.default_rng(3).normal(size=m.n)
    sidecars = _export_then_strip_sidecars(tmp_path, m, b)

    seqs = []
    for i in range(4):
        pre = os.path.join(tmp_path, f"processor{i}", "0", "p")
        nl = mtx.read(pre + "_A_non_local.mtx")
        _, coeffs = case._slot_order(nl, pre)
        seqs.append(coeffs)
    recon = case.reconstruct_comm(seqs)
    assert recon == [[{"neighbor": int(c["neighbor"]),
                       "n_faces": int(c["n_faces"])} for c in sc]
                     for sc in sidecars]


def test_sidecar_free_replay_matches_direct_solve(tmp_path):
    """Golden-path drop-in claim: ingest + replay a reference-layout export
    (no sidecar anywhere) and match the f64 dense direct solve."""
    m = _varying_poisson((16, 12), seed=12)
    a = np.asarray(
        formats.to_dense(ldu.ldu_to_coo_host(m, dtype=np.float64)))
    x_true = np.random.default_rng(4).normal(size=m.n)
    b = a @ x_true
    _export_then_strip_sidecars(tmp_path, m, b)

    # the reassembled global system must be EXACT, not just solvable
    ranks, b_read = case.read_exported_case(str(tmp_path), "p", "0")
    parts = [ldu.ldu_to_coo_host(r, dtype=np.float64) for r in ranks]
    offs = np.cumsum([0] + [r.n for r in ranks])
    rows = np.concatenate([np.asarray(p.rows) + offs[i]
                           for i, p in enumerate(parts)])
    # non-local couplings via the reconstructed interfaces
    glob = np.zeros((m.n, m.n))
    for i, (r, p) in enumerate(zip(ranks, parts)):
        glob[np.asarray(p.rows) + offs[i],
             np.asarray(p.cols) + offs[i]] = np.asarray(p.vals)
        for itf in r.proc_interfaces:
            j = itf.neighbor
            other = next(t for t in ranks[j].proc_interfaces
                         if t.neighbor == i)
            glob[np.asarray(itf.face_cells) + offs[i],
                 np.asarray(other.face_cells) + offs[j]] = -np.asarray(itf.coeffs)
    np.testing.assert_allclose(glob, a, rtol=0, atol=1e-12)

    x, perf = case.solve_exported_case(
        str(tmp_path), "p", "0",
        controls={"solver": "GKOCG", "tolerance": 1e-10, "relTol": 0,
                  "maxIter": 900, "dtype": "float64",
                  "preconditioner": "BJ"})
    assert perf.converged
    err = np.abs(np.asarray(x) - x_true).max() / np.abs(x_true).max()
    assert err < 1e-6, f"replayed solution off by {err}"


def test_uniform_coefficients_raise_without_degenerate_optin(tmp_path):
    """Uniform coefficients are the documented degenerate case: the cover
    check cannot detect a mis-pairing, so the default is a hard failure
    naming the sidecar; the explicit allow_degenerate opt-in downgrades it
    to a warning (a strip/chain decomposition IS uniquely covered)."""
    m = problems.poisson_ldu((16, 12))  # all face coeffs identical
    a = problems.poisson_dense((16, 12))
    b = a @ np.random.default_rng(5).normal(size=m.n)
    _export_then_strip_sidecars(tmp_path, m, b)
    with pytest.raises(ValueError, match="_comm.json"):
        case.read_exported_case(str(tmp_path), "p", "0")
    with pytest.warns(RuntimeWarning, match="repeated coefficient"):
        ranks, _ = case.read_exported_case(str(tmp_path), "p", "0",
                                           allow_degenerate=True)
    assert all(len(r.proc_interfaces) >= 1 for r in ranks)


def test_unreconstructible_raises_with_sidecar_guidance():
    """Inconsistent artifacts (a rank whose slots match no peer) must fail
    loudly and name the minimal extra input."""
    seqs = [np.array([1.25, 2.5]), np.array([1.25, 7.75])]
    with pytest.raises(ValueError, match="_comm.json"):
        case.reconstruct_comm(seqs)
