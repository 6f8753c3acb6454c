"""Worker for the real multi-process distributed test (test_multiprocess.py).

Each of two CPU processes (2 virtual devices each — a 4-device global mesh)
initialises jax.distributed, stages ITS shards of a decomposed Poisson
system, runs the shard_map'd distributed CG, and checks its addressable
slices of the solution.  This exercises the actual multi-host code path
(jax.distributed init + make_array_from_single_device_arrays staging +
cross-process collectives) that a multi-host run uses
(reference ExecutorHandler.H:115-179 / mpirun equivalent).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=2"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    coordinator, n_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    from ogl_tpu import testing as problems
    from ogl_tpu.config import StoppingConfig
    from ogl_tpu.core import ldu
    from ogl_tpu.dist import runtime
    from ogl_tpu.dist.from_ranks import DistAssembler
    from ogl_tpu.dist.partition import split_vector
    from ogl_tpu.dist.solve import dist_solve
    from ogl_tpu.solve.stopping import StoppingParams

    assert runtime.init_distributed(coordinator, n_procs, pid)
    assert jax.process_count() == n_procs
    mesh = runtime.global_mesh()
    n_parts = int(np.prod(mesh.devices.shape))
    assert n_parts == 4, mesh

    m = problems.poisson_ldu((16, 16))
    a = problems.poisson_dense((16, 16))
    rng = np.random.default_rng(3)
    x_true = rng.normal(size=m.n)
    b = a @ x_true

    parts = ldu.decompose(m, n_parts)
    asm = DistAssembler(parts, dtype=np.float64)
    dm = asm.dm

    dm_staged = runtime.stage_tree(dm, mesh)
    b_stack = runtime.stage_tree(
        jnp.asarray(split_vector(dm, b), jnp.float64), mesh)
    x0_stack = runtime.stage_tree(
        jnp.zeros((n_parts, dm.n_local), jnp.float64), mesh)

    sp = StoppingParams.of(StoppingConfig(tolerance=1e-10, rel_tol=0.0,
                                          max_iter=600))
    x_stack, res = dist_solve(dm_staged, b_stack, x0_stack, sp, mesh)
    assert bool(np.asarray(jax.device_get(res.converged)).ravel()[0]), res

    # each process validates the shards it can address
    for shard in x_stack.addressable_shards:
        i = shard.index[0].start if isinstance(shard.index[0], slice) else shard.index[0]
        start = sum(dm.local_sizes[:i])
        size = dm.local_sizes[i]
        got = np.asarray(shard.data).reshape(-1)[:size]
        np.testing.assert_allclose(got, x_true[start:start + size], atol=1e-6)

    # --- multi-process foam front end: per-process rank data ------------
    # each process passes ONLY its mesh devices' LduMatrix systems and RHS
    # pieces (the reference's per-MPI-rank deployment shape); construction
    # agrees on global structure through the metadata allgather
    import dataclasses

    from ogl_tpu.foam.dist_solver import DistFoamSolver

    parts = ldu.decompose(m, n_parts)
    my_idx = [i for i, d in enumerate(mesh.devices.ravel())
              if d.process_index == jax.process_index()]
    my_ranks = [parts[i] for i in my_idx]
    offs = np.cumsum([0] + [p_.n for p_ in parts])
    my_b = [b[offs[i]:offs[i + 1]] for i in my_idx]
    s = DistFoamSolver("pmp", {"solver": "GKOCG", "tolerance": 1e-9,
                               "relTol": 0, "maxIter": 600,
                               "dtype": "float64",
                               "preconditioner": "BJ"}, mesh)
    xs1, perf1 = s.solve(my_ranks, my_b)
    assert perf1.converged, perf1
    for i, x_i in zip(my_idx, xs1):
        np.testing.assert_allclose(x_i, x_true[offs[i]:offs[i + 1]],
                                   atol=1e-6)
    # steady state: doubled coefficients through the staged update path.
    # Double the GLOBAL system then re-decompose (doubling per-rank blocks
    # after decomposition would leave the processor-interface couplings
    # at 1x — a different matrix whose solution is NOT x_true/2)
    m2 = dataclasses.replace(m, diag=2 * m.diag, upper=2 * m.upper)
    parts2 = ldu.decompose(m2, n_parts)
    my2 = [parts2[i] for i in my_idx]
    xs2, perf2 = s.solve(my2, my_b)
    assert perf2.converged, perf2
    for i, x_i in zip(my_idx, xs2):
        np.testing.assert_allclose(x_i, x_true[offs[i]:offs[i + 1]] / 2,
                                   atol=1e-6)
    assert s.assembler.last_update_staged is True  # values changed: staged
    # identical step: the delta agreement must skip the staging collective
    # on EVERY process, and the solution must still track the operator
    xs3, perf3 = s.solve([dataclasses.replace(r) for r in my2], my_b)
    assert s.assembler.last_update_staged is False
    assert perf3.converged, perf3
    for i, x_i in zip(my_idx, xs3):
        np.testing.assert_allclose(x_i, x_true[offs[i]:offs[i + 1]] / 2,
                                   atol=1e-6)
    print(f"MPFOAM OK {pid} iters={perf1.n_iterations}/{perf2.n_iterations}",
          flush=True)

    # multi-process export: each process writes processor<r>/ for ITS ranks
    import tempfile

    from jax.experimental import multihost_utils

    shared = os.environ.get("MP_EXPORT_DIR") or tempfile.gettempdir()
    exp_dir = os.path.join(shared, f"ogl_mp_export_{os.environ.get('MP_RUN_ID', 'x')}")
    os.makedirs(exp_dir, exist_ok=True)
    cwd0 = os.getcwd()
    os.chdir(exp_dir)
    try:
        se = DistFoamSolver("pexp", {"solver": "GKOCG", "tolerance": 1e-8,
                                     "relTol": 0, "maxIter": 600,
                                     "dtype": "float64", "export": True},
                            mesh)
        se.solve(my_ranks, my_b)
        for i in my_idx:
            for sfx in ("_A_local.mtx", "_A_non_local.mtx", "_b.mtx",
                        "_comm.json"):
                path = f"processor{i}/0/pexp{sfx}"
                assert os.path.exists(path), path
        multihost_utils.sync_global_devices("export_done")
        if pid == 0:
            # all ranks' files present -> replay through the consumer
            from ogl_tpu.foam import case as case_mod

            ranks_r, b_r = case_mod.read_exported_case(exp_dir, "pexp", "0")
            assert len(ranks_r) == n_parts
            assert sum(r.n for r in ranks_r) == m.n
            np.testing.assert_allclose(b_r, b, atol=1e-12)
        print(f"MPEXPORT OK {pid}", flush=True)
    finally:
        os.chdir(cwd0)

    # full Schwarz set in multi-process mode: ILU (factor structure differs
    # per shard -> exercised structure-agreement hook) and Multigrid
    for pcn in ("ILU", "Multigrid"):
        sp_ = DistFoamSolver(f"pmp{pcn}", {"solver": "GKOCG",
                                           "tolerance": 1e-9, "relTol": 0,
                                           "maxIter": 600, "dtype": "float64",
                                           "preconditioner": pcn}, mesh)
        xsp, perfp = sp_.solve(my_ranks, my_b)
        assert perfp.converged, (pcn, perfp)
        for i, x_i in zip(my_idx, xsp):
            np.testing.assert_allclose(x_i, x_true[offs[i]:offs[i + 1]],
                                       atol=1e-6)
        print(f"MPSCHWARZ {pcn} OK {pid} iters={perfp.n_iterations}",
              flush=True)

    # Gdia tier through the structure-agreement hook: wide intra-shard
    # couplings exceed the DIA offset cap; every process must agree on the
    # same union plane table from its local shards alone
    from ogl_tpu.dist.partition import GdiaStack

    mg0 = problems.poisson_ldu((64, 16))
    ng = mg0.n
    er = np.arange(0, ng - 101)
    ec = er + 30 + (er % 70)
    keep = (er // 256) == (ec // 256)  # intra-shard (256 rows/shard)
    er, ec = er[keep], ec[keep]
    la = np.concatenate([mg0.lower_addr, er])
    ua = np.concatenate([mg0.upper_addr, ec])
    order_g = np.lexsort((ua, la))
    from ogl_tpu.core.ldu import LduMatrix

    mg = LduMatrix(
        n=ng, lower_addr=la[order_g], upper_addr=ua[order_g],
        diag=mg0.diag + 0.1,
        upper=np.concatenate([mg0.upper, np.full(len(er), -0.01)])[order_g])
    from ogl_tpu.core import formats as _fmts

    ag = _fmts.to_dense(ldu.ldu_to_coo_host(mg))
    xg_true = rng.normal(size=ng)
    bg = ag @ xg_true
    partsg = ldu.decompose(mg, n_parts)
    offsg = np.cumsum([0] + [p_.n for p_ in partsg])
    sg = DistFoamSolver("pgdia", {"solver": "GKOCG", "tolerance": 1e-9,
                                  "relTol": 0, "maxIter": 2000,
                                  "dtype": "float64"}, mesh)
    xsg, perfg = sg.solve([partsg[i] for i in my_idx],
                          [bg[offsg[i]:offsg[i + 1]] for i in my_idx])
    assert isinstance(sg.assembler.dm.local, GdiaStack), type(
        sg.assembler.dm.local)
    assert perfg.converged, perfg
    for i, x_i in zip(my_idx, xsg):
        np.testing.assert_allclose(x_i, xg_true[offsg[i]:offsg[i + 1]],
                                   atol=1e-6)
    print(f"MPGDIA OK {pid} iters={perfg.n_iterations}", flush=True)

    # Xell tier through the structure-agreement hook (kind "xell"): fully
    # unstructured intra-shard couplings; every process packs only its own
    # shards and must land on the SAME union statics (n_slots, window,
    # spill width) — and the same Xell-vs-Ell branch — via the allgather
    rngx = np.random.default_rng(11)
    mx0 = problems.poisson_ldu((64, 16))
    nx = mx0.n
    xr = rngx.integers(0, nx, size=600)
    xc = rngx.integers(0, nx, size=600)
    keepx = ((xr // 256) == (xc // 256)) & (xr < xc)
    xr, xc = xr[keepx], xc[keepx]
    # dedupe against the Poisson couplings and within themselves
    seen = set(zip(mx0.lower_addr.tolist(), mx0.upper_addr.tolist()))
    uniq = [(a, b) for a, b in dict.fromkeys(zip(xr.tolist(), xc.tolist()))
            if (a, b) not in seen]
    xr = np.asarray([a for a, _ in uniq])
    xc = np.asarray([b for _, b in uniq])
    lax_ = np.concatenate([mx0.lower_addr, xr])
    uax_ = np.concatenate([mx0.upper_addr, xc])
    order_x = np.lexsort((uax_, lax_))
    mx = LduMatrix(
        n=nx, lower_addr=lax_[order_x], upper_addr=uax_[order_x],
        diag=mx0.diag + 0.5,
        upper=np.concatenate([mx0.upper, np.full(len(xr), -0.02)])[order_x])
    ax = _fmts.to_dense(ldu.ldu_to_coo_host(mx))
    xx_true = rng.normal(size=nx)
    bx = ax @ xx_true
    partsx = ldu.decompose(mx, n_parts)
    offsx = np.cumsum([0] + [p_.n for p_ in partsx])
    sx = DistFoamSolver("pxell", {"solver": "GKOCG", "tolerance": 1e-9,
                                  "relTol": 0, "maxIter": 2000,
                                  "dtype": "float64",
                                  "distLocalFormat": "Xell"}, mesh)
    xsx, perfx = sx.solve([partsx[i] for i in my_idx],
                          [bx[offsx[i]:offsx[i + 1]] for i in my_idx])
    from ogl_tpu.dist.partition import XellStack

    assert isinstance(sx.assembler.dm.local, XellStack), type(
        sx.assembler.dm.local)
    assert perfx.converged, perfx
    for i, x_i in zip(my_idx, xsx):
        np.testing.assert_allclose(x_i, xx_true[offsx[i]:offsx[i + 1]],
                                   atol=1e-6)
    print(f"MPXELL OK {pid} iters={perfx.n_iterations} "
          f"k={sx.assembler.dm.local.n_slots}", flush=True)

    # adaptMinIter agreement (reference lduLduBase.H:291-293): per-process
    # wall-clock cost measurements differ — broadcast_scalars must make
    # every process derive IDENTICAL StoppingParams.  Feed wildly different
    # local measurements; the parent asserts the PARAMS lines match.
    local_cost = 0.5 + 10.0 * pid
    (rel_cost,) = runtime.broadcast_scalars(local_cost)
    assert rel_cost == 0.5, f"expected process-0's value, got {rel_cost}"
    adapted = StoppingConfig(adapt_min_iter=True).adapted(
        prev_solve_iters=282, prev_rel_cost=rel_cost, export_res=False)
    print(f"PARAMS {pid} minIter={adapted.min_iter} "
          f"frequency={adapted.frequency}", flush=True)
    print(f"OK {pid}", flush=True)


if __name__ == "__main__":
    main()
