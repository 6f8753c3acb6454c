#!/usr/bin/env python
"""Benchmark harness — the reference's headline metric on one NVIDIA GPU.

The reference prints per-solve statistics (time/iter [µs], time/iter/DOF
[ns], lduLduBase.H:280-305) but vendors no numbers; the baseline is
therefore *generated* here: an unpreconditioned GKOCG solve of the 3-D
lid-driven-cavity pressure system (7-point Laplacian, 1M cells), plus the
Dia SpMV's device-memory bandwidth at 8.4M cells against the card's
published peak and a large copy measured in the same process.

Prints ONE JSON line on stdout right after the headline lanes:
  metric       cg_time_per_iter_per_dof
  value        nanoseconds per CG iteration per DOF (reference north-star)
  vs_baseline  achieved SpMV bandwidth / (0.80 × published peak)
  device       platform, device_kind and device count

Everything else goes to stderr.  Refuses to run without a GPU.  The run is
wall-clock budgeted (OGL_BENCH_BUDGET_S, default 1140 s): optional lanes
are skipped with a log line when the remaining budget cannot cover their
estimate; a lane that fails fails the run.  A SUMMARY block re-printing
every completed lane's one-liner closes the output (also on SIGTERM).
"""

import json
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_T0 = time.monotonic()
BUDGET_S = float(os.environ.get("OGL_BENCH_BUDGET_S", "1140"))
SUMMARY: list[str] = []


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET_S - (time.monotonic() - _T0)


def lane_ok(name: str, est_s: float) -> bool:
    """Budget gate: skip-and-log when the estimate exceeds what's left."""
    if remaining() < est_s:
        line = (f"[skip] {name}: est {est_s:.0f}s > {remaining():.0f}s "
                f"remaining of the {BUDGET_S:.0f}s budget")
        log(line)
        SUMMARY.append(line)
        return False
    return True


def headline(line: str):
    """A lane's one-line result: logged now AND re-printed in the final
    summary block."""
    log(line)
    SUMMARY.append(line)


def print_summary():
    log(f"===== SUMMARY ({time.monotonic() - _T0:.0f}s elapsed of "
        f"{BUDGET_S:.0f}s budget) =====")
    for s in SUMMARY:
        log("  " + s)
    log("===== END SUMMARY =====")


def _on_term(signum, frame):
    log(f"[SIGTERM at {time.monotonic() - _T0:.0f}s — printing summary "
        "and exiting]")
    print_summary()
    sys.exit(1)


def _timed_solve(solve, b, sp, reps=3):
    """Best-of-`reps` host-clock seconds of one solve, ended by
    block_until_ready (compile and warm-up happen before)."""
    jax.block_until_ready(solve(b, sp))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(b, sp))
        best = min(best, time.perf_counter() - t0)
    return best


def _cg_lane(tag, mat, seed, max_iter, peak):
    """Unpreconditioned CG (the XLA path the foam solvers run) on a Dia
    operator; returns (iters, seconds per iteration)."""
    from ogl_tpu.config import StoppingConfig
    from ogl_tpu.kernels import spmv
    from ogl_tpu.solve import cg
    from ogl_tpu.solve.krylov import single_device_ops
    from ogl_tpu.solve.stopping import StoppingParams

    n = mat.shape[0]
    rng = np.random.default_rng(seed)
    x_true = jnp.asarray(rng.normal(size=n).astype(np.float32))

    @jax.jit  # the matrix rides as a traced argument, never a constant
    def solve(m, b, sp):
        return cg(single_device_ops(spmv.matvec(m), n), b, jnp.zeros_like(b), sp)

    b = jax.jit(spmv.spmv)(mat, x_true)
    sp = StoppingParams.of(StoppingConfig(
        tolerance=1e-6, rel_tol=0.0, max_iter=max_iter, frequency=1))
    run = lambda bb, spp: solve(mat, bb, spp)
    res = run(b, sp)
    t = _timed_solve(run, b, sp)
    iters = int(res.iters)
    tpi = t / max(iters, 1)
    # streaming model of one unpreconditioned CG iteration: the nd
    # coefficient planes once, plus 10-12 vector streams (SpMV p in / q
    # out, the p·q and r·r reductions, the x, r and p updates)
    nd = len(mat.offsets)
    lo, hi = nd + 10, nd + 12
    bound = lambda w: w * n * 4 / (peak * 1e9)
    headline(f"CG {tag}: {iters} iters, converged={bool(res.converged)}, "
             f"final={float(res.final_res_norm):.2e}, solve {t * 1e3:.2f} ms, "
             f"time/iter {tpi * 1e6:.2f} µs, time/iter/DOF "
             f"{tpi * 1e9 / n:.4f} ns; streaming bound {lo}-{hi} words/DOF "
             f"= {bound(lo) * 1e6:.1f}-{bound(hi) * 1e6:.1f} µs/iter at "
             f"{peak:.0f} GB/s")
    return iters, tpi


def main():
    signal.signal(signal.SIGTERM, _on_term)
    from ogl_tpu import common
    from ogl_tpu.kernels import roofline, spmv

    common.ensure_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py measures the GPU; JAX found {dev.platform} "
            f"({dev.device_kind}) — refusing to run")
        sys.exit(2)
    dims = (128, 128, 64)
    peak = roofline.hbm_peak_gbps(dev)
    log(f"device: {dev.device_kind} ({dev.platform}, {len(jax.devices())} "
        f"device(s)), published peak {peak:.0f} GB/s; problem: {dims} "
        f"({np.prod(dims):,} DOF), float32; budget {BUDGET_S:.0f}s")

    # --- SpMV roofline (HEADLINE lane 1) at 8.4M DOF: ~300 MB working
    # set, far above the 50 MB L2, so every apply streams device memory
    rmat = _poisson_dia((256, 256, 128))
    rx = jnp.ones((rmat.shape[0],), jnp.float32)
    rmv = lambda x, m: spmv.spmv(m, x)
    r = roofline.measure_chained(
        rmv, rx, warmup=3, target_seconds=1.5, operands=(rmat,),
        bytes_moved=roofline.spmv_bytes(rmat),
        flops=roofline.spmv_flops(rmat))
    frac = r.fraction_of(peak)
    headline(f"SpMV Dia (n={rmat.shape[0]:,}), host clock: "
             f"{r.seconds * 1e6:.1f} µs, {r.gbps:.1f} GB/s = "
             f"{100 * frac:.1f}% of the {peak:.0f} GB/s published peak")
    k_dev = int(min(max(0.25 / r.seconds, 64), 4000))
    dev_s = roofline.measure_device_chained(rmv, rx, iters=k_dev,
                                            operands=(rmat,))
    if dev_s <= 0:
        raise RuntimeError("profiler capture had no device plane")
    # the copy is device-timed too, so this ratio has one clock on both sides
    copy = roofline.measure_copy_gbps()
    dev_gbps = roofline.spmv_bytes(rmat) / dev_s / 1e9
    headline(f"SpMV device-timeline ({k_dev} chained applies): "
             f"{dev_s * 1e6:.1f} µs/apply busy, {dev_gbps:.1f} GB/s = "
             f"{100 * dev_gbps / copy:.1f}% of a {copy:.0f} GB/s device copy")

    # --- CG solve (HEADLINE lane 2) at 1M, then 8.4M -------------------
    mat = _poisson_dia(dims)
    iters, tpi = _cg_lane("1M", mat, 0, 1000, peak)
    tpi_dof_ns = tpi * 1e9 / mat.shape[0]
    print(json.dumps({
        "metric": "cg_time_per_iter_per_dof",
        "value": tpi_dof_ns,
        "unit": "ns",
        "vs_baseline": frac / 0.80,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    if lane_ok("CG 8.4M", 90):
        _cg_lane("8.4M", rmat, 3, 2000, peak)
    del rmat

    # --- BASELINE.json config sweep (iteration counts; stderr only) ------
    if os.environ.get("OGL_BENCH_SWEEP", "1") != "0" and lane_ok("sweep", 60):
        _config_sweep()

    # --- large foam-path benches: per-step (update+solve) cost and the
    # preconditioned 1M cases (GKOCG+Multigrid, GKOGMRES+GISAI) ----------
    if os.environ.get("OGL_BENCH_LARGE", "1") != "0":
        _foam_large_benches(dims)

    print_summary()


def _poisson_dia(dims):
    """The 7-point Dirichlet-pinned Poisson DIA operator, constructed
    analytically (identical to coo_to_dia(ldu_to_coo(poisson_ldu(dims))) —
    pinned by tests — but seconds instead of minutes at 8M+ DOF)."""
    import jax.numpy as jnp
    import numpy as np

    from ogl_tpu.core import formats

    nx, ny, nz = dims
    n = nx * ny * nz
    i = np.arange(n)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    planes = []
    offsets = []
    for stride, coord, m in ((nx * ny, iz, nz), (nx, iy, ny), (1, ix, nx)):
        if m > 1:
            offsets.append(-stride)
            planes.append(np.where(coord != 0, -1.0, 0.0))
    offsets.append(0)
    planes.append(np.full(n, 2.0 * sum(m > 1 for m in (nx, ny, nz))))
    for stride, coord, m in ((1, ix, nx), (nx, iy, ny), (nx * ny, iz, nz)):
        if m > 1:
            offsets.append(stride)
            planes.append(np.where(coord != m - 1, -1.0, 0.0))
    order = np.argsort(offsets)
    data = np.stack([planes[k] for k in order]).astype(np.float32)
    return formats.Dia(data=jnp.asarray(data),
                       offsets=tuple(int(offsets[k]) for k in order),
                       shape=(n, n))


def _foam_large_benches(dims):
    """Foam-front-end benches at the headline size (reference printed-metric
    parity, lduLduBase.H:280-305): per-step steady-state cost, delta/bf16
    uploads, preconditioned large cases, dist + halo-exchange-on-hardware,
    f64 (single-device AND distributed), BiCGStab, ACG, GMRES bf16 basis.
    Each sub-lane is budget-gated.  All results go to stderr."""
    import dataclasses as dc

    from ogl_tpu import foam, registry
    from ogl_tpu import testing as problems

    if not lane_ok("foam benches (LDU build + first solve)", 60):
        return
    t0 = time.perf_counter()
    m = problems.poisson_ldu(dims)
    n = m.n
    rng = np.random.default_rng(1)
    b = rng.normal(size=n).astype(np.float32)
    log(f"foam benches: LDU build {time.perf_counter() - t0:.1f}s, n={n:,}")
    base = {"tolerance": 1e-6, "relTol": 0, "maxIter": 2000}

    # (a) per-step update+solve (GKOCG, default Coo format)
    registry.global_registry.clear()
    t0 = time.perf_counter()
    _, perf = foam.solve("benchStep", m, b, {"solver": "GKOCG", **base})
    log(f"per-step: first solve (init+compile+solve) {time.perf_counter() - t0:.1f}s, "
        f"iters={perf.n_iterations}")
    steps = []
    for i in range(3):
        m2 = dc.replace(m, upper=m.upper * (1.0 + 1e-7 * (i + 1)),
                        diag=m.diag * (1.0 + 1e-7 * (i + 1)))
        t0 = time.perf_counter()
        _, perf = foam.solve("benchStep", m2, b, {"solver": "GKOCG", **base})
        steps.append(time.perf_counter() - t0)
    headline(f"per-step (update+solve, steady state): "
             f"{min(steps) * 1e3:.1f} ms, iters={perf.n_iterations}, "
             f"{min(steps) * 1e9 / max(perf.n_iterations, 1) / n:.3f} "
             "ns/iter/DOF incl. coefficient update")
    slv = registry.global_registry.get_or_init("benchStep_solver", lambda: None)
    if slv is not None and getattr(slv, "last_timings", None):
        split = ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in sorted(slv.last_timings.items()))
        log(f"per-step phase split (dispatches are async, so the blocking "
            f"'solve' phase absorbs the queued host->device coefficient "
            f"upload): {split}")
    if slv is not None:
        dt = slv.time_device_solve()
        it = max(perf.n_iterations, 1)
        headline(f"per-step device-only solve (resident state, incl. one "
                 f"dispatch round trip): {dt * 1e3:.1f} ms, "
                 f"{dt * 1e6 / it:.1f} µs/iter, "
                 f"{dt * 1e9 / it / n:.4f} ns/iter/DOF")

    # delta-update steady state: only the DIAG changes (the transient-CFD
    # common case — fixed mesh + constant transport coefficients keep the
    # off-diagonal blocks constant while ddt terms move diag/RHS); the
    # per-block compare skips the unchanged uploads
    steps = []
    for i in range(3):
        m2 = dc.replace(m, diag=m.diag * (1.0 + 1e-7 * (i + 1)))
        t0 = time.perf_counter()
        _, perf = foam.solve("benchStep", m2, b, {"solver": "GKOCG", **base})
        steps.append(time.perf_counter() - t0)
    up = getattr(slv, "last_blocks_uploaded", None) if slv is not None else None
    headline(f"per-step diag-only change (delta upload {up}): "
             f"{min(steps) * 1e3:.1f} ms, iters={perf.n_iterations}")

    # (a') uploadPrecision bfloat16: the error-feedback bf16 delta encoding
    # of the coefficient/RHS streams — same transient nudges, half bytes
    if lane_ok("bf16 upload deltas", 45):
        registry.global_registry.clear()
        bf_controls = {"solver": "GKOCG", **base,
                       "uploadPrecision": "bfloat16"}
        foam.solve("benchBf16Up", m, b, bf_controls)
        steps = []
        for i in range(4):
            m2 = dc.replace(m, upper=m.upper * (1.0 + 1e-7 * (i + 1)),
                            diag=m.diag * (1.0 + 1e-7 * (i + 1)))
            t0 = time.perf_counter()
            _, perf = foam.solve("benchBf16Up", m2, b, bf_controls)
            steps.append(time.perf_counter() - t0)
        bslv = registry.global_registry.get_or_init(
            "benchBf16Up_solver", lambda: None)
        bf = getattr(bslv, "last_blocks_bf16", ("?", "?"))
        by = getattr(bslv, "last_upload_bytes", 0)
        headline(f"per-step with bf16 upload deltas: "
                 f"{min(steps[1:]) * 1e3:.1f} ms, "
                 f"iters={perf.n_iterations}, bf16 blocks {bf[0]}/{bf[1]}"
                 f", {by / 1e6:.1f} MB/step uploaded")

    # (b) GKOCG + Multigrid (precond TTL models the reference `caching` key)
    if lane_ok("GKOCG+Multigrid", 60):
        amg_controls = {"solver": "GKOCG", **base,
                        "preconditioner": {"preconditioner": "Multigrid",
                                           "caching": 30}}
        t0 = time.perf_counter()
        _, perf = foam.solve("benchAmg", m, b, amg_controls)
        log(f"GKOCG+Multigrid: first solve {time.perf_counter() - t0:.1f}s, "
            f"iters={perf.n_iterations}")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, perf = foam.solve("benchAmg", m, b, amg_controls)
            ts.append(time.perf_counter() - t0)
        headline(f"GKOCG+Multigrid steady: {min(ts) * 1e3:.1f} ms, "
                 f"iters={perf.n_iterations}, converged={perf.converged}")

    # (c) distributed solve over the available mesh (shard_map + psum; on a
    # one-device mesh the plan is empty, so this measures the dist program
    # WITHOUT halo traffic — the halo-exchange cost is measured in (c'))
    if lane_ok("dist GKOCG", 45):
        t0 = time.perf_counter()
        _, perf = foam.solve_distributed("benchDist", m, b,
                                         {"solver": "GKOCG", **base})
        log(f"dist GKOCG ({len(jax.devices())} device(s)): first solve "
            f"{time.perf_counter() - t0:.1f}s, iters={perf.n_iterations}")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, perf = foam.solve_distributed("benchDist", m, b, {})
            ts.append(time.perf_counter() - t0)
        headline(f"dist GKOCG steady: {min(ts) * 1e3:.1f} ms, "
                 f"iters={perf.n_iterations}, converged={perf.converged}")
        dslv = registry.global_registry.get_or_init(
            "benchDist_dist_solver", lambda: None)
        if dslv is not None:
            dt = dslv.time_device_solve()
            it = max(perf.n_iterations, 1)
            headline(f"dist device-only solve (resident state): "
                     f"{dt * 1e3:.1f} ms, {dt * 1e6 / it:.1f} µs/iter")

    # (c') halo-exchange hot path on the device
    if lane_ok("halo exchange on hardware", 90):
        _halo_hw_bench(dims)

    # (d) mixed-precision GKOIR: outer f32 Richardson, inner CG streaming a
    # bfloat16-packed operator (defect correction — converges to the f32
    # tolerance; the inner reads half the A bytes).  Compared against the unpreconditioned CG above.
    if lane_ok("GKOIR inner-bf16", 40):
        ir_controls = {"solver": "GKOIR", **base,
                       "inner": {"tolerance": 1e-2, "relTol": 0,
                                 "maxIter": 600, "precision": "bfloat16"}}
        t0 = time.perf_counter()
        _, perf = foam.solve("benchIrBf16", m, b, ir_controls)
        log(f"GKOIR inner-bf16: first solve {time.perf_counter() - t0:.1f}s, "
            f"outer iters={perf.n_iterations}")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, perf = foam.solve("benchIrBf16", m, b, ir_controls)
            ts.append(time.perf_counter() - t0)
        headline(f"GKOIR inner-bf16 steady: {min(ts) * 1e3:.1f} ms, "
                 f"outer iters={perf.n_iterations}, "
                 f"converged={perf.converged}, "
                 f"final={perf.final_residual:.2e}")

    # (d') THE f64 configuration: host-f64 defect correction around the
    # f32 device inner (foam/f64.py), batched sweeps.  Solves to a
    # residual level f32 cannot reach.  OpenFOAM double parity
    # (GKOCG.H:45-61).
    if lane_ok("f64 defect correction", 60):
        f64_controls = {"solver": "GKOCG", "tolerance": 0.0,
                        "relTol": 1e-12, "maxIter": 6000,
                        "dtype": "float64"}
        t0 = time.perf_counter()
        _, perf = foam.solve("benchF64", m, b, f64_controls)
        log(f"f64 defect-correction: first solve "
            f"{time.perf_counter() - t0:.1f}s, total inner "
            f"iters={perf.n_iterations}")
        ts = []
        for i in range(3):
            m2 = dc.replace(m, diag=m.diag * (1.0 + 1e-9 * (i + 1)))
            t0 = time.perf_counter()
            _, perf = foam.solve("benchF64", m2, b, f64_controls)
            ts.append(time.perf_counter() - t0)
        f64slv = registry.global_registry.get_or_init(
            "benchF64_solver", lambda: None)
        sweeps = getattr(f64slv, "last_outer_sweeps", -1)
        headline(f"f64 defect-correction steady (relTol 1e-12): "
                 f"{min(ts) * 1e3:.1f} ms/step, {sweeps} sweeps, "
                 f"total inner iters={perf.n_iterations}, final f64 "
                 f"residual {perf.final_residual:.2e}, "
                 f"converged={perf.converged}")

    # (d'') DISTRIBUTED f64: the same defect correction gated through
    # solve_distributed — f64 outer on host CSR, dist-f32 inner over the
    # mesh
    if lane_ok("distributed f64", 60):
        f64d_controls = {"solver": "GKOCG", "tolerance": 0.0,
                         "relTol": 1e-12, "maxIter": 6000,
                         "dtype": "float64"}
        t0 = time.perf_counter()
        _, perf = foam.solve_distributed("benchF64d", m, b, f64d_controls)
        log(f"dist f64 defect-correction: first solve "
            f"{time.perf_counter() - t0:.1f}s, total inner "
            f"iters={perf.n_iterations}")
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, perf = foam.solve_distributed("benchF64d", m, b,
                                             f64d_controls)
            ts.append(time.perf_counter() - t0)
        headline(f"dist f64 defect-correction steady (relTol 1e-12, "
                 f"{len(jax.devices())} device(s)): "
                 f"{min(ts) * 1e3:.1f} ms/step, total inner "
                 f"iters={perf.n_iterations}, final f64 residual "
                 f"{perf.final_residual:.2e}, converged={perf.converged}")

    # (e') GKOBiCGStab at the headline size: the BJ production config and
    # the unpreconditioned one
    if lane_ok("GKOBiCGStab", 90):
        for tag, controls in (
            ("BJ", {"solver": "GKOBiCGStab", **base,
                    "preconditioner": {"preconditioner": "BJ",
                                       "maxBlockSize": 1}}),
            ("none", {"solver": "GKOBiCGStab", **base}),
        ):
            registry.global_registry.clear()
            t0 = time.perf_counter()
            _, perf = foam.solve("benchBi", m, b, controls)
            first = time.perf_counter() - t0
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                _, perf = foam.solve("benchBi", m, b, controls)
                ts.append(time.perf_counter() - t0)
            bslv = registry.global_registry.get_or_init(
                "benchBi_solver", lambda: None)
            dt = (bslv.time_device_solve() if bslv is not None
                  else float("nan"))
            headline(f"GKOBiCGStab {tag} steady 1M: "
                     f"{min(ts) * 1e3:.1f} ms, iters={perf.n_iterations},"
                     f" device-only {dt * 1e3:.1f} ms "
                     f"({dt * 1e6 / max(perf.n_iterations, 1):.0f} "
                     f"µs/iter; first {first:.1f}s)")

    # (e'') coupled GKOACG: the 3-component multivector solve the reference
    # ships dead (aborting coupled ctor, HostMatrix.C:153-156)
    if lane_ok("GKOACG coupled", 40):
        nc = 3
        rngc = np.random.default_rng(7)
        bc = rngc.normal(size=(n, nc)).astype(np.float32)
        acg_controls = dict(base)  # GKOACG is its own entry point
        t0 = time.perf_counter()
        _, perfc = foam.solve_coupled("benchAcg", m, bc, acg_controls)
        log(f"GKOACG ({nc}-component coupled): first solve "
            f"{time.perf_counter() - t0:.1f}s, iters={perfc.n_iterations}")
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, perfc = foam.solve_coupled("benchAcg", m, bc, acg_controls)
            ts.append(time.perf_counter() - t0)
        headline(f"GKOACG steady: {min(ts) * 1e3:.1f} ms, "
                 f"iters={perfc.n_iterations}, "
                 f"converged={perfc.converged}")

    # (e) GKOGMRES + GISAI (+ bf16 basis variant)
    if lane_ok("GKOGMRES+GISAI", 80):
        gmres_controls = {"solver": "GKOGMRES", **base,
                          "preconditioner": {"preconditioner": "GISAI",
                                             "sparsityPower": 1, "caching": 30}}
        t0 = time.perf_counter()
        _, perf = foam.solve("benchGmres", m, b, gmres_controls)
        log(f"GKOGMRES+GISAI: first solve {time.perf_counter() - t0:.1f}s, "
            f"iters={perf.n_iterations}")
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, perf = foam.solve("benchGmres", m, b, gmres_controls)
            ts.append(time.perf_counter() - t0)
        headline(f"GKOGMRES+GISAI steady: {min(ts) * 1e3:.1f} ms, "
                 f"iters={perf.n_iterations}, converged={perf.converged}")
        it32, ms32 = perf.n_iterations, min(ts) * 1e3

        # basisPrecision bfloat16: the Krylov basis stream IS the GMRES
        # per-iteration cost at this size — bf16 storage halves it while
        # H, Givens, dots and x stay f32
        if lane_ok("GMRES bf16 basis", 40):
            registry.global_registry.clear()
            g16 = {**gmres_controls, "basisPrecision": "bfloat16"}
            foam.solve("benchGmres16", m, b, g16)
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                _, perf = foam.solve("benchGmres16", m, b, g16)
                ts.append(time.perf_counter() - t0)
            ms16 = min(ts) * 1e3
            headline(f"GKOGMRES+GISAI bf16 basis steady: {ms16:.1f} ms, "
                     f"iters={perf.n_iterations} (f32 basis: "
                     f"{ms32:.1f} ms, {it32} iters) -> ms/iter "
                     f"{ms16 / max(perf.n_iterations, 1):.2f} vs "
                     f"{ms32 / max(it32, 1):.2f}")


def _halo_hw_bench(dims):
    """Dist-CG with a NON-EMPTY halo plan on the available mesh (one
    device: self-neighbor d=0 class), vs the same operator with an empty
    plan (cyclic couplings as plain local columns).

    Cost AND parity are measured on PINNED-iteration runs (minIter =
    maxIter, tolerance 0): both variants execute identical trip counts and
    must land on the SAME final residual (trajectory parity — the halo
    representation is bit-rounding-close to the local one, verified off
    line to rel ~1e-7 per matvec).  A tolerance-stopped comparison at the
    f32 stagnation floor is NOT meaningful for parity: near the floor a
    one-ulp rounding difference flips the convergence decision and the
    iteration counts diverge wildly while both trajectories are equally
    converged.  Also runs the pipelined variant through the same plan."""
    from ogl_tpu import foam, registry
    from ogl_tpu import testing as problems

    t0 = time.perf_counter()
    ch = problems.channel_ldu(dims)
    n = ch.n
    rng = np.random.default_rng(5)
    b = rng.normal(size=n).astype(np.float32)
    log(f"halo-exchange bench: channel LDU build {time.perf_counter() - t0:.1f}s, "
        f"n={n:,}")
    pin = 200
    base = {"solver": "GKOCG", "tolerance": 0.0, "relTol": 0,
            "minIter": pin, "maxIter": pin}
    results = {}
    for tag, controls in (
        ("halo", {**base, "cyclicViaHalo": True}),
        ("halo-pipelined", {**base, "cyclicViaHalo": True,
                            "pipelinedCG": True}),
        ("local-cols", base),
    ):
        t0 = time.perf_counter()
        _, perf = foam.solve_distributed(f"benchHalo_{tag}", ch, b, controls)
        first = time.perf_counter() - t0
        slv = registry.global_registry.get_or_init(
            f"benchHalo_{tag}_dist_solver", lambda: None)
        dm = slv.assembler.dm
        dt = slv.time_device_solve()
        it = max(perf.n_iterations, 1)
        results[tag] = [it, dt, perf.final_residual, slv]
        route = ("affine (slices + lane matmuls)"
                 if dm.plan.send_affine is not None else "generic gather")
        log(f"halo-exchange {tag}: plan offsets {dm.plan.offsets} "
            f"({sum(dm.halo_sizes):,} halo entries, route: {route}), "
            f"{it} pinned iters, "
            f"final residual {perf.final_residual:.4e}, first {first:.1f}s, "
            f"device-only {dt * 1e3:.1f} ms ({dt * 1e6 / it:.1f} µs/iter, "
            f"{dt * 1e9 / it / n:.4f} ns/iter/DOF)")
        if tag.startswith("halo"):
            assert dm.plan.offsets, "halo bench built an empty plan"
    if "halo" in results and "local-cols" in results:
        # the exchange cost is a DIFFERENCE of two per-iteration figures
        # measured seconds apart: re-time both variants INTERLEAVED so any
        # drift hits them equally.
        for _ in range(2):
            for tag in ("halo", "local-cols"):
                results[tag][1] = min(results[tag][1],
                                      results[tag][3].time_device_solve())
        (it_h, dt_h, r_h, _s) = results["halo"]
        (it_l, dt_l, r_l, _s) = results["local-cols"]
        rel = abs(r_h - r_l) / max(abs(r_l), 1e-30)
        headline(f"halo-exchange on hw: parity after {pin} pinned iters — "
                 f"residuals {r_h:.4e} (halo) vs {r_l:.4e} (no-halo), "
                 f"rel {rel:.1e}; exchange cost "
                 f"{max(dt_h / it_h - dt_l / it_l, 0) * 1e6:.1f} µs/iter "
                 f"({dt_h / it_h * 1e6:.1f} vs {dt_l / it_l * 1e6:.1f} µs)")


def _config_sweep():
    """The BASELINE.json configs (small sizes; the parity metric is the
    iteration count, which is size- and tolerance-controlled):
      1. GKOCG unpreconditioned (the headline above, full size)
      2. GKOBiCGStab + BJ maxBlockSize>1
      3. GKOGMRES + GISAI, Ell format, adaptMinIter
      4. GKOCG + Multigrid (maxLevels 9, minCoarseRows 10)
      5. multi-rank halo SpMV — validated by __graft_entry__.dryrun_multichip
         on the virtual mesh."""
    from ogl_tpu import foam, registry
    from ogl_tpu import testing as problems

    registry.global_registry.clear()
    m = problems.poisson_ldu((48, 48))
    rng = np.random.default_rng(0)
    x_true = rng.normal(size=m.n)
    from ogl_tpu.core import ldu as _l

    a_coo = _l.ldu_to_coo_host(m)
    import scipy.sparse as sp_

    acsr = sp_.csr_matrix(
        (np.asarray(a_coo.vals), (np.asarray(a_coo.rows), np.asarray(a_coo.cols))),
        shape=a_coo.shape,
    )
    b = acsr @ x_true
    configs = [
        ("GKOBiCGStab+BJ8/Csr", {"solver": "GKOBiCGStab", "matrixFormat": "Csr",
                                 "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 8}}),
        ("GKOGMRES+GISAI/Ell", {"solver": "GKOGMRES", "matrixFormat": "Ell",
                                "adaptMinIter": True,
                                "preconditioner": {"preconditioner": "GISAI", "sparsityPower": 2}}),
        ("GKOCG+AMG/Csr", {"solver": "GKOCG", "matrixFormat": "Csr",
                           "preconditioner": {"preconditioner": "Multigrid",
                                              "maxLevels": 9, "minCoarseRows": 10}}),
    ]
    for name, extra in configs:
        controls = {"tolerance": 1e-6, "relTol": 0, "maxIter": 2000, **extra}
        x, perf = foam.solve(f"sweep_{name}", m, b, controls)
        err = float(np.abs(np.asarray(x) - x_true).max())
        # iteration parity vs the "reference executor" (BASELINE.md metric 3:
        # same systems solved on the CPU backend must take the same number
        # of iterations up to rounding-order effects)
        _, perf_cpu = foam.solve(f"sweepcpu_{name}", m, b,
                                 {**controls, "executor": "cpu"})
        headline(f"sweep {name}: iters={perf.n_iterations} "
                 f"(cpu executor: {perf_cpu.n_iterations}) "
                 f"converged={perf.converged} "
                 f"final={perf.final_residual:.2e} max|err|={err:.2e}")


if __name__ == "__main__":
    try:
        main()
    except Exception:
        print_summary()
        raise
