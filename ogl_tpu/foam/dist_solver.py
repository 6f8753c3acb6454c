"""Distributed foam solver — the reference's multi-rank path
(lduLduBase::solve_multi_gpu_impl, lduLduBase.H:189-308) as a per-field
persistent object over a jax.sharding.Mesh.

Construction mirrors the reference: per-rank LduMatrix systems with
processor interfaces (what decomposePar + the per-rank HostMatrix would
hold) become a DistMatrix once (DistAssembler); steady-state solves only
re-assemble coefficients on device and re-split b.  The mesh takes the
place of the MPI communicator; the solve itself is dist.dist_solve
(shard_map + ppermute halo rounds + psum reductions) with per-shard fast
local formats.  Preconditioning wraps the full local set — BJ, ILU/ILUT/IRILU, IC/ICT,
ISAI/GISAI, Multigrid — in additive Schwarz (dist.precond.build_schwarz —
reference Preconditioner.H:47-81),
with the same TTL caching as the single-device path
(Preconditioner.H:353-431).

Observability matches FoamSolver / the reference's printed metrics
(lduLduBase.H:280-305): per-solve statistics (time/iter, time/iter/DOF,
copy-back bandwidth), the OGL_Info banner, per-rank .mtx export under
processor<i>/<time>/ (common.C:31-58), and the measured residual-eval
relative cost feeding adaptMinIter (lduLduBase.H:287-293).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ogl_tpu import common, registry
from ogl_tpu.dist import runtime
from ogl_tpu.config import SolverConfig, parse_controls
from ogl_tpu.core import ldu as ldu_mod
from ogl_tpu.core import mtx
from ogl_tpu.core.formats import Coo
from ogl_tpu.dist.from_ranks import DistAssembler
from ogl_tpu.dist.partition import gather_global, split_vector
from ogl_tpu.dist.precond import build_schwarz
from ogl_tpu.dist.solve import dist_ops, shard_local_matrix
from ogl_tpu.foam.solver import SolverPerformance, _banner
from ogl_tpu.solve import stopping

__all__ = ["DistFoamSolver", "solve_distributed"]

class DistFoamSolver:
    """Per-field distributed solver over a mesh.

    ranks: list of per-rank LduMatrix (with ProcInterfaces), one per mesh
    device — or a single global LduMatrix, which is decomposed with
    ldu.decompose per the `decomposition` key: "simple" contiguous blocks
    or "scotch"/"bisect" graph bisection (reference integration matrix,
    test/integration.yaml:47-57).  Graph methods renumber cells; the
    permutation is applied to b/x0 on the way in and inverted on the way
    out, so callers see the original cell order."""

    def __init__(self, field_name: str, controls: dict | SolverConfig,
                 mesh: Mesh | None = None):
        self.field = field_name
        self.cfg = controls if isinstance(controls, SolverConfig) else parse_controls(controls)
        common.ensure_compilation_cache()
        if mesh is None:
            devs = jax.devices()
            mesh = Mesh(np.array(devs), ("x",))
        self.mesh = mesh
        self.n_parts = int(np.prod(mesh.devices.shape))
        self.assembler: DistAssembler | None = None
        self.props = registry.global_registry.properties(field_name)
        from ogl_tpu.foam.f64 import wants_host_f64

        if wants_host_f64(self.cfg):
            # a non-x64 process would silently truncate every jnp array to
            # f32 — the solve would REPORT float64 and deliver float32
            #.  The supported route is the defect
            # correction wrapper, which foam.solve_distributed builds.
            raise ValueError(
                "dtype float64 in a non-x64 process: route through "
                "foam.solve_distributed (host-f64 defect correction with a "
                "distributed f32 inner) or enable jax_enable_x64 for "
                "native-f64 XLA")
        self.dtype = jnp.dtype(self.cfg.dtype)
        self._precond = None
        self._compiled = {}  # cached jitted dist programs (per solver/path)
        self._pc_struct = None
        self._res_eval_time: float | None = None
        self._redispatch = None
        # graph decomposition state: (perm, bounds) once computed —
        # sparsity is constant across steps (HostMatrix.H:34), so the
        # partition is computed on the first solve and reused
        self._dec: tuple[np.ndarray, list[int]] | None = None

    def time_device_solve(self, reps: int = 3) -> float:
        """Wall-time of ONE re-dispatch of the last solve's compiled dist
        program on already-resident device state (no coefficient restaging,
        no b split/upload) — the honest 'solve' term of a steady-state
        step; see FoamSolver.time_device_solve."""
        if self._redispatch is None:
            raise RuntimeError("no solve has run yet")

        def run():
            jax.block_until_ready(self._redispatch())

        run()  # settle any queued work
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best

    def _ranks_of(self, m):
        if isinstance(m, ldu_mod.LduMatrix):
            if (self.n_parts == 1 and not m.proc_interfaces
                    and not (self.cfg.cyclic_via_halo
                             and m.local_interfaces)):
                # a 1-part decomposition is the matrix itself; skip the
                # (value-copying) decompose on every steady-state step
                return [m]
            meth = self.cfg.decomposition
            if meth != "simple":
                if self._dec is None:
                    self._dec = ldu_mod.partition_map(m, self.n_parts, meth)
                    if self.cfg.verbose > 0:
                        from ogl_tpu.core.graph import edge_cut

                        perm = self._dec[0]
                        owner = np.empty(m.n, np.int32)
                        owner[perm] = (np.searchsorted(
                            self._dec[1], np.arange(m.n), side="right") - 1)
                        simple = ldu_mod.partition_cells(m, self.n_parts,
                                                         "simple")
                        r = np.asarray(m.lower_addr)
                        c = np.asarray(m.upper_addr)
                        common.log(self.cfg.verbose, 0,
                                   f"{self.field}: decomposition {meth} "
                                   f"edge cut {edge_cut(r, c, owner)} "
                                   f"(simple: {edge_cut(r, c, simple)})")
                perm, bounds = self._dec
                return ldu_mod._decompose_blocks(
                    ldu_mod.renumber(m, perm), bounds,
                    self.cfg.cyclic_via_halo)
            return ldu_mod.decompose(
                m, self.n_parts, cyclic_via_halo=self.cfg.cyclic_via_halo)
        if self.cfg.decomposition != "simple":
            # same guard as _solve_multiproc: an already-decomposed list
            # cannot be re-partitioned, so a non-simple key is a
            # misconfiguration, not a silent no-op
            raise ValueError(
                "`decomposition` applies only when a GLOBAL system is handed "
                "to DistFoamSolver; callers providing already-decomposed "
                "per-rank systems must leave it 'simple' (decomposePar runs "
                "upstream)")
        return list(m)

    # -- preconditioner (Schwarz wrap + TTL, Preconditioner.H:47-81,353-431)
    def _update_precond(self, ranks):
        import dataclasses as _dc

        pc_cfg = self.cfg.precond
        name = pc_cfg.name
        if name == "none" and self.cfg.solver == "GKOMultigrid":
            # AMG-as-solver: Richardson around the Schwarz-AMG cycle (the
            # single-device GKOMultigrid mapping, foam/solver.py)
            pc_cfg = _dc.replace(pc_cfg, name="Multigrid")
            name = "Multigrid"
        if name == "none":
            self._precond = None
            return
        if (self._precond is not None
                and getattr(self, "_pc_built_epoch", None)
                == getattr(self, "_coeff_epoch", 0)):
            # operator bitwise unchanged since this Schwarz state was
            # factorised (per-(rank, block) delta bookkeeping): skip the
            # deterministic no-op regeneration regardless of TTL (cf.
            # FoamSolver._update_precond)
            return
        if self._precond is not None and self.props.precond_caching_left > 0:
            self.props.precond_caching_left -= 1
            return
        shards = self.assembler.shard_triples(ranks)
        self._precond = build_schwarz(
            pc_cfg, shards, self.assembler.dm.n_local,
            np.dtype(self.dtype),
        )
        self._pc_built_epoch = getattr(self, "_coeff_epoch", 0)
        self.props.precond_caching_left = pc_cfg.caching

    def _measure_res_eval(self, dm, x_stack, b_stack):
        """Time one distributed residual-norm evaluation (the criterion's
        per-check cost; reference lduLduBase.H:287-293).

        Chained inside ONE compiled program and measured as the difference
        of a 1-eval and a k-eval run, so the per-call dispatch latency
        cancels.  A single unchained call would measure the round trip,
        not the evaluation — overstating the check cost and stretching the
        adaptMinIter frequency until solves overshoot their convergence
        point."""

        def body(local, halo, x, b, k):
            local_m = shard_local_matrix(local, dm.n_local)
            ops = dist_ops(local_m, (halo.rows[0], halo.cols[0], halo.vals[0]),
                           dm.plan, dm.global_n, "x")

            def step(_, c):
                xv, s = c
                s = s + ops.allreduce(jnp.sum(jnp.abs(b[0] - ops.matvec(xv))))
                return xv * (1.0 - 1e-30 * s), s  # data-dependence: no DCE

            _, s = jax.lax.fori_loop(
                0, k, step, (x[0], jnp.zeros((), x_stack.dtype)))
            return s

        spec = P("x")
        fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(spec, spec, spec, spec, P()),
                                   out_specs=P(), check_vma=False))
        k = 129  # long chain: the extra-eval time must clear dispatch jitter

        def run(kk):
            float(fn(dm.local, dm.halo, x_stack, b_stack, kk))

        run(1)
        run(k)  # both trip counts warm (k is traced: one compile)
        t_short = t_long = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(1)
            t1 = time.perf_counter()
            run(k)
            t2 = time.perf_counter()
            t_short = min(t_short, t1 - t0)
            t_long = min(t_long, t2 - t1)
        return max(t_long - t_short, 1e-9) / (k - 1)

    def _export(self, ranks, b_stack, time_value):
        """Per-rank matrix/vector export (reference CsrMatrixWrapper.H:271-290,
        common.C:31-58: processor?/<time>/<field>_A_{local,non_local}.mtx)."""
        t = time_value if time_value is not None else "0"
        shards = self.assembler.shard_triples(ranks)
        dm = self.assembler.dm
        hrows = np.asarray(jax.device_get(dm.halo.rows))
        hcols = np.asarray(jax.device_get(dm.halo.cols))
        hvals = np.asarray(jax.device_get(dm.halo.vals))
        bs = np.asarray(jax.device_get(b_stack))
        for i, (rows, cols, vals) in enumerate(shards):
            n_i = dm.local_sizes[i]
            pre = f"processor{i}/{t}/{self.field}"
            mtx.write_coo(f"{pre}_A_local.mtx", Coo(
                rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=vals, shape=(n_i, n_i)))
            nh = dm.halo_sizes[i] if dm.halo_sizes else int(
                np.count_nonzero(hvals[i]))
            mtx.write_coo(f"{pre}_A_non_local.mtx", Coo(
                rows=hrows[i][:nh], cols=hcols[i][:nh], vals=hvals[i][:nh],
                shape=(n_i, dm.plan.halo_size)))
            mtx.write_dense(f"{pre}_b.mtx", bs[i, :n_i])
            # minimal sidecar beyond the reference format: the non-local
            # halo columns are recv-buffer slots that only resolve through
            # the communication pattern, which the reference never
            # serialises — without this the export cannot be replayed
            # (foam.case.read_exported_case)
            import json as _json

            with open(f"{pre}_comm.json", "w") as f:
                _json.dump([{"neighbor": int(pi.neighbor),
                             "n_faces": int(len(pi.face_cells))}
                            for pi in ranks[i].proc_interfaces], f)
            if self._dec is not None:
                # graph decomposition renumbered the cells: record each
                # rank's local→original-global cell map (OpenFOAM's
                # decomposePar writes the same thing as
                # cellProcAddressing) so exported systems can be mapped
                # back to the caller's field ordering
                perm, bounds = self._dec
                mtx.write_dense(f"{pre}_cellProcAddressing.mtx",
                                np.asarray(perm[bounds[i]:bounds[i + 1]],
                                           dtype=np.float64))

    def _export_multiproc(self, my_ranks, my_b, time_value):
        """Multi-process export: this process writes processor<r>/ for its
        own global ranks r (reference per-rank export, common.C:31-58),
        incl. the interface sidecar foam.case needs for replay."""
        import json as _json

        t = time_value if time_value is not None else "0"
        asm = self.assembler
        dm = asm.dm
        shards = asm.local_shard_triples(my_ranks)
        halo_by_idx = {}
        for leaf_name in ("rows", "cols", "vals"):
            for shard in getattr(dm.halo, leaf_name).addressable_shards:
                i = (shard.index[0].start
                     if isinstance(shard.index[0], slice) else shard.index[0])
                halo_by_idx.setdefault(int(i), {})[leaf_name] = np.asarray(
                    shard.data)[0]
        for k, (gi, m) in enumerate(zip(asm.my_idx, my_ranks)):
            n_i = dm.local_sizes[gi]
            pre = f"processor{gi}/{t}/{self.field}"
            rows, cols, vals = shards[k]
            mtx.write_coo(f"{pre}_A_local.mtx", Coo(
                rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=vals, shape=(n_i, n_i)))
            nh = dm.halo_sizes[gi]
            h = halo_by_idx[gi]
            mtx.write_coo(f"{pre}_A_non_local.mtx", Coo(
                rows=h["rows"][:nh].astype(np.int32),
                cols=h["cols"][:nh].astype(np.int32),
                vals=h["vals"][:nh], shape=(n_i, dm.plan.halo_size)))
            b_i = np.asarray(my_b[k])[:n_i]
            if self.cfg.scaling != 1.0:  # export the scaled b (parity with
                b_i = b_i * self.cfg.scaling  # the single-controller path)
            mtx.write_dense(f"{pre}_b.mtx", b_i)
            with open(f"{pre}_comm.json", "w") as f:
                _json.dump([{"neighbor": int(pi.neighbor),
                             "n_faces": int(len(pi.face_cells))}
                            for pi in m.proc_interfaces], f)

    def solve(self, m, b, psi=None, time_value: str | None = None):
        if jax.process_count() > 1:
            return self._solve_multiproc(m, b, psi, time_value)
        cfg = self.cfg
        ranks = self._ranks_of(m)
        _banner(cfg, self.field, self.mesh.devices.ravel()[0])
        if self.assembler is None:
            with common.timed("init_dist_matrix", cfg.verbose, self.field):
                self.assembler = DistAssembler(
                    ranks, dtype=np.dtype(self.dtype),
                    local_format=cfg.dist_local_format,
                    scale=cfg.scaling,
                )
            self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1
        elif cfg.update_sys_matrix:
            with common.timed("update_dist_values", cfg.verbose, self.field):
                self.assembler.update(ranks)
            if self.assembler.last_blocks_changed[0] > 0:
                self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1
        dm = self.assembler.dm
        self._update_precond(ranks)

        b_host = np.asarray(b)
        if self._dec is not None:
            # graph decomposition renumbered the cells part-contiguously;
            # bring the RHS into the same order (undone on x below)
            b_host = b_host[self._dec[0]]
        if cfg.scaling != 1.0:
            # scale b alongside the matrix (reference lduLduBase.H:244-252)
            # so the solution is invariant under `scaling`
            b_host = b_host * np.asarray(cfg.scaling, self.dtype)
        prev = getattr(self, "_b_prev", None)
        if (prev is not None and getattr(self, "_bs_dev", None) is not None
                and prev.shape == b_host.shape
                and np.array_equal(prev, b_host)):
            bs = self._bs_dev  # delta: unchanged RHS stays resident
            self.last_rhs_uploaded = False
        else:
            bs = jnp.asarray(split_vector(dm, b_host), self.dtype)
            self._bs_dev = bs
            self._b_prev = np.array(b_host)  # private compare baseline
            self.last_rhs_uploaded = True
        if psi is not None and cfg.update_init_guess:
            psi_host = np.asarray(psi)
            if self._dec is not None:
                psi_host = psi_host[self._dec[0]]
            x0 = jnp.asarray(split_vector(dm, psi_host), self.dtype)
        else:
            x0 = jnp.zeros_like(bs)

        stopping_cfg = cfg.stopping.adapted(
            self.props.prev_solve_iters, self.props.prev_rel_res_cost, cfg.export
        )
        sp = stopping.StoppingParams.of(stopping_cfg)

        # preconditioner structure change invalidates cached programs (the
        # compiled closure captures the apply fn; fresh state of the SAME
        # structure reuses it — the FoamSolver._compiled design)
        pc_struct = None
        if self._precond is not None:
            pc_struct = str(jax.tree_util.tree_structure(self._precond[1]))
        if pc_struct != self._pc_struct:
            self._compiled.clear()
            self._pc_struct = pc_struct

        t0 = time.perf_counter()
        known = ("GKOCG", "GKOBiCGStab", "GKOGMRES", "GKOIR",
                 "GKOMultigrid")
        if cfg.solver not in known:
            raise ValueError(
                f"unknown solver {cfg.solver!r}; valid: {known}")
        # GKOMultigrid = Richardson around the (Schwarz) AMG cycle,
        # exactly the single-device mapping
        solver_name = "GKOIR" if cfg.solver == "GKOMultigrid" else cfg.solver
        if solver_name == "GKOCG" and cfg.pipelined_cg:
            solver_name = "GKOPipeCG"  # single-reduction variant
        hist_len = (cfg.stopping.max_iter + cfg.stopping.frequency
                    if cfg.export else 0)
        inner_params = (stopping.StoppingParams.of(cfg.inner_stopping)
                        if cfg.solver == "GKOIR"
                        and cfg.inner_stopping is not None else None)
        bdt = (jnp.bfloat16 if cfg.basis_precision == "bfloat16"
               and self.dtype == jnp.float32 else None)
        key = ("general", solver_name, hist_len > 0,
               inner_params is not None, bdt is not None)
        if key not in self._compiled:
            from ogl_tpu.dist.solve import make_dist_solve_fn

            self._compiled[key] = make_dist_solve_fn(
                dm, self.mesh, solver=solver_name,
                pc_apply=self._precond[0] if self._precond else None,
                krylov_dim=cfg.krylov_dim, history_len=hist_len,
                inner_params=inner_params,
                inner_precision=cfg.inner_precision, basis_dtype=bdt)
        _fn, _pcs = self._compiled[key], (
            self._precond[1] if self._precond else ())
        x_stack, res = _fn(dm.local, dm.halo, bs, x0, sp, _pcs)
        self._redispatch = lambda: _fn(
            dm.local, dm.halo, bs, x0, sp, _pcs)[0]
        # one batched scalar fetch, inside the timed window: avoids
        # per-scalar round trips and covers execution
        _it, _irn, _frn, _cv = jax.device_get(
            (res.iters, res.init_res_norm, res.final_res_norm, res.converged))
        solve_t = time.perf_counter() - t0
        iters = int(np.asarray(_it).ravel()[0])
        time_per_iter = solve_t / max(iters, 1)
        if self._res_eval_time is None:
            self._res_eval_time = self._measure_res_eval(dm, x_stack, bs)
        # every process must feed the SAME adaptMinIter inputs into the
        # (replicated) StoppingParams next solve — agree on process-0's
        # measured cost ratio (reference broadcast, lduLduBase.H:291-293)
        (rel_cost,) = runtime.broadcast_scalars(
            time_per_iter / self._res_eval_time)
        self.props.prev_rel_res_cost = rel_cost
        self.props.prev_solve_iters = iters

        t1 = time.perf_counter()
        x = gather_global(dm, x_stack)
        if self._dec is not None:
            # x_new = x_old[perm]  ⇒  x_old[perm] = x_new
            xo = np.empty_like(x)
            xo[self._dec[0]] = x
            x = xo
        copy_t = max(time.perf_counter() - t1, 1e-9)

        if cfg.verbose > 0:
            n = dm.global_n
            print(
                "\nStatistics:\n"
                f"\tTime per iteration: {time_per_iter * 1e6:.3f} [mu s]\n"
                f"\tTime per residual norm calculation: {self._res_eval_time * 1e6:.3f} [mu s]\n"
                f"\tTime per iteration and DOF: {time_per_iter * 1e9 / n:.3f} [ns]\n"
                f"\tRetrieve results bandwidth "
                f"{np.dtype(self.dtype).itemsize * n / copy_t / 1e9:.3g} [GByte/s]"
            )
        if cfg.export or cfg.debug:
            self._export(ranks, bs, time_value)
            if getattr(res, "history", None) is not None:
                hist = np.asarray(jax.device_get(res.history))[: max(iters, 1)]
                t = time_value if time_value is not None else "0"
                for i in range(self.n_parts):
                    mtx.write_dense(
                        f"processor{i}/{t}/{self.field}_residuals.mtx", hist)

        perf = SolverPerformance(
            solver_name=f"{cfg.solver}_dist{self.n_parts}",
            field_name=self.field,
            initial_residual=float(np.asarray(_irn).ravel()[0]),
            final_residual=float(np.asarray(_frn).ravel()[0]),
            n_iterations=iters,
            converged=bool(np.asarray(_cv).ravel()[0]),
        )
        return x, perf


    def _solve_multiproc(self, my_ranks, my_b, psi, time_value=None):
        """True multi-process solve (the reference's per-MPI-rank deployment
        shape): this process contributes only ITS mesh devices' LduMatrix
        systems and RHS pieces; global structure flows through the small
        metadata allgather inside MultiProcAssembler.  Returns (xs, perf)
        where xs is the list of this process's per-rank solutions.

        The full Schwarz preconditioner set is supported: each process
        factorises its own shards and the stacked state's data-dependent
        static shapes are unified across processes through the
        structure-agreement hook (dist.multiproc.build_schwarz_mp)."""
        from ogl_tpu.dist.multiproc import MultiProcAssembler

        cfg = self.cfg
        if not isinstance(my_ranks, (list, tuple)):
            raise TypeError(
                "multi-process solves take a list of this process's per-rank "
                "LduMatrix systems (one per locally-owned mesh device)")
        if cfg.decomposition != "simple":
            raise ValueError(
                "`decomposition` applies only when a GLOBAL system is handed "
                "to DistFoamSolver; multi-process callers provide already-"
                "decomposed per-rank systems (decomposePar runs upstream)")
        my_ranks = list(my_ranks)
        if self.assembler is None:
            with common.timed("init_dist_matrix_mp", cfg.verbose, self.field):
                self.assembler = MultiProcAssembler(
                    my_ranks, self.mesh, dtype=np.dtype(self.dtype),
                    local_format=cfg.dist_local_format, scale=cfg.scaling)
            self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1
        elif cfg.update_sys_matrix:
            with common.timed("update_dist_values_mp", cfg.verbose, self.field):
                self.assembler.update(my_ranks)
            # last_update_staged is allgather-AGREED (multiproc.py): every
            # process sees the same flag, so the epoch (and the precond
            # skip below) cannot diverge across processes
            if self.assembler.last_update_staged:
                self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1
        asm = self.assembler
        dm = asm.dm

        if not isinstance(my_b, (list, tuple)):
            raise TypeError("multi-process solves take a list of per-rank b")
        scale = cfg.scaling
        bs = asm.stage_vector([
            np.asarray(v) * np.asarray(scale, self.dtype) if scale != 1.0
            else np.asarray(v) for v in my_b])
        if psi is not None and cfg.update_init_guess:
            x0 = asm.stage_vector([np.asarray(v) for v in psi])
        else:
            x0 = jnp.zeros_like(bs)

        pc_cfg = self.cfg.precond
        if pc_cfg.name == "none" and self.cfg.solver == "GKOMultigrid":
            import dataclasses as _dc

            pc_cfg = _dc.replace(pc_cfg, name="Multigrid")
        if pc_cfg.name == "none":
            self._precond = None
        elif (self._precond is not None
                and getattr(self, "_pc_built_epoch", None)
                == getattr(self, "_coeff_epoch", 0)):
            # operator bitwise unchanged since factorisation (collective
            # last_update_staged flag): regeneration is a deterministic
            # no-op — skip it on every process alike
            pass
        elif self._precond is not None and self.props.precond_caching_left > 0:
            self.props.precond_caching_left -= 1
        else:
            from ogl_tpu.dist.multiproc import build_schwarz_mp

            self._precond = build_schwarz_mp(
                pc_cfg, asm.local_shard_triples(my_ranks), dm.n_local,
                np.dtype(self.dtype), self.mesh, len(my_ranks))
            self._pc_built_epoch = getattr(self, "_coeff_epoch", 0)
            self.props.precond_caching_left = pc_cfg.caching

        stopping_cfg = cfg.stopping.adapted(
            self.props.prev_solve_iters, self.props.prev_rel_res_cost,
            cfg.export)
        sp = stopping.StoppingParams.of(stopping_cfg)

        pc_struct = None
        if self._precond is not None:
            pc_struct = str(jax.tree_util.tree_structure(self._precond[1]))
        if pc_struct != self._pc_struct:
            self._compiled.clear()
            self._pc_struct = pc_struct

        t0 = time.perf_counter()
        inner_params = (stopping.StoppingParams.of(cfg.inner_stopping)
                        if cfg.solver == "GKOIR"
                        and cfg.inner_stopping is not None else None)
        bdt = (jnp.bfloat16 if cfg.basis_precision == "bfloat16"
               and self.dtype == jnp.float32 else None)
        key = ("general", cfg.solver, False, inner_params is not None,
               bdt is not None)
        if key not in self._compiled:
            from ogl_tpu.dist.solve import make_dist_solve_fn

            solver_name = ("GKOIR" if cfg.solver == "GKOMultigrid"
                           else cfg.solver)
            if solver_name == "GKOCG" and cfg.pipelined_cg:
                solver_name = "GKOPipeCG"  # single-reduction variant
            self._compiled[key] = make_dist_solve_fn(
                dm, self.mesh, solver=solver_name,
                pc_apply=self._precond[0] if self._precond else None,
                krylov_dim=cfg.krylov_dim, history_len=0,
                inner_params=inner_params,
                inner_precision=cfg.inner_precision, basis_dtype=bdt)
        _fn, _pcs = self._compiled[key], (
            self._precond[1] if self._precond else ())
        x_stack, res = _fn(dm.local, dm.halo, bs, x0, sp, _pcs)
        # SPMD: every process must call time_device_solve together
        self._redispatch = lambda: _fn(
            dm.local, dm.halo, bs, x0, sp, _pcs)[0]
        _it, _irn, _frn, _cv = jax.device_get(
            (res.iters, res.init_res_norm, res.final_res_norm, res.converged))
        solve_t = time.perf_counter() - t0
        iters = int(np.asarray(_it).ravel()[0])
        time_per_iter = solve_t / max(iters, 1)
        if self._res_eval_time is None:
            self._res_eval_time = self._measure_res_eval(dm, x_stack, bs)
        (rel_cost,) = runtime.broadcast_scalars(
            time_per_iter / self._res_eval_time)
        self.props.prev_rel_res_cost = rel_cost
        self.props.prev_solve_iters = iters

        if cfg.export or cfg.debug:
            # per-rank export, each process writing ITS ranks' files — the
            # reference's per-MPI-rank export semantics (common.C:31-58)
            self._export_multiproc(my_ranks, my_b, time_value)

        # this process's solutions, in its mesh-device order
        by_idx = {}
        for shard in x_stack.addressable_shards:
            i = (shard.index[0].start
                 if isinstance(shard.index[0], slice) else shard.index[0])
            by_idx[int(i)] = np.asarray(shard.data).reshape(-1)
        xs = [by_idx[i][: dm.local_sizes[i]] for i in asm.my_idx]

        perf = SolverPerformance(
            solver_name=f"{cfg.solver}_mp{jax.process_count()}x{self.n_parts}",
            field_name=self.field,
            initial_residual=float(np.asarray(_irn).ravel()[0]),
            final_residual=float(np.asarray(_frn).ravel()[0]),
            n_iterations=iters,
            converged=bool(np.asarray(_cv).ravel()[0]),
        )
        return xs, perf


def solve_distributed(field_name: str, m, b, controls, mesh=None, psi=None,
                      time_value: str | None = None):
    """Registry-cached distributed solve (cf. foam.solve).  `dtype float64`
    in a non-x64 process routes to the host-f64 defect correction with a
    DISTRIBUTED f32 inner (foam/f64.py) — without the gate a distributed
    float64 request would silently downcast to f32 (reference parity:
    Ginkgo runs native double through the distributed path,
    GKOCG.H:45-61, CsrMatrixWrapper.H:163-210)."""

    def _make():
        cfg = (controls if isinstance(controls, SolverConfig)
               else parse_controls(controls))
        from ogl_tpu.foam.f64 import (F64DefectSolver, _inner_config,
                                      wants_host_f64)

        if wants_host_f64(cfg):
            inner = DistFoamSolver(field_name + "%f64inner",
                                   _inner_config(cfg), mesh)
            return F64DefectSolver(field_name, cfg, inner=inner)
        return DistFoamSolver(field_name, controls, mesh)

    solver = registry.global_registry.get_or_init(
        f"{field_name}_dist_solver", _make)
    return solver.solve(m, b, psi=psi, time_value=time_value)
