"""The OpenFOAM-facing solver layer — GKOCG/GKOBiCGStab/GKOGMRES/GKOIR/
GKOMultigrid, orchestrated like the reference's lduLduBase
(lduLduBase/lduLduBase.H:189-333) but as one persistent object per field:

  first solve:   sparsity build → device format → preconditioner →
                 compiled solve program            (cache everything)
  steady state:  coefficient gather → (TTL-gated precond regen) →
                 reuse compiled program            (reference SURVEY §3.2)

Differences by design: single-device solves are supported (the reference
aborts unless MPI-parallel, lduLduBase.H:321-329 — SURVEY Appendix B says
not to replicate); multi-device goes through ogl_tpu.dist instead of MPI.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu import __version__ as _version
from ogl_tpu import common, precond, registry
from ogl_tpu.config import SolverConfig, parse_controls
from ogl_tpu.core import formats, ldu, mtx
from ogl_tpu.kernels import spmv
from ogl_tpu.solve import bicgstab, cg, gmres, ir
from ogl_tpu.solve import stopping
from ogl_tpu.solve.krylov import single_device_ops

__all__ = ["SolverPerformance", "FoamSolver", "solve", "SOLVER_NAMES"]

SOLVER_NAMES = ("GKOCG", "GKOBiCGStab", "GKOGMRES", "GKOIR", "GKOMultigrid")

@jax.jit
def _apply_delta(dev, delta):
    """Decode an uploaded reduced-precision delta onto the resident copy
    (uploadPrecision bfloat16; one fused widen+add on device)."""
    return dev + delta.astype(dev.dtype)


def _to_xell(c):
    from ogl_tpu.kernels.xell import xell_from_coo

    return xell_from_coo(c)


def _to_gdia(c):
    from ogl_tpu.kernels.gdia import gdia_from_coo

    return gdia_from_coo(c)


def _to_device_coo(c):
    return formats.Coo(rows=jnp.asarray(c.rows), cols=jnp.asarray(c.cols),
                       vals=jnp.asarray(c.vals), shape=c.shape)


_FORMAT_CONVERTERS = {
    "Coo": _to_device_coo,
    "Csr": formats.coo_to_csr,
    "Ell": formats.coo_to_ell,
    "Dia": formats.coo_to_dia,
    "Sell": formats.coo_to_sell,
    "Gdia": _to_gdia,
    "Hybrid": formats.coo_to_hybrid,
    "Xell": _to_xell,
}

_banner_shown: set[str] = set()


@jax.jit  # module-level: one compile per matrix STRUCTURE, shared across
def _res_eval_chain(mat, x, b, k):  # fields/instances (a method-local jit
    """k chained residual-norm evaluations (the stopping criterion's
    per-check cost, timed for adaptMinIter — lduLduBase.H:287-293).  The
    matrix rides as a traced pytree so every field with the same format
    reuses one compiled program."""
    mv = spmv.matvec(mat)

    def body(_, c):
        xv, s = c
        return xv * (1.0 - 1e-30 * s), s + jnp.abs(b - mv(xv)).sum()

    _, s = jax.lax.fori_loop(0, k, body, (x, jnp.zeros((), x.dtype)))
    return s


class SolverPerformance(NamedTuple):
    """What OpenFOAM's solverPerformance reports back into the log."""

    solver_name: str
    field_name: str
    initial_residual: float
    final_residual: float
    n_iterations: int
    converged: bool

    def print(self):  # OpenFOAM log line format
        print(
            f"{self.solver_name}:  Solving for {self.field_name}, "
            f"Initial residual = {self.initial_residual:g}, "
            f"Final residual = {self.final_residual:g}, "
            f"No Iterations {self.n_iterations}"
        )


# the reference's executor names (ExecutorHandler.H:128) -> jax platform;
# `None` (no executor key) is JAX's default device, which JAX_PLATFORMS
# selects (tests pin it to the CPU)
_EXECUTOR_PLATFORMS = {"reference": "cpu", "omp": "cpu", "cpu": "cpu",
                       "cuda": "gpu"}


def _device_for(executor: str | None):
    """The device an `executor` keyword names.  An explicit accelerator
    executor never falls back to the CPU: it raises when JAX has no such
    device."""
    if executor is None:
        return jax.devices()[0]
    if executor == "tpu":
        raise ValueError(
            "executor 'tpu' is not supported: the accelerator is an NVIDIA "
            "GPU — use executor 'cuda' (or omit the key for JAX's default "
            "device)")
    platform = _EXECUTOR_PLATFORMS.get(executor)
    if platform is None:
        raise ValueError(
            f"unknown executor {executor!r}; use one of "
            f"{sorted(_EXECUTOR_PLATFORMS)} or omit the key")
    try:
        return jax.devices(platform)[0]
    except RuntimeError as e:
        raise RuntimeError(
            f"executor '{executor}' needs a jax '{platform}' device, which "
            f"this process does not have; available: "
            f"{sorted({d.platform for d in jax.devices()})}"
        ) from e


def _git_rev() -> str:
    """Build/version stamping (reference cmake/version.cmake surfaces the
    git rev in the OGL_Info banner)."""
    import subprocess

    try:
        return subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _banner(cfg: SolverConfig, field: str, device):
    if field in _banner_shown or cfg.verbose <= 0:
        return
    _banner_shown.add(field)
    print(
        f"OGL on {device.platform.upper()}\n"
        f"  version:       {_version} ({_git_rev()})\n"
        f"  jax:           {jax.__version__}\n"
        f"  backend:       {jax.default_backend()}\n"
        f"  device:        {device.device_kind}\n"
        f"  matrix format: {cfg.matrix_format}\n"
        f"  dtype:         {cfg.dtype}\n"
        f"  executor:      {cfg.executor}"
    )
    if cfg.debug:
        # debugger-attach aid (reference writes /tmp/mpi_debug_<rank>.pid and
        # sleeps 20 s, lduLduBase.H:97-109; we write the pid, no sleep)
        with open(f"ogl_debug_{jax.process_index()}.pid", "w") as f:
            f.write(str(os.getpid()))


class FoamSolver:
    """Per-field persistent solver (the lduLduBase + DevicePersistent
    machinery in one object; stored in the global registry by field name)."""

    def __init__(self, field_name: str, controls: dict | SolverConfig):
        self.field = field_name
        self.cfg = controls if isinstance(controls, SolverConfig) else parse_controls(controls)
        common.ensure_compilation_cache()
        self.device = _device_for(self.cfg.executor)
        self.dtype = jnp.dtype(self.cfg.dtype)
        self.sparsity: ldu.LduSparsity | None = None
        self.matrix = None
        self._reorder = None
        self._value_map = None
        self._block_plans = None  # per-block incremental update plans
        self._incr_fns = {}       # changed-index-set -> jit'd block update
        self._coo_host_cache = None
        self._src_host = None
        self._blocks_host = None  # raw LDU source blocks of the last update
        self._blocks_prev = None  # private copies backing the delta compare
        self._blocks_dev = None   # HBM-resident per-block uploads
        self._blocks_stale = None  # device copy out of date vs host values
        self._precond_op = None
        self._compiled = {}
        self._res_eval_time: float | None = None
        self._redispatch = None
        # opt-in (F64DefectSolver): fetch res.x in the SAME device_get as
        # the stats scalars — callers that always copy the solution back
        # save one host round trip per solve
        self._fetch_x_with_stats = False
        self.last_x_host = None
        self.props = registry.global_registry.properties(field_name)
        self.timings = common.Timings()

    # -- matrix ---------------------------------------------------------
    def _convert(self, coo):
        """Host COO -> the device format `matrixFormat` names."""
        fmt = self.cfg.matrix_format
        self._fmt_used = fmt
        return _FORMAT_CONVERTERS[fmt](coo)

    def _update_matrix(self, m: ldu.LduMatrix):
        first = self.sparsity is None
        if first:
            with common.timed("init_host_sparsity", self.cfg.verbose, self.field, self.timings):
                self.sparsity = ldu.build_local_sparsity(m)
            if self.cfg.reorder == "rcm":
                # bandwidth-reducing renumbering (renumberMesh analogue);
                # vectors are permuted host-side at solve entry/exit
                from ogl_tpu.core.reorder import rcm_permutation

                coo0 = formats.Coo(
                    rows=self.sparsity.rows, cols=self.sparsity.cols,
                    vals=np.zeros(self.sparsity.nnz, np.float32), shape=(m.n, m.n),
                )
                perm = rcm_permutation(coo0)
                inv = np.empty(m.n, np.int64)
                inv[perm] = np.arange(m.n)
                rp = inv[self.sparsity.rows]
                cp = inv[self.sparsity.cols]
                entry_order = np.lexsort((cp, rp))
                self._reorder = (
                    perm, inv,
                    rp[entry_order].astype(np.int32),
                    cp[entry_order].astype(np.int32),
                    entry_order.astype(np.int64),
                )
            elif self.cfg.reorder != "none":
                raise ValueError(f"unknown reorder {self.cfg.reorder!r}; use none|rcm")
            else:
                self._reorder = None
        if first or self.cfg.update_sys_matrix:
            with common.timed("update_local_matrix", self.cfg.verbose, self.field, self.timings):
                # the raw LDU blocks stay SPLIT (the reference bulk-copies
                # them contiguously, HostMatrix.C:684-692): the steady-state
                # device path uploads only blocks whose values changed, and
                # host consumers concat lazily (src_host); the row-major
                # gather happens where the values are consumed
                self._blocks_host = ldu._host_blocks(self.sparsity, m, self.dtype)
                self._src_host = None  # lazy concat for host consumers
                self._coo_host_cache = None  # invalidate lazy host values
                self._n = m.n
            if first or self.matrix is None or self.cfg.regenerate:
                self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1
                # seed the host-change baseline NOW (private copies): the
                # next solve's epoch/precond gating can then see an
                # unchanged operator even before the device-block delta
                # machinery has staged anything
                self._blocks_prev = [np.array(b) for b in self._blocks_host]
                self._blocks_dev = [None] * len(self._blocks_host)
                # `regenerate` forces a full rebuild every solve (reference
                # CsrMatrixWrapper.H:76-86)
                with common.timed("convert_format", self.cfg.verbose, self.field, self.timings):
                    self.matrix = self._convert(self.coo_host())
            else:
                # steady state: upload the RAW source blocks (smaller than
                # the assembled array — symmetric matrices share upper/
                # lower) and run gather + scatter on device: one upload +
                # two jit'd ops for ANY format (the reference's in-place
                # device value overwrite, CsrMatrixWrapper.H:74-136)
                if self._value_map is None:
                    c = self.coo_host()
                    self._value_map = formats.value_map(self.matrix, c.rows, c.cols)
                    self._permute_dev = jnp.asarray(self.sparsity.permute)
                    self._entry_order_dev = (
                        jnp.asarray(self._reorder[4])
                        if self._reorder is not None else None)
                    # incremental per-block plans: a step that changes only
                    # SOME blocks (transient CFD: diag/RHS carry the time
                    # step, off-diagonals are fixed-mesh constants) then
                    # overwrites just those entries instead of re-gathering
                    # all nnz: O(n_changed) instead of O(nnz) device work
                    perm2 = np.asarray(self.sparsity.permute)
                    if self._reorder is not None:
                        perm2 = perm2[self._reorder[4]]
                    self._block_plans = formats.block_update_plans(
                        self._value_map, perm2,
                        [b.size for b in self._blocks_host])
                with common.timed("update_device_values", self.cfg.verbose,
                                  self.field, self.timings):
                    changed = self._detect_changed_blocks()
                    nb = len(self._blocks_host)
                    if (self._block_plans is not None
                            and 0 < len(changed) < nb):
                        # partial change: touch only the changed blocks'
                        # container entries (unchanged blocks stay unstaged)
                        blocks_dev = self._stage_blocks(changed)
                        self.matrix = self._apply_block_updates(
                            changed, blocks_dev)
                    else:
                        blocks_dev = self._stage_blocks(range(nb))
                        vals_dev = ldu._assemble_from_blocks(
                            blocks_dev, self._permute_dev,
                            jnp.asarray(self.cfg.scaling, self.dtype))
                        if self._entry_order_dev is not None:
                            vals_dev = jnp.take(
                                vals_dev, self._entry_order_dev, axis=0)
                        self.matrix = self._value_map.update(
                            self.matrix, vals_dev)
                if self.last_blocks_changed[0] > 0:
                    self._coeff_epoch = getattr(self, "_coeff_epoch", 0) + 1

    # (see ARCHITECTURE.md "Data flow (steady state)": a partial-change
    # step routes through _apply_block_updates instead of the full
    # assemble — the LDU diag onto a DIA main plane is one slice write)

    def src_host(self) -> np.ndarray:
        """The concatenated raw LDU source vector of the LAST update (lazy:
        host consumers — format conversion, factorisation, export — pay the
        concat only when they actually read values)."""
        if self._src_host is None:
            b = self._blocks_host
            self._src_host = np.concatenate(b) if len(b) > 1 else np.asarray(b[0])
        return self._src_host

    def _bf16_delta(self, new_f32: np.ndarray, mirror):
        """Error-feedback bf16 delta encoding (uploadPrecision bfloat16):
        quantise (new − mirror) to bf16 and advance the mirror by the SAME
        quantised value the device will add, so host and device stay
        bit-identical and quantisation error never accumulates — it is
        bounded by the bf16 quantum of the LAST delta.  Returns
        (delta_bf16, new_mirror) or None when the residual error would
        exceed uploadDeltaTol of the block's magnitude (full-width refresh
        instead).  No reference analogue (HostMatrix.C:684-692 always
        re-copies full width)."""
        import ml_dtypes

        if mirror is None or mirror.shape != new_f32.shape:
            return None
        delta = new_f32 - mirror
        dbf = delta.astype(ml_dtypes.bfloat16)
        mirror2 = mirror + dbf.astype(np.float32)
        ref = float(np.max(np.abs(new_f32))) if new_f32.size else 0.0
        err = float(np.max(np.abs(new_f32 - mirror2))) if new_f32.size else 0.0
        # the DEFAULT tolerance (upload_delta_tol None) is tied to the
        # solve's stopping config: the solver converges against the
        # COMPRESSED operands, so a delta tolerance looser than
        # ~tolerance/10 (or relTol/10) would let the reported
        # finalResidual overstate accuracy relative to the true system
        # (advisor r04).  An EXPLICIT uploadDeltaTol — via the dict key or
        # set directly on the dataclass — is honored as-is.
        tol = self.cfg.upload_delta_tol
        if tol is None:
            tol = 1e-5
            st = self.cfg.stopping
            if st.tolerance > 0.0:
                tol = min(tol, st.tolerance / 10.0)
            if st.rel_tol > 0.0:
                tol = min(tol, st.rel_tol / 10.0)
        if ref > 0.0 and err > tol * ref:
            return None
        return dbf, mirror2

    def _detect_changed_blocks(self) -> list:
        """Host-side per-block change detection against the previous step's
        values (the delta-upload baseline, HostMatrix.C:684-692 contrast:
        the reference always re-copies everything).  Marks changed blocks'
        device copies stale and returns the changed indices — the caller
        decides between the incremental and full update paths from them.
        np.array_equal early-exits on changed blocks, so the compare is
        cheap exactly when it does not pay off."""
        nb = len(self._blocks_host)
        if self._blocks_prev is None or len(self._blocks_prev) != nb:
            self._blocks_prev = [None] * nb
            self._blocks_dev = [None] * nb
        if getattr(self, "_blocks_mirror", None) is None or len(self._blocks_mirror) != nb:
            self._blocks_mirror = [None] * nb
        if self._blocks_stale is None or len(self._blocks_stale) != nb:
            self._blocks_stale = [False] * nb
        changed = []
        for i, blk in enumerate(self._blocks_host):
            prev = self._blocks_prev[i]
            if (prev is not None and prev.shape == blk.shape
                    and np.array_equal(prev, blk)):
                continue
            changed.append(i)
            self._blocks_stale[i] = True
            # private copy: a caller mutating its LDU arrays in place
            # must not alias the compare baseline
            self._blocks_prev[i] = np.array(blk)
        self.last_blocks_changed = (len(changed), nb)
        return changed

    def _stage_blocks(self, indices) -> tuple:
        """Upload the requested blocks whose device copy is missing or
        stale (host values changed since staging); resident-and-current
        blocks never cross the host->device boundary.  With uploadPrecision
        bfloat16 a changed block crosses the wire as a half-width
        error-feedback delta against the resident copy (see _bf16_delta).
        Returns the per-block device tuple — entries never requested stay
        None (the incremental path leaves untouched blocks unstaged)."""
        nb = len(self._blocks_host)
        compress = (self.cfg.upload_precision == "bfloat16"
                    and self.dtype == jnp.float32)
        uploaded = 0
        bf16_up = 0
        upload_bytes = 0
        for i in indices:
            blk = self._blocks_host[i]
            dev = self._blocks_dev[i]
            if dev is not None and not self._blocks_stale[i]:
                continue
            enc = (self._bf16_delta(np.asarray(blk, np.float32),
                                    self._blocks_mirror[i])
                   if compress and dev is not None else None)
            if enc is not None:
                dbf, mirror2 = enc
                dev = _apply_delta(dev, jnp.asarray(dbf))
                self._blocks_mirror[i] = mirror2
                bf16_up += 1
                upload_bytes += dbf.nbytes
            else:
                dev = jnp.asarray(blk)
                if compress:
                    self._blocks_mirror[i] = np.asarray(blk, np.float32).copy()
                upload_bytes += np.asarray(blk).nbytes
            self._blocks_dev[i] = dev
            self._blocks_stale[i] = False
            uploaded += 1
        self.last_blocks_uploaded = (uploaded, nb)
        self.last_blocks_bf16 = (bf16_up, nb)
        self.last_upload_bytes = upload_bytes
        return tuple(self._blocks_dev)

    def _upload_changed_blocks(self) -> tuple:
        """Detect + stage ALL blocks (the full-update path's contract)."""
        self._detect_changed_blocks()
        return self._stage_blocks(range(len(self._blocks_host)))

    def _apply_block_updates(self, changed, blocks_dev):
        """Overwrite ONLY the changed blocks' entries in the container's
        flat value storage (formats.block_update_plans): one jit'd program
        per changed-index set (in practice one or two per run, e.g. 'diag
        only'), each block a contiguous slice write when its plan is affine
        (LDU diag onto the DIA main plane) or a per-entry scatter otherwise.
        Replaces the full-nnz gather+scatter of the general path, so a
        diag-only transient step drops from O(nnz) to O(n) device work."""
        key = tuple(changed)
        fn = self._incr_fns.get(key)
        if fn is None:
            plans = [self._block_plans[i] for i in changed]
            affine = tuple(p.dest is None for p in plans)
            has_src = tuple(p.src is not None for p in plans)
            starts = tuple(p.dest_start for p in plans)
            vm = self._value_map

            @jax.jit
            def upd(mat, scale, *args):
                flat = formats.values_flat(mat)
                ai = 0
                for aff, gsrc, d0 in zip(affine, has_src, starts):
                    blk = args[ai]
                    ai += 1
                    if gsrc:  # entries reuse block positions (symmetric)
                        blk = jnp.take(blk, args[ai], axis=0)
                        ai += 1
                    v = (scale * blk).astype(flat.dtype)
                    if aff:
                        flat = jax.lax.dynamic_update_slice(flat, v, (d0,))
                    else:
                        flat = flat.at[args[ai]].set(v, unique_indices=True)
                        ai += 1
                return formats.with_values(mat, flat.reshape(vm.out_shape))

            self._incr_fns[key] = fn = upd
        args = []
        for i in changed:
            args.append(blocks_dev[i])
            p = self._block_plans[i]
            if p.src is not None:
                args.append(p.src)
            if p.dest is not None:
                args.append(p.dest)
        return fn(self.matrix, jnp.asarray(self.cfg.scaling, self.dtype),
                  *args)

    def coo_host(self) -> formats.Coo:
        """Host-side COO of the CURRENT coefficients (lazy: the row-major
        gather runs only when host values are actually needed — format
        conversion, preconditioner factorisation, export)."""
        if self._coo_host_cache is None:
            scale = self.cfg.scaling
            vals = self.src_host()[np.asarray(self.sparsity.permute)]
            if scale != 1.0:
                vals = vals * np.asarray(scale, vals.dtype)
            if self._reorder is not None:
                _, _, rp, cp, entry_order = self._reorder
                rows_h, cols_h, vals = rp, cp, vals[entry_order]
            else:
                rows_h, cols_h = self.sparsity.rows, self.sparsity.cols
            self._coo_host_cache = formats.Coo(
                rows=rows_h, cols=cols_h, vals=vals, shape=(self._n, self._n))
        return self._coo_host_cache

    # -- preconditioner (TTL caching, Preconditioner.H:353-431) ---------
    def _update_precond(self):
        pc = self.cfg.precond
        name = pc.name
        if name == "none" and self.cfg.solver != "GKOMultigrid":
            self._precond_op = None
            return
        if (getattr(self, "_precond_op", None) is not None
                and getattr(self, "_pc_built_epoch", None)
                == getattr(self, "_coeff_epoch", 0)):
            # operator coefficients are bitwise unchanged since this
            # preconditioner was generated (delta-upload bookkeeping):
            # regeneration is deterministic from identical inputs, so it
            # would rebuild the SAME preconditioner — skip it regardless
            # of TTL.  The TTL countdown freezes too: `caching` bounds how
            # many solves the precond may lag a CHANGED operator.
            return
        if getattr(self, "_precond_op", None) is not None and self.props.precond_caching_left > 0:
            self.props.precond_caching_left -= 1
            return
        with common.timed("generate_preconditioner", self.cfg.verbose, self.field, self.timings):
            if name == "none" and self.cfg.solver == "GKOMultigrid":
                # AMG-as-solver: Richardson around one AMG cycle
                op = precond.amg(
                    self.coo_host(),
                    max_levels=pc.max_levels,
                    min_coarse_rows=pc.min_coarse_rows,
                    cycle=pc.cycle,
                    coarse_solver_iters=pc.coarse_solver_iters,
                    aggregation=pc.aggregation,
                    width=pc.coarsening_rate,
                    coarse_solver=pc.coarse_solver,
                    smooth_iters=pc.smoother_sweeps,
                )
            else:
                op = precond.build(pc, self.coo_host(), verbose=self.cfg.verbose)
        old = getattr(self, "_precond_op", None)
        if old is None or old.fingerprint() != op.fingerprint():
            # structure changed (e.g. new AMG hierarchy): stale programs
            self._compiled.clear()
        self._precond_op = op
        self._pc_built_epoch = getattr(self, "_coeff_epoch", 0)
        self.props.precond_caching_left = pc.caching

    # -- solve ----------------------------------------------------------
    def _solver_fn(self):
        """Build run(mat, pc_state, b, x0, sp): the matrix pytree and the
        preconditioner state are TRACED arguments, so steady-state
        coefficient updates and TTL preconditioner regeneration reuse the
        compiled program (the DevicePersistent update path, SURVEY §3.2)."""
        name = self.cfg.solver
        n = self.matrix.shape[0]
        pc_op = self._precond_op
        pc_apply = pc_op.bind if pc_op is not None else None

        solver = {
            "GKOCG": cg,
            "GKOBiCGStab": bicgstab,
            "GKOGMRES": gmres,
            "GKOIR": ir,
            "GKOMultigrid": ir,
        }.get(name)
        if name == "GKOCG" and self.cfg.pipelined_cg:
            # single-reduction Chronopoulos–Gear variant (pipelinedCG true):
            # one fused psum per iteration instead of three sequential
            # reductions (solve/cg_pipe.py; no reference analogue)
            from ogl_tpu.solve.cg_pipe import cg_pipelined

            solver = cg_pipelined
        if solver is None:
            raise ValueError(f"unknown solver {name!r}; valid: {SOLVER_NAMES}")
        kw = {"krylov_dim": self.cfg.krylov_dim} if name == "GKOGMRES" else {}
        if (name == "GKOGMRES" and self.cfg.basis_precision == "bfloat16"
                and self.dtype == jnp.float32):
            # bf16 Krylov-basis storage (basisPrecision bfloat16): halves
            # the dominant per-iteration V stream; see solve/gmres.py
            kw["basis_dtype"] = jnp.bfloat16
        if self.cfg.export:
            # per-iteration residual history (reference export_res,
            # StoppingCriterion.C:115-117)
            kw["history_len"] = self.cfg.stopping.max_iter + self.cfg.stopping.frequency

        # GKOIR with an `inner` sub-dict: inner CG with its own OpenFOAM
        # criterion (reference create_default, GKOIR.H:58-78), optionally
        # streaming a reduced-precision operator (mixed-precision defect
        # correction — the outer residual uses the full-precision matrix,
        # so the solve still converges to solver-dtype accuracy)
        if name == "GKOIR" and self.cfg.inner_stopping is not None:
            inner_params = stopping.StoppingParams.of(self.cfg.inner_stopping)
            idt = {"bfloat16": jnp.bfloat16,
                   "float32": jnp.float32}.get(self.cfg.inner_precision)

            def run_ir(mat, pc_state, b, x0, sp):
                im = formats.cast_values(mat, idt) if idt is not None else mat
                iops = single_device_ops(
                    spmv.matvec(im), n,
                    precond=pc_apply(pc_state) if pc_apply is not None else None,
                )

                def inner(r):
                    return cg(iops, r, jnp.zeros_like(r), inner_params).x

                oops = single_device_ops(spmv.matvec(mat), n)
                return ir(oops, b, x0, sp, inner_solve=inner, **kw)

            return run_ir

        def run(mat, pc_state, b, x0, sp):
            ops = single_device_ops(
                spmv.matvec(mat), n,
                precond=pc_apply(pc_state) if pc_apply is not None else None,
            )
            return solver(ops, b, x0, sp, **kw)

        return run

    def time_device_solve(self, reps: int = 3) -> float:
        """Wall-time of ONE re-dispatch of the last solve's compiled program
        on already-resident device state: no coefficient/RHS uploads, no
        host setup — the device solve plus a single dispatch round trip.

        A steady-state step additionally pays the (asynchronous)
        host->device uploads, whose completion lands in whichever phase
        blocks first, so the per-phase `timings` alone misattribute them.
        This is the 'solve' term of the split (cf. the reference's pure
        solver->apply timing, lduLduBase.H:267-276)."""
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

    def solve(self, m: ldu.LduMatrix, b, psi=None, time_value: str | None = None) -> tuple[Any, SolverPerformance]:
        """One solve: returns (x, SolverPerformance).  `psi` is the initial
        guess (used when updateInitGuess, like the reference's dist_x).
        Runs on the device the `executor` keyword selected (the reference's
        ExecutorHandler semantics: `reference`/`omp`/`cpu` -> CPU, `cuda`
        -> GPU, no key -> JAX's default device)."""
        with jax.default_device(self.device):
            return self._solve_impl(m, b, psi, time_value)

    def _solve_impl(self, m: ldu.LduMatrix, b, psi, time_value):
        cfg = self.cfg
        _banner(cfg, self.field, self.device)
        self._update_matrix(m)
        self._update_precond()

        if not cfg.update_rhs and getattr(self, "_b_dev", None) is not None:
            # updateRHS false: reuse the cached device RHS (reference
            # PersistentVector update gating, lduLduBase.H:224)
            b_dev = self._b_dev
            psi_host = np.asarray(psi) if psi is not None else None
            if self._reorder is not None and psi_host is not None:
                psi_host = psi_host[self._reorder[0]]
        else:
            b_host = np.asarray(b)
            psi_host = np.asarray(psi) if psi is not None else None
            if self._reorder is not None:
                perm = self._reorder[0]
                b_host = b_host[perm]
                if psi_host is not None:
                    psi_host = psi_host[perm]
            if cfg.scaling != 1.0:
                # the reference scales the RHS by the same factor as the
                # matrix (lduLduBase.H:244-252 dist_b->scale), so the
                # solution is invariant under `scaling`
                b_host = b_host * np.asarray(cfg.scaling, self.dtype)
            prev = getattr(self, "_b_prev", None)
            if (prev is not None and getattr(self, "_b_dev", None) is not None
                    and prev.shape == b_host.shape
                    and np.array_equal(prev, b_host)):
                b_dev = self._b_dev  # delta: unchanged RHS stays resident
                self.last_rhs_uploaded = False
            else:
                enc = None
                if (cfg.upload_precision == "bfloat16"
                        and self.dtype == jnp.float32
                        and getattr(self, "_b_dev", None) is not None):
                    enc = self._bf16_delta(
                        np.asarray(b_host, np.float32),
                        getattr(self, "_b_mirror", None))
                if enc is not None:
                    dbf, mirror2 = enc
                    b_dev = _apply_delta(self._b_dev, jnp.asarray(dbf))
                    self._b_mirror = mirror2
                    self.last_rhs_bf16 = True
                else:
                    b_dev = jnp.asarray(b_host, self.dtype)
                    if cfg.upload_precision == "bfloat16":
                        self._b_mirror = np.asarray(b_host, np.float32).copy()
                    self.last_rhs_bf16 = False
                self._b_dev = b_dev
                self._b_prev = np.array(b_host)  # private compare baseline
                self.last_rhs_uploaded = True
        if psi_host is not None and cfg.update_init_guess:
            x0 = jnp.asarray(psi_host, self.dtype)
        else:
            x0 = jnp.zeros_like(b_dev)

        stopping_cfg = cfg.stopping.adapted(
            self.props.prev_solve_iters, self.props.prev_rel_res_cost, cfg.export
        )
        if cfg.verbose > 0 and stopping_cfg is not cfg.stopping:
            common.log(cfg.verbose, 0,
                       f"stopping criterion minIter {stopping_cfg.min_iter} "
                       f"frequency {stopping_cfg.frequency}")

        # matrix, preconditioner state, and stopping controls are all traced
        # arguments, so coefficient updates / TTL regeneration / adaptMinIter
        # reuse the same compiled program
        params = stopping.StoppingParams.of(stopping_cfg)
        pc_state = self._precond_op.state if self._precond_op is not None else ()
        if cfg.solver not in self._compiled:
            # AOT split: compile explicitly so (a) the timed solve below is
            # pure execution — the reference's time/iter has no compile
            # component, and adaptMinIter feeds off it — and (b) the
            # first-solve compile cost is measured, not folded in
            jfn = jax.jit(self._solver_fn())
            with common.timed("compile_solver", cfg.verbose, self.field,
                              self.timings):
                self._compiled[cfg.solver] = jfn.lower(
                    self.matrix, pc_state, b_dev, x0, params).compile()
        fn = self._compiled[cfg.solver]

        with common.timed("solve", cfg.verbose, self.field, self.timings):
            res = fn(self.matrix, pc_state, b_dev, x0, params)
            # ONE batched scalar fetch, inside the timed region: it avoids
            # per-scalar round trips and covers execution
            self.last_x_host = None
            # under a renumbering the raw res.x is useless to consumers
            # (f64 outer re-fetches the back-permuted return instead), so
            # batching it here would pay the big transfer twice per sweep
            if self._fetch_x_with_stats and self._reorder is None:
                iters, init_rn, final_rn, conv, self.last_x_host = \
                    jax.device_get((res.iters, res.init_res_norm,
                                    res.final_res_norm, res.converged, res.x))
            else:
                iters, init_rn, final_rn, conv = jax.device_get(
                    (res.iters, res.init_res_norm, res.final_res_norm,
                     res.converged))
        solve_t = self.timings["solve"]
        # NOTE on attribution: dispatches above (value upload, b upload)
        # are asynchronous, so the first phase that blocks — this one —
        # absorbs their completion.  time_device_solve() isolates the
        # compiled solve on settled state.
        _mat, _ps, _bd, _x0, _pp = self.matrix, pc_state, b_dev, x0, params
        self._redispatch = lambda: fn(_mat, _ps, _bd, _x0, _pp).x
        # keep the last solve's phase breakdown inspectable (the
        # update/solve split of a steady-state step)
        self.last_timings = dict(self.timings)
        self.timings.clear()

        iters = int(iters)
        n = m.n

        # residual-eval relative cost (reference lduLduBase.H:287-293):
        # time the criterion evaluation, CHAINED inside one program so the
        # per-call dispatch latency cancels
        if self._res_eval_time is None:
            k = 129  # long chain: the extra-eval time must clear dispatch jitter
            f = lambda kk: float(_res_eval_chain(self.matrix, res.x, b_dev, kk))
            f(1)
            f(k)  # both trip counts warm (k is traced: one compile)
            t_short = t_long = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                f(1)
                t1 = time.perf_counter()
                f(k)
                t2 = time.perf_counter()
                t_short = min(t_short, t1 - t0)
                t_long = min(t_long, t2 - t1)
            self._res_eval_time = max(t_long - t_short, 1e-9) / (k - 1)
        time_per_iter = solve_t / max(iters, 1)
        self.props.prev_rel_res_cost = time_per_iter / self._res_eval_time
        self.props.prev_solve_iters = iters
        self.props.init_residual = float(init_rn)
        self.props.final_residual = float(final_rn)

        if cfg.verbose > 0:
            # copy-back bandwidth (reference times dist_x.copy_back(),
            # lduLduBase.H:277-281)
            t0 = time.perf_counter()
            jax.device_get(res.x)
            copy_t = max(time.perf_counter() - t0, 1e-9)
            print(
                "\nStatistics:\n"
                f"\tTime per iteration: {time_per_iter * 1e6:.3f} [mu s]\n"
                f"\tTime per residual norm calculation: {self._res_eval_time * 1e6:.3f} [mu s]\n"
                f"\tTime per iteration and DOF: {time_per_iter * 1e9 / n:.3f} [ns]\n"
                f"\tRetrieve results bandwidth "
                f"{np.dtype(self.dtype).itemsize * n / copy_t / 1e9:.3g} [GByte/s]"
            )

        if cfg.export or cfg.debug:
            t = time_value if time_value is not None else "0"
            mtx.write_coo(f"processor0/{t}/{self.field}_A_local.mtx", self.coo_host())
            mtx.write_dense(f"processor0/{t}/{self.field}_b.mtx", b_dev)
            if res.history is not None:
                hist = np.asarray(jax.device_get(res.history))[: max(iters, 1)]
                mtx.write_dense(f"processor0/{t}/{self.field}_residuals.mtx", hist)

        perf = SolverPerformance(
            solver_name=f"{cfg.solver}_{self._fmt_used}",
            field_name=self.field,
            initial_residual=float(init_rn),
            final_residual=float(final_rn),
            n_iterations=iters,
            converged=bool(conv),
        )
        if self._reorder is not None:
            # back-permute on host (x_orig = x_permuted[inv])
            inv = self._reorder[1]
            return np.asarray(jax.device_get(res.x))[inv], perf
        return res.x, perf


def solve(field_name: str, m: ldu.LduMatrix, b, controls: dict | SolverConfig, psi=None):
    """Functional entry: get-or-create the per-field FoamSolver from the
    registry (the objectRegistry pattern) and run one solve.  `dtype
    float64` in a non-x64 process routes to the host-outer defect
    correction (foam/f64.py)."""

    def _make():
        cfg = controls if isinstance(controls, SolverConfig) else parse_controls(controls)
        from ogl_tpu.foam.f64 import F64DefectSolver, wants_host_f64

        if wants_host_f64(cfg):
            return F64DefectSolver(field_name, cfg)
        return FoamSolver(field_name, cfg)

    solver = registry.global_registry.get_or_init(f"{field_name}_solver", _make)
    return solver.solve(m, b, psi=psi)
