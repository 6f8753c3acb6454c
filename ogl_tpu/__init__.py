"""ogl_tpu — a sparse linear-solver framework in JAX for NVIDIA GPUs.

A ground-up JAX/XLA re-design of the capabilities of hpsim/OGL
(the OpenFOAM–Ginkgo layer): runtime-selectable Krylov solvers
(CG, BiCGStab, GMRES, IR, Multigrid) with OpenFOAM-compatible stopping
semantics, preconditioners (block-Jacobi, ISAI, ILU/IC, AMG, Schwarz),
LDU→device-format matrix conversion with persistent device caching, and
mesh-decomposition data parallelism realised as shard_map + ppermute/psum
over a jax.sharding.Mesh instead of MPI.

Reference parity map (citations are file:line into /root/reference):
  - LDU→CSR conversion         -> ogl_tpu.core.ldu      (HostMatrix/HostMatrix.C)
  - DevicePersistent caching   -> ogl_tpu.registry      (DevicePersistent/Base/Base.H)
  - Krylov solvers             -> ogl_tpu.solve         (Solver/*, via Ginkgo)
  - Stopping criterion         -> ogl_tpu.solve.stopping (StoppingCriterion/)
  - Preconditioners            -> ogl_tpu.precond       (Preconditioner/Preconditioner.H)
  - Distributed matrix/halo    -> ogl_tpu.dist          (CsrMatrixWrapper.H, Partition.H)
  - fvSolution config + API    -> ogl_tpu.foam          (Solver/CG/GKOCG.C etc.)
"""

def _tune_malloc():
    """Keep large buffers in the reusable heap arena.

    glibc mmap's (and on free, returns) every allocation over 128 KB, so
    each multi-MB numpy temporary in the setup phase (sparsity build,
    format conversion, factorisations) pays first-touch page faults anew.
    On virtualised hosts those faults can cost tens of µs per 4K page —
    measured here: a 9M-element `astype` at 3.8 s cold vs 14 ms from a
    reused arena.  Raising the mmap/trim thresholds makes the heap arena
    grow once and be reused for the life of the process.

    Disable with OGL_TPU_MALLOC_TUNE=0 when embedding in a process whose
    resident-memory high-water mark matters more than setup latency (the
    arena is never trimmed back to the OS)."""
    import os

    if os.environ.get("OGL_TPU_MALLOC_TUNE", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # non-glibc platforms: harmless to skip
        pass


_tune_malloc()

from ogl_tpu import config as config  # noqa: E402
from ogl_tpu import registry as registry  # noqa: E402
from ogl_tpu.core import formats as formats  # noqa: E402
from ogl_tpu.core import ldu as ldu  # noqa: E402

__version__ = "0.1.0"
