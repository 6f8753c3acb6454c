"""Roofline model for SpMV and solver iterations.

The reference prints per-solve derived metrics (time/iter [µs],
time/iter/DOF [ns], copy-back GB/s — lduLduBase.H:280-305) but has no
bytes-moved model.  SpMV is memory-bound everywhere, so the metric is
achieved device-memory bandwidth against the card's published peak (and
against a large copy measured in the same process).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo, Csr, Dia, Ell, Sell

__all__ = ["spmv_bytes", "spmv_flops", "hbm_peak_gbps", "HBM_PEAK", "Roofline",
           "measure_chained", "measure_copy_gbps", "measure_device_chained"]


@dataclasses.dataclass(frozen=True)
class Peak:
    gbps: float        # published device-memory bandwidth [GB/s]
    power_w: float     # power limit the published rate assumes [W]
    source: str


# Published device-memory bandwidth, keyed by jax's `device_kind` exactly.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": Peak(
        3350.0, 700.0, "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM"),
    "NVIDIA H100 PCIe": Peak(
        2000.0, 350.0, "NVIDIA H100 Tensor Core GPU data sheet, H100 PCIe"),
}


def hbm_peak_gbps(device=None) -> float:
    """Published peak bandwidth of `device` (default: the first device).
    A device that is not in HBM_PEAK is an error, never a default."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    peak = HBM_PEAK.get(kind)
    if peak is None:
        raise KeyError(
            f"no published memory bandwidth for device_kind {kind!r} "
            f"(platform {device.platform}); known: {sorted(HBM_PEAK)}")
    return peak.gbps


def _isize(m):
    return 4  # int32 indices


def spmv_bytes(m) -> int:
    """Minimal HBM traffic for one y = A@x: read values+indices once,
    read x once (perfect cache), write y once."""
    vs = np.dtype(m.dtype).itemsize
    n, nc = m.shape
    if isinstance(m, (Coo,)):
        return m.nnz * (vs + 2 * _isize(m)) + nc * vs + n * vs
    if isinstance(m, Csr):
        return m.nnz * (vs + _isize(m)) + (n + 1) * _isize(m) + nc * vs + n * vs
    if isinstance(m, Ell):
        k = m.row_width
        return n * k * (vs + _isize(m)) + nc * vs + n * vs
    if isinstance(m, Sell):
        return m.stored * (vs + _isize(m)) + nc * vs + n * vs
    if isinstance(m, Dia):
        nd = len(m.offsets)
        # values + x streamed once per diagonal band (worst case) vs once
        # total (best case); report the optimistic bound like the GPU
        # SpMV literature: vals once, x once, y once.
        return nd * n * vs + nc * vs + n * vs
    raise TypeError(type(m))


def spmv_flops(m) -> int:
    if isinstance(m, Dia):
        return 2 * len(m.offsets) * m.shape[0]
    if isinstance(m, Ell):
        return 2 * m.shape[0] * m.row_width
    if isinstance(m, Sell):
        return 2 * m.stored
    return 2 * m.nnz


@dataclasses.dataclass(frozen=True)
class Roofline:
    seconds: float
    bytes: int
    flops: int

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    def fraction_of(self, peak_gbps: float) -> float:
        return self.gbps / peak_gbps


def measure_copy_gbps(n: int = 256 * 1024 * 1024, iters: int = 100) -> float:
    """Bandwidth [GB/s] of a large plain device copy: `iters` chained
    `x + 1` over n f32 (each reads and writes n words), timed from the
    device trace by measure_device_chained.  This is the ceiling a
    streaming kernel is held against in the same process, beside the
    published peak; both sides of that ratio then come from one clock.
    Raises when the trace has no accelerator plane (e.g. on the CPU)."""
    sec = measure_device_chained(lambda v: v + jnp.float32(1.0),
                                 jnp.zeros((n,), jnp.float32), iters)
    if not sec > 0:
        raise RuntimeError("the profiler trace has no accelerator plane "
                           "to time the copy on")
    return 2 * n * 4 / sec / 1e9


def measure_device_chained(vec_fn, x0, iters: int, operands=()) -> float:
    """Per-iteration seconds of the SAME chained loop measure_chained times,
    but taken from the DEVICE timeline (jax.profiler xplane capture) instead
    of host wall clock.

    measure_chained is host-side slope timing of device programs; until a
    second, independent methodology agrees with it, a fraction-of-peak
    derived from it rests on one clock measuring itself.  This runs one
    length-`iters` chain under `jax.profiler.trace`, parses the xplane.pb
    (kernels/xplane.py — no tensorflow dependency) and returns
    device-busy-time / iters, where busy time is the measure of the UNION
    of kernel-event intervals on the accelerator plane (exactly "time the
    device was executing anything", immune to dispatch/host costs in the
    opposite direction from the host measurement: any tracing
    overhead or device idle gaps can only INFLATE host time relative to
    this, so host >= device is the expected ordering and agreement within
    a few % validates both).  Returns 0.0 if the capture contains no
    accelerator plane (e.g. CPU backend)."""
    import shutil
    import tempfile

    from ogl_tpu.kernels import xplane

    @jax.jit  # operands traced, not closed over (same rationale as above)
    def chain(x, k, *ops):
        return jnp.sum(jax.lax.fori_loop(
            0, k, lambda i, v: vec_fn(v, *ops), x))

    float(chain(x0, iters, *operands))  # compile + warm OUTSIDE the trace
    tdir = tempfile.mkdtemp(prefix="ogl_xplane_")
    try:
        with jax.profiler.trace(tdir):
            float(chain(x0, iters, *operands))
        busy = xplane.device_busy_seconds(tdir)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    dev = [v for k, v in busy.items() if not k.startswith("/host:")]
    return max(dev) / iters if dev else 0.0


def measure_chained(vec_fn, x0, iters: int | None = None, warmup: int = 2,
                    bytes_moved=0, flops=0,
                    target_seconds: float = 1.0, operands=()) -> Roofline:
    """Time a vector->vector kernel without per-call dispatch overhead.

    `iters` dependent applications run inside ONE compiled fori_loop,
    forced by fetching a scalar reduction.  The chain is ABSOLUTELY timed
    and only the separately measured fixed dispatch+fetch cost (a
    zero-iteration chain) is subtracted; the chain is auto-sized so that
    cost is <1% of the run.  Any unaccounted overhead can only INFLATE the
    per-iteration time, so the derived fraction-of-peak is a LOWER bound.

    NOTE measured bandwidth is achieved STREAMING bandwidth of wherever the
    operands live; operand sets that fit in the 50 MB L2 of an H100 can
    exceed the device-memory peak — size the problem well above it for a
    memory roofline claim.
    """
    import time

    # `operands` (e.g. the matrix arrays) ride as TRACED arguments: closing
    # over hundreds of MB bakes them into the jaxpr as constants, which
    # makes the compile pathologically slow and defeats the persistent
    # cache; vec_fn is then called vec_fn(v, *operands)
    @jax.jit  # trip count traced: ONE compile for every chain length
    def chain(x, k, *ops):
        return jnp.sum(jax.lax.fori_loop(
            0, k, lambda i, v: vec_fn(v, *ops), x))

    def timed(k, reps):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chain(x0, k, *operands))
            best = min(best, time.perf_counter() - t0)
        return best

    float(chain(x0, 1, *operands))  # compile + warm, forced
    rtt = timed(0, 5)  # fixed dispatch + host-fetch cost
    if iters is None:
        probe_k = 64
        per_est = max((timed(probe_k, max(warmup, 2)) - rtt) / probe_k, 1e-8)
        iters = int(min(max(target_seconds / per_est, 256), 200_000))
    t = timed(iters, max(warmup, 2))
    per_iter = max((t - rtt) / iters, 1e-9)
    return Roofline(seconds=per_iter, bytes=bytes_moved, flops=flops)
