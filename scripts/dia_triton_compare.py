#!/usr/bin/env python
"""Pallas-Triton Dia SpMV against XLA's `spmv_dia`, on one NVIDIA GPU.

    PYTHONPATH=. python scripts/dia_triton_compare.py

The kernel is the Hopper translation of the stencil SpMV: one program per
block of B rows (B a power of two) streams its rows of the nd diagonal
planes once and loads x at the nd shifts with masked edges; the shifted
loads of one block overlap, so L1/L2 serve all but one of them.  It lives
here, outside the package, because it did not beat XLA end to end; this
script is what decided that, and it can decide it again.

  1. SpMV at 8.4M cells (256,256,128): device time per apply from a
     trace, XLA and each block size, as GB/s against the published peak
     and a device copy timed the same way.
  2. End to end: foam.GKOCG with matrixFormat Dia at 1M (128,128,64) and
     8.4M cells, its Dia SpMV routed through XLA and through the kernel
     (the fastest block size of 1), timed in the order XLA, Triton,
     Triton, XLA: iterations, solution difference, device-resident solve
     (host clock around one re-dispatch, best of 5) and device busy time
     from a trace of one solve.

Every number is printed on a line labelled with the card's name and power
limit.  tests/test_dia_triton_compare.py runs the kernel in interpret mode
on the CPU.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ogl_tpu import foam
from ogl_tpu import testing as problems
from ogl_tpu.core import formats, ldu
from ogl_tpu.kernels import roofline, spmv, xplane

CARD = "?"
BLOCKS = (512, 1024, 2048)
CONTROLS = {"tolerance": 1e-6, "relTol": 0.0, "maxIter": 5000,
            "adaptMinIter": False, "matrixFormat": "Dia"}
KERNEL_NAME = "dia_spmv_triton"


def say(*parts):
    print(f"[{CARD}]", *parts, flush=True)


def dia_spmv_triton(m: formats.Dia, x, block: int = 512,
                    interpret: bool = False):
    """y = A @ x for a Dia matrix through one Pallas-Triton kernel."""
    n = m.shape[0]
    offs = tuple(m.offsets)

    def kernel(data_ref, x_ref, y_ref):
        rows = pl.program_id(0) * block + jnp.arange(block)
        live = rows < n
        acc = jnp.zeros((block,), jnp.float32)
        for k, off in enumerate(offs):
            cols = rows + off
            a = plgpu.load(data_ref.at[k * n + rows], mask=live, other=0.0)
            xv = plgpu.load(x_ref.at[cols],
                            mask=live & (cols >= 0) & (cols < n), other=0.0)
            acc = acc + a.astype(jnp.float32) * xv.astype(jnp.float32)
        plgpu.store(y_ref.at[rows], acc.astype(y_ref.dtype), mask=live)

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n,), x.dtype),
        grid=(pl.cdiv(n, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=KERNEL_NAME,
    )(m.data.reshape(-1), x)


@contextlib.contextmanager
def dia_route(fn):
    """Route every Dia SpMV traced inside the block through `fn(m, x)`."""
    saved = spmv._DISPATCH[formats.Dia]
    spmv._DISPATCH[formats.Dia] = fn
    try:
        yield
    finally:
        spmv._DISPATCH[formats.Dia] = saved


def dia_of(dims):
    return formats.coo_to_dia(ldu.ldu_to_coo_host(problems.poisson_ldu(dims),
                                                  dtype=np.float32))


def spmv_decision(dims, blocks, peak, copy_gbps):
    mat = dia_of(dims)
    x = jnp.asarray(np.random.default_rng(3).normal(size=mat.shape[0])
                    .astype(np.float32))
    ref = np.asarray(jax.jit(spmv.spmv_dia)(mat, x), np.float64)
    routes = {"XLA": lambda v, mm: spmv.spmv_dia(mm, v)}
    for blk in blocks:
        routes[f"Triton B={blk}"] = (
            lambda v, mm, blk=blk: dia_spmv_triton(mm, v, blk))
    out = {}
    for name, fn in routes.items():
        y = np.asarray(jax.jit(fn)(x, mat), np.float64)
        rel = np.abs(y - ref).max() / np.abs(ref).max()
        if not rel < 1e-6:
            raise AssertionError(f"Dia {name} differs from spmv_dia: {rel:.2e}")
        sec = roofline.measure_device_chained(
            lambda v, mm: fn(v, mm) * jnp.float32(0.1), x, 300, operands=(mat,))
        if not sec > 0:
            raise AssertionError("profiler trace has no device plane")
        gbps = roofline.spmv_bytes(mat) / sec / 1e9
        say(f"Dia SpMV {name} {dims}: {sec * 1e6:.2f} us/apply (device), "
            f"{gbps:.0f} GB/s = {100 * gbps / peak:.1f}% of {peak:.0f} GB/s, "
            f"{100 * gbps / copy_gbps:.1f}% of the {copy_gbps:.0f} GB/s copy")
        out[name] = sec
    return out


def busy_seconds(slv) -> float:
    """Device busy time of one re-dispatch of the solver's compiled solve."""
    jax.block_until_ready(slv._redispatch())
    tdir = tempfile.mkdtemp(prefix="ogl_triton_cmp_")
    try:
        with jax.profiler.trace(tdir):
            jax.block_until_ready(slv._redispatch())
        busy = xplane.device_busy_seconds(tdir)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    return max((v for k, v in busy.items() if not k.startswith("/host:")),
               default=0.0)


def end_to_end(dims, block, executor="cuda", interpret=False, timed=True):
    """GKOCG-Dia through XLA and through the kernel on the same system."""
    m = problems.poisson_ldu(dims)
    b = np.asarray(jax.jit(spmv.spmv)(dia_of(dims), jnp.asarray(
        np.random.default_rng(0).normal(size=m.n).astype(np.float32))))
    controls = {**CONTROLS, "executor": executor}
    traced = []

    def tri(mm, v):
        traced.append(mm.shape)  # runs while the solve is traced
        return dia_spmv_triton(mm, v, block, interpret)

    solvers, xs, iters = {}, {}, {}
    for name, route in (("XLA", None), ("Triton", tri)):
        slv = foam.GKOCG(f"p_{name}_{dims}", controls)
        with dia_route(route) if route else contextlib.nullcontext():
            x, perf = slv.solve(m, b)
        if not perf.converged:
            raise AssertionError(f"GKOCG {name} {dims}: not converged")
        if (name == "Triton") != bool(traced):
            raise AssertionError(f"GKOCG {name} {dims}: the solve did not "
                                 "trace the Dia SpMV it was routed to")
        solvers[name], xs[name] = slv, np.asarray(x, np.float64)
        iters[name] = perf.n_iterations
    diff = (np.linalg.norm(xs["Triton"] - xs["XLA"])
            / np.linalg.norm(xs["XLA"]))
    say(f"GKOCG-Dia {dims}: iterations XLA {iters['XLA']}, Triton "
        f"{iters['Triton']}; solution rel diff {diff:.2e}")
    if abs(iters["XLA"] - iters["Triton"]) > 2 or not diff < 1e-4:
        raise AssertionError(f"GKOCG-Dia {dims}: routes disagree")
    if not timed:
        return iters
    wall = {"XLA": [], "Triton": []}
    busy = {"XLA": [], "Triton": []}
    for name in ("XLA", "Triton", "Triton", "XLA"):
        wall[name].append(solvers[name].time_device_solve(reps=5))
        busy[name].append(busy_seconds(solvers[name]))
    for name in ("XLA", "Triton"):
        it = iters[name]
        say(f"GKOCG-Dia {dims} via {name}: device-resident solve "
            + ", ".join(f"{w * 1e3:.3f}" for w in wall[name]) + " ms = "
            + ", ".join(f"{w * 1e6 / it:.2f}" for w in wall[name])
            + " us/iter; device busy "
            + ", ".join(f"{t * 1e6 / it:.2f}" for t in busy[name])
            + f" us/iter ({it} iters)")
    return wall, busy


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    global CARD
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    peak = roofline.hbm_peak_gbps(dev)
    copy = roofline.measure_copy_gbps()
    say(f"device copy (device-timed): {copy:.0f} GB/s "
        f"({100 * copy / peak:.1f}% of the published {peak:.0f} GB/s)")
    secs = spmv_decision((256, 256, 128), BLOCKS, peak, copy)
    best = min(BLOCKS, key=lambda blk: secs[f"Triton B={blk}"])
    say(f"fastest Triton block size: {best}")
    for dims in ((128, 128, 64), (256, 256, 128)):
        end_to_end(dims, best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
