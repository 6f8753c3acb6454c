"""Native host runtime loader.

Compiles src/ogl_host.cpp to a shared library on first use (g++ -O3,
cached under native/build/) and exposes it through ctypes.  Every entry has
a NumPy fallback so the framework works without a toolchain; `available()`
reports which path is active.

The library's file name carries a hash of the source, the compile flags
and the host (machine type and host name): a copy of the tree carried to
another host, or a changed source, finds no library under its key and
builds one — a library built elsewhere is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["lib", "available", "init_local_sparsity", "ilu0_csr", "ic0_csr",
           "pgm_aggregate", "sort_coo", "isai_build", "ilut_triples",
           "ict_triples", "dia_layout", "dia_pack_f32"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ogl_host.cpp")
_BUILD = os.path.join(_HERE, "build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
          "-Werror")

_lock = threading.Lock()
_lib = None
_tried = False


def build_key(src: str | None = None) -> str:
    """Hash of the source bytes, the compile flags and the host."""
    h = hashlib.sha256()
    with open(src or _SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(f"{platform.machine()}|{platform.node()}".encode())
    return h.hexdigest()[:16]


def library_path(src: str | None = None) -> str:
    return os.path.join(_BUILD, f"libogl_host-{build_key(src)}.so")


def _compile(src: str, so: str) -> bool:
    """Build into a temporary file and rename it into place, so concurrent
    processes never load a half-written library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """The loaded ctypes library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
        except OSError:
            return None  # source absent: NumPy paths
        if not os.path.exists(so) and not _compile(_SRC, so):
            return None
        try:
            L = ctypes.CDLL(so)
        except OSError:
            return None
        i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pf = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        L.ogl_init_local_sparsity.argtypes = [i64, i64, ctypes.c_int, p64, p64, p32, p32, p32]
        L.ogl_init_local_sparsity.restype = None
        L.ogl_ilu0.argtypes = [i64, p64, p32, pf]
        L.ogl_ilu0.restype = ctypes.c_int
        L.ogl_ic0.argtypes = [i64, p64, p32, pf]
        L.ogl_ic0.restype = ctypes.c_int
        L.ogl_pgm_aggregate.argtypes = [i64, p64, p32, pf, p32]
        L.ogl_pgm_aggregate.restype = i64
        L.ogl_sort_coo.argtypes = [i64, i64, p64, p64, p32, p32, p32]
        L.ogl_sort_coo.restype = None
        pu8_ = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        L.ogl_dia_count.argtypes = [i64, i64, p32, p32, pu8_]
        L.ogl_dia_count.restype = i64
        L.ogl_dia_dest.argtypes = [i64, i64, pu8_, p32, p32, p64, p64]
        L.ogl_dia_dest.restype = None
        L.ogl_dia_pack_f32.argtypes = [i64, i64, p64, pf32, pf32]
        L.ogl_dia_pack_f32.restype = None
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        L.ogl_isai_build.argtypes = [i64, p64, p32, pf32, p64, p32, i64,
                                     p32, pu8, pf32]
        L.ogl_isai_build.restype = None
        L.ogl_ilut.argtypes = [i64, p64, p32, pf, f64, i64, i64, p32, p32, pf, pf]
        L.ogl_ilut.restype = i64
        L.ogl_ict.argtypes = [i64, p64, p32, pf, f64, i64, p32, p32, pf, pf]
        L.ogl_ict.restype = i64
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None


def init_local_sparsity(n, lower_addr, upper_addr, symmetric):
    """Native LDU->row-major sparsity; returns (rows, cols, permute) int32.
    None if the native library is unavailable (caller falls back)."""
    L = lib()
    if L is None:
        return None
    lower_addr = np.ascontiguousarray(lower_addr, np.int64)
    upper_addr = np.ascontiguousarray(upper_addr, np.int64)
    nf = len(upper_addr)
    nnz = 2 * nf + n
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    permute = np.empty(nnz, np.int32)
    L.ogl_init_local_sparsity(n, nf, int(bool(symmetric)), lower_addr,
                              upper_addr, rows, cols, permute)
    return rows, cols, permute


def ilu0_csr(n, indptr, cols, vals):
    """In-place-style ILU(0) on CSR; returns factored vals copy or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.ascontiguousarray(vals, np.float64).copy()
    if L.ogl_ilu0(n, indptr, cols, out) != 0:
        raise ZeroDivisionError("ILU(0): zero pivot")
    return out


def ic0_csr(n, indptr, cols, vals):
    """IC(0) on the lower-triangle CSR (incl. diagonal); returns L vals."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.ascontiguousarray(vals, np.float64).copy()
    if L.ogl_ic0(n, indptr, cols, out) != 0:
        raise ZeroDivisionError("IC(0): zero pivot")
    return out


def pgm_aggregate(n, indptr, cols, absvals):
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    absvals = np.ascontiguousarray(absvals, np.float64)
    agg = np.empty(n, np.int32)
    nc = L.ogl_pgm_aggregate(n, indptr, cols, absvals, agg)
    return agg, int(nc)


def isai_build(n, a_indptr, a_cols, a_vals, s_indptr, s_cols, k):
    """Batched ISAI extract-and-solve: (J (n,k) int32, valid (n,k) bool,
    M (n,k) f32 — the solved approximate-inverse rows) or None when
    unavailable.  The k x k local systems are solved inside the C++ call:
    materialising the (n,k,k) batch and looping LAPACK over it was the
    GISAI setup's dominant cost (and its largest allocation) at 1M DOF."""
    L = lib()
    if L is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    a_vals = np.ascontiguousarray(a_vals, np.float32)
    s_indptr = np.ascontiguousarray(s_indptr, np.int64)
    s_cols = np.ascontiguousarray(s_cols, np.int32)
    J = np.empty((n, k), np.int32)
    valid = np.empty((n, k), np.uint8)
    M = np.empty((n, k), np.float32)
    L.ogl_isai_build(n, a_indptr, a_cols, a_vals, s_indptr, s_cols, k,
                     J.reshape(-1), valid.reshape(-1), M.reshape(-1))
    return J, valid.astype(bool), M


def ilut_triples(n, indptr, cols, vals, drop_tol=1e-4, fill_factor=10.0):
    """Native threshold ILU: ((L/U strict triples), udiag) or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = int(fill_factor * max(len(vals), 1)) + n
    # per-part row cap: total factor fill <= ~fill_factor x nnz(A)
    lfil = max(2, int(fill_factor * max(len(vals), 1) / max(n, 1) / 2))
    orows = np.empty(cap, np.int32)
    ocols = np.empty(cap, np.int32)
    ovals = np.empty(cap, np.float64)
    udiag = np.zeros(n, np.float64)
    cnt = int(L.ogl_ilut(n, indptr, cols32, vals, float(drop_tol), lfil, cap,
                         orows, ocols, ovals, udiag))
    if cnt < 0:
        raise RuntimeError("native ILUT failed (fill overflow or zero pivot)")
    return (orows[:cnt].copy(), ocols[:cnt].copy(), ovals[:cnt].copy()), udiag


def ict_triples(n, indptr, cols, vals, drop_tol=1e-3, fill_factor=10.0):
    """Native threshold IC: ((strict-lower triples), ldiag) or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = int(fill_factor * max(len(vals), 1)) + n
    orows = np.empty(cap, np.int32)
    ocols = np.empty(cap, np.int32)
    ovals = np.empty(cap, np.float64)
    ldiag = np.zeros(n, np.float64)
    cnt = int(L.ogl_ict(n, indptr, cols32, vals, float(drop_tol), cap,
                        orows, ocols, ovals, ldiag))
    if cnt < 0:
        raise RuntimeError("native ICT failed (fill overflow)")
    return (orows[:cnt].copy(), ocols[:cnt].copy(), ovals[:cnt].copy()), ldiag


def dia_layout(rows, cols, n):
    """Native DIA entry->slot layout: (offsets tuple, dest int64) or None.
    Semantics of core.formats.dia_layout; two tight C passes instead of
    ~6 full-nnz NumPy temporaries (first-solve setup cost on 10M+ rows)."""
    L = lib()
    if L is None or n <= 0 or n >= 2**31:
        return None
    rows32 = np.ascontiguousarray(rows, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    nnz = len(rows32)
    if nnz == 0:
        return (), np.zeros(0, np.int64)
    present = np.empty(2 * n - 1, np.uint8)
    nd = L.ogl_dia_count(nnz, n, rows32, cols32, present)
    offs = np.empty(nd, np.int64)
    dest = np.empty(nnz, np.int64)
    L.ogl_dia_dest(nnz, n, present, rows32, cols32, offs, dest)
    return tuple(int(o) for o in offs), dest


def dia_pack_f32(dest, vals, nd, n):
    """Scatter-accumulate f32 values through `dest` into a (nd, n) array;
    None when the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    dest = np.ascontiguousarray(dest, np.int64)
    vals32 = np.ascontiguousarray(vals, np.float32)
    data = np.empty(nd * n, np.float32)
    L.ogl_dia_pack_f32(len(dest), nd * n, dest, vals32, data)
    return data.reshape(nd, n)


def sort_coo(n, rows, cols):
    """Row-major sort of COO coordinates; returns (rows32, cols32, perm)."""
    L = lib()
    if L is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    nnz = len(rows)
    orows = np.empty(nnz, np.int32)
    ocols = np.empty(nnz, np.int32)
    operm = np.empty(nnz, np.int32)
    L.ogl_sort_coo(nnz, n, rows, cols, orows, ocols, operm)
    return orows, ocols, operm
