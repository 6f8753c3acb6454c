"""Affine (separable) halo classes — a gather-free route for the exchange.

The generic halo route gathers the send cells with jnp.take and places
received values with a scatter.  The index sets of real decompositions are
not random: processor-interface cells of slab/box decompositions of
structured meshes (and the cyclic planes of periodic channels) form
ARITHMETIC RUNS in the local numbering —

  stride 1      a contiguous slab of cells (z-normal interface)
  stride LANES  one fixed lane of the (R, 128) frame (x-normal interface,
                cyclic wrap plane)

For such runs the three halo ops compile to copies and tiny matmuls
against lane one-hots (at HIGHEST precision, so the selection is exact)
instead of gathers:

  send gather   stride-1:  lax.dynamic_slice of frame rows
                stride-L:  dynamic_slice window  @  (128, 1) lane one-hot
  recv place    lax.dynamic_update_slice into the halo buffer
  halo apply    stride-1:  windowed elementwise add
                stride-L:  outer product contrib ⊗ lane one-hot

Every per-part quantity (run start rows, lane one-hots) is ARRAY DATA, so
the compiled program is identical across shards (SPMD-safe under
shard_map): structure (run count/strides/lengths) is static and must be
uniform across parts — detection falls back to the generic gather route
when it is not (or when a stride-1 run is not 128-aligned).

No reference analogue: Ginkgo's sparse_communicator gathers through CUDA's
hardware gather units (CsrMatrixWrapper.H:195-204).  Whether this route
beats the generic gather route on the GPU is open (ROADMAP design debt 2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import static_field, _pytree

LANES = 128

__all__ = ["AffineRuns", "ApplyAffine", "detect_runs", "build_send_affine",
           "build_apply_affine", "affine_exchange", "affine_apply"]


@_pytree
@dataclasses.dataclass(frozen=True)
class AffineRuns:
    """Uniform-across-parts run structure for ONE class of indices.

    meta[j] = (stride, length): static per run; length in ELEMENTS.
    starts:  (P, n_runs) int32 — per-part flat start index of each run.
    sels:    (P, n_runs, LANES) — per-part lane one-hot of each stride-L
             run (zero rows for stride-1 runs; data, not structure)."""

    starts: jnp.ndarray
    sels: jnp.ndarray
    meta: tuple = static_field()


def detect_runs(idx_parts, max_runs: int = 16, frame_aligned: bool = True):
    """Detect a uniform arithmetic-run decomposition of per-part index
    arrays (list of 1-D int arrays, one per part; true entries only).
    Returns (meta, starts, lanes) or None when the sets are not affine,
    differ in structure across parts, or (frame_aligned) a stride-1 run is
    not 128-aligned — alignment matters only for indices into the (R, 128)
    frame, not for flat-buffer (halo slot) indices."""
    metas, starts, lanes = [], [], []
    for idx in idx_parts:
        idx = np.asarray(idx, np.int64)
        runs = []  # (stride, length, start)
        j = 0
        while j < len(idx):
            if j + 1 < len(idx) and idx[j + 1] - idx[j] in (1, LANES):
                st = int(idx[j + 1] - idx[j])
            else:
                st = 1
            k = j + 1
            while k < len(idx) and idx[k] - idx[k - 1] == st:
                k += 1
            runs.append((st, k - j, int(idx[j])))
            if len(runs) > max_runs:
                return None
            j = k
        if frame_aligned:
            for stq, ln, s0 in runs:
                if stq == 1 and (s0 % LANES or ln % LANES):
                    return None  # misaligned slab: generic route
        metas.append(tuple((stq, ln) for stq, ln, _ in runs))
        starts.append([s0 for _, _, s0 in runs])
        lanes.append([s0 % LANES if stq == LANES else 0
                      for stq, _, s0 in runs])
    if len(set(metas)) != 1:
        return None  # parts disagree structurally: not SPMD-expressible
    return metas[0], np.asarray(starts, np.int64), np.asarray(lanes, np.int64)


def _runs_of(det):
    meta, starts, lanes = det
    p, nr = starts.shape
    sels = np.zeros((p, nr, LANES), np.float32)
    for i in range(p):
        for j, (stq, _) in enumerate(meta):
            if stq == LANES:
                sels[i, j, lanes[i, j]] = 1.0
    return AffineRuns(starts=jnp.asarray(starts, jnp.int32),
                      sels=jnp.asarray(sels), meta=meta)


def build_send_affine(send_parts_per_class, recv_parts_per_class):
    """Affine exchange descriptor: per offset class, run structures for the
    send indices (local cells) and recv positions (halo slots).  Inputs are
    lists (per class) of lists (per part) of TRUE index arrays.  Returns
    (send_runs, recv_runs) tuples of AffineRuns, or None if any class or
    side is not affine."""
    send_out, recv_out = [], []
    for send_parts, recv_parts in zip(send_parts_per_class,
                                      recv_parts_per_class):
        ds = detect_runs(send_parts)
        dr = detect_runs(recv_parts, frame_aligned=False)
        if ds is None or dr is None:
            return None
        # recv side indexes the FLAT halo buffer: only stride-1 runs make
        # a placement (a strided halo layout would be a packing bug)
        if any(stq != 1 for stq, _ in dr[0]):
            return None
        send_out.append(_runs_of(ds))
        recv_out.append(AffineRuns(
            starts=jnp.asarray(dr[1], jnp.int32),
            sels=jnp.zeros((dr[1].shape[0], dr[1].shape[1], 1), jnp.float32),
            meta=dr[0]))
    return tuple(send_out), tuple(recv_out)


@_pytree
@dataclasses.dataclass(frozen=True)
class ApplyAffine:
    """Affine halo-apply descriptor.  Entries are viewed in SLOT order
    (slots then == 0..E-1, so h windows per run are static slices); rows
    holds the run structure over the slot-ordered entry rows; entry_perm
    maps slot-ordered entry e to its position in the STORED (row-major)
    halo arrays — consumers permute the traced values ONCE per solve
    (vals_slot_order = vals_stored[entry_perm]), outside the iteration
    loop, so no per-iteration gather remains."""

    rows: AffineRuns
    entry_perm: jnp.ndarray  # (P, E) int32


def build_apply_affine(halo_parts):
    """Affine halo-APPLY descriptor from per-part TRUE (rows, slots, ...)
    pairs in any stored order: entries are re-viewed in slot order (the
    slots must be exactly a permutation of 0..E-1 — one slot per
    processor-interface face, the natural enumeration contract; deduped
    or repeated slots fall back) and the slot-ordered rows must decompose
    into uniform runs.  Returns ApplyAffine or None."""
    rows_parts, perms = [], []
    e_sizes = set()
    for part in halo_parts:
        rows = np.asarray(part[0], np.int64)
        slots = np.asarray(part[1], np.int64)
        e_sizes.add(len(slots))
        if len(slots) and (slots.max(initial=-1) != len(slots) - 1
                           or len(np.unique(slots)) != len(slots)):
            return None
        perm = np.argsort(slots, kind="stable")  # slot order <- stored
        rows_parts.append(rows[perm])
        perms.append(perm)
    if len(e_sizes) != 1:
        return None
    det = detect_runs(rows_parts)
    if det is None:
        return None
    return ApplyAffine(
        rows=_runs_of(det),
        entry_perm=jnp.asarray(np.asarray(perms), jnp.int32))


# ----------------------------------------------------------------------------
# device-side ops (usable inside shard_map; `my` = axis index)
# ----------------------------------------------------------------------------


def _i32(v):
    return jnp.asarray(v, jnp.int32)


_Z = None  # set lazily: jnp.zeros((), jnp.int32) needs no backend at import


def _slab_rows(run_start, length):
    return run_start // LANES, length // LANES


def affine_exchange(x2, send_runs, recv_runs, offsets, halo_size, n_parts,
                    axis, my, row_off: int = 0):
    """Halo exchange over an (R, 128)-framed local vector using affine
    runs: per class, extract (slices + lane matmuls) -> ppermute -> place
    (dynamic_update_slice).  `row_off` shifts local row 0 into the frame
    (the fused kernels' K-row guard band)."""
    h = jnp.zeros((halo_size,), x2.dtype)
    for cls, off in enumerate(offsets):
        sr, rr = send_runs[cls], recv_runs[cls]
        pieces = []
        for j, (stq, ln) in enumerate(sr.meta):
            start = sr.starts[my, j]
            if stq == 1:
                r0, nrows = _slab_rows(start, ln)
                w = jax.lax.dynamic_slice(x2, (_i32(row_off + r0), _i32(0)),
                                          (nrows, LANES))
                pieces.append(w.reshape(-1))
            else:
                w = jax.lax.dynamic_slice(
                    x2, (_i32(row_off + start // LANES), _i32(0)),
                    (ln, LANES))
                sel = sr.sels[my, j].astype(x2.dtype)
                # one-hot selection: exact only at HIGHEST (TF32 would
                # round the selected halo values to ~10 mantissa bits)
                pieces.append(jnp.matmul(
                    w, sel[:, None],
                    precision=jax.lax.Precision.HIGHEST)[:, 0])
        payload = jnp.concatenate(pieces) if len(pieces) > 1 else pieces[0]
        perm = [(i, (i + off) % n_parts) for i in range(n_parts)]
        recvd = jax.lax.ppermute(payload, axis, perm)
        pos = 0
        for j, (_, ln) in enumerate(rr.meta):
            h = jax.lax.dynamic_update_slice(
                h, recvd[pos:pos + ln], (_i32(rr.starts[my, j]),))
            pos += ln
    return h


def affine_apply(q2, p2, h, vals_slot_order, row_runs: AffineRuns, my,
                 row_off: int = 0):
    """q2 += A_halo @ h on the framed q, plus the delta correction
    sum(contrib * p2[rows]) — all slices/matmuls.  vals_slot_order: flat
    (E,) per-shard non-local values already permuted to SLOT order
    (vals_stored[ApplyAffine.entry_perm], done once per solve).  p2 may be
    None to skip the correction (returns 0)."""
    ar = row_runs
    d2 = jnp.zeros((), q2.dtype)
    pos = 0
    for j, (stq, ln) in enumerate(ar.meta):
        contrib = (vals_slot_order[pos:pos + ln].astype(q2.dtype)
                   * h[pos:pos + ln])
        start = ar.starts[my, j]
        if stq == 1:
            r0, nrows = _slab_rows(start, ln)
            i0 = _i32(row_off + r0)
            w = jax.lax.dynamic_slice(q2, (i0, _i32(0)), (nrows, LANES))
            q2 = jax.lax.dynamic_update_slice(
                q2, w + contrib.reshape(nrows, LANES), (i0, _i32(0)))
            if p2 is not None:
                pw = jax.lax.dynamic_slice(p2, (i0, _i32(0)),
                                           (nrows, LANES))
                d2 = d2 + jnp.sum(contrib * pw.reshape(-1))
        else:
            sel = ar.sels[my, j].astype(q2.dtype)
            i0 = _i32(row_off + start // LANES)
            w = jax.lax.dynamic_slice(q2, (i0, _i32(0)), (ln, LANES))
            q2 = jax.lax.dynamic_update_slice(
                q2, w + contrib[:, None] * sel[None, :], (i0, _i32(0)))
            if p2 is not None:
                pw = jax.lax.dynamic_slice(p2, (i0, _i32(0)), (ln, LANES))
                d2 = d2 + jnp.sum(contrib * jnp.matmul(
                    pw, sel[:, None],
                    precision=jax.lax.Precision.HIGHEST)[:, 0])
        pos += ln
    return q2, d2
