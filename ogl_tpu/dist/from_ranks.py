"""DistMatrix construction from per-rank LDU systems — the reference's
actual distributed path: each MPI rank owns an LduMatrix plus processor
interfaces, from which it builds a CommunicationPattern
(HostMatrix.C:252-306), a localized partition (Partition.H:57-70) and a
local + non-local distributed matrix (CsrMatrixWrapper.H:163-210).

Pairwise ordering contract (same as OpenFOAM processor patches): for two
ranks a and b, the k-th face of a's interface(s) to b couples to the k-th
face of b's interface(s) to a, with multiple interfaces per pair listed in
matching order on both sides.  The halo buffer uses one slot per
processor-interface face in natural enumeration order (reference
HostMatrix.C:412-436) — NOT deduplicated by column, exactly like the
reference's recv buffer.

Steady-state coefficient updates follow the reference's bulk-copy +
on-device gather design (HostMatrix.C:684-704 row_gather path +
CsrMatrixWrapper.H:74-136 in-place value overwrite): the raw per-rank LDU
blocks are packed into one padded (P, S) source stack on the host (a
vectorised memcpy), uploaded once, and two jit'd gathers place every value
into the stacked local/halo storages — no per-entry host work.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ogl_tpu.core import ldu as ldu_mod
from ogl_tpu.dist.partition import (
    DiaStack,
    DistMatrix,
    HaloPlan,
    pack_halo_stack,
    pack_local_stack,
)

__all__ = ["DistAssembler", "dist_from_ldu_ranks", "build_halo_plan"]


@dataclasses.dataclass(frozen=True)
class _DistBlockPlan:
    """One source-block KIND's slice of the stacked steady-state update —
    the distributed twin of formats.BlockUpdatePlan (kind j = the j-th raw
    LDU block of EVERY rank; per-rank offsets differ, so the index tables
    are per-rank rows of stacked (P, L) arrays).

    affine: (start, length) when every rank's block maps identity-onto one
    contiguous run at the SAME start of its flat local storage (the LDU
    diag onto the DiaStack main plane) — applied as one 2-D slice write.
    src/dst: (P, L) gather/scatter tables otherwise (dst pads park
    out-of-bounds and are dropped).  hsrc/hpos: the block's halo-value
    entries, usually only the proc-interface kind."""

    b_max: int
    affine: tuple | None
    src: jnp.ndarray | None
    dst: jnp.ndarray | None
    hsrc: jnp.ndarray | None
    hpos: jnp.ndarray | None


def build_halo_plan(iface_lists, halo_size: int) -> HaloPlan:
    """Static ppermute schedule from every rank's processor-interface list
    (per rank: [(neighbor, face_cells), ...] in interface order).

    Send side: face cells of all interfaces to a rank, interface order
    (the reference CommunicationPattern, HostMatrix.C:252-306).  Recv side:
    halo slots are the natural interface-face enumeration, so neighbor r's
    block sits at the positions of r's interfaces in that enumeration —
    matching r's send order by the pairwise contract.

    SELF-neighbor interfaces (neighbor == own rank, e.g. a cyclic patch
    whose two sides land on the same rank routed through the exchange —
    see ldu.decompose cyclic_via_halo) must come in consecutive PAIRS in
    the per-self interface order; the k-th face of a pair's first
    interface couples with the k-th face of its second.  The d = 0
    ppermute class this creates is a real identity-permutation collective
    ([(i, i)]), so the same compiled program exercises halo
    gather/exchange/scatter even on a single-device mesh."""
    p = len(iface_lists)
    sends = []  # per rank {req: concatenated local send indices}
    recv_slots = []  # per rank {nbr: slot array}
    for rank, ifaces in enumerate(iface_lists):
        s: dict[int, list] = {}
        slots_of: dict[int, list] = {}
        ctr = 0
        for nbr, fc in ifaces:
            fc = np.asarray(fc, np.int64)
            s.setdefault(int(nbr), []).append(fc)
            slots_of.setdefault(int(nbr), []).append(
                np.arange(ctr, ctr + len(fc)))
            ctr += len(fc)
        # self-pairs: payload order is the interface order (A, B, ...);
        # A's payload must land in B's slots and vice versa, so the recv
        # slot concat swaps within each consecutive pair
        if rank in slots_of:
            pair_slots = slots_of[rank]
            if len(pair_slots) % 2:
                raise ValueError(
                    f"rank {rank}: self-neighbor interfaces must come in "
                    f"pairs (two coupled sides), got {len(pair_slots)}")
            for a, b in zip(s[rank][0::2], s[rank][1::2]):
                if len(a) != len(b):
                    raise ValueError(
                        f"rank {rank}: self-neighbor interface pair has "
                        f"mismatched face counts {len(a)} != {len(b)}")
            slots_of[rank] = [pair_slots[k ^ 1] for k in range(len(pair_slots))]
        sends.append({r: np.concatenate(v) for r, v in s.items()})
        recv_slots.append({r: np.concatenate(v) for r, v in slots_of.items()})

    per_offset: dict[int, dict[int, np.ndarray]] = {}
    for owner in range(p):
        for req, sidx in sends[owner].items():
            d = (req - owner) % p
            per_offset.setdefault(d, {})[owner] = np.asarray(sidx, np.int64)
    offsets = tuple(sorted(per_offset))

    # affine fast-path detection (dist.affine): every class must have
    # every part participating with structurally uniform arithmetic runs
    send_affine = recv_affine = None
    if offsets and all(len(per_offset[d]) == p for d in offsets):
        from ogl_tpu.dist.affine import build_send_affine

        try:
            aff = build_send_affine(
                # send runs indexed by the SENDING part (owner o ships to
                # (o+d)%p), recv runs by the RECEIVING part (i hears from
                # (i-d)%p) — matching affine_exchange's my-indexing
                [[per_offset[d][o] for o in range(p)] for d in offsets],
                [[recv_slots[i][(i - d) % p] for i in range(p)]
                 for d in offsets])
        except KeyError:
            aff = None  # a receiver lacks the pairing interface
        if aff is not None:
            send_affine, recv_affine = aff
    send_idx_list, recv_pos_list = [], []
    for d in offsets:
        owners = per_offset[d]
        s = max(len(v) for v in owners.values())
        sidx = np.zeros((p, s), np.int32)
        rpos = np.full((p, s), halo_size, np.int32)
        for owner, v in owners.items():
            req = (owner + d) % p
            sidx[owner, : len(v)] = v
            slots = recv_slots[req].get(owner)
            if slots is None:
                raise ValueError(
                    f"pairwise interface mismatch: rank {owner} sends to "
                    f"{req}, but {req} has no interface back to {owner}")
            if len(slots) != len(v):
                raise ValueError(
                    f"pairwise interface mismatch: rank {owner} sends "
                    f"{len(v)} faces to {req}, which expects {len(slots)}")
            rpos[req, : len(slots)] = slots
        send_idx_list.append(jnp.asarray(sidx))
        recv_pos_list.append(jnp.asarray(rpos))

    return HaloPlan(
        send_idx=tuple(send_idx_list),
        recv_pos=tuple(recv_pos_list),
        offsets=offsets,
        halo_size=halo_size,
        n_parts=p,
        send_affine=send_affine,
        recv_affine=recv_affine,
    )


def _rank_source_blocks(m: ldu_mod.LduMatrix, dtype) -> list:
    """The rank's source blocks [upper, (lower,) diag, (-local_iface,)
    (-proc_iface)] (signs applied; reference HostMatrix.C:204 negates
    interface bouCoeffs).  The local prefix is the shared single-device
    layout (ldu._host_blocks) so the two paths cannot drift; blocks stay
    split so steady-state updates can upload only changed ones."""
    sp_stub = ldu_mod.LduSparsity(
        n=m.n, n_faces=m.n_faces, symmetric=m.symmetric,
        rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
        permute=np.zeros(0, np.int32),
        n_local_iface=sum(len(li.rows) for li in m.local_interfaces),
    )
    parts = ldu_mod._host_blocks(sp_stub, m, dtype)
    if m.proc_interfaces:
        parts.append(-np.concatenate([np.asarray(pi.coeffs, dtype)
                                      for pi in m.proc_interfaces]))
    return parts


def _rank_sources(m: ldu_mod.LduMatrix, dtype):
    """Concatenated _rank_source_blocks (the construction-time layout)."""
    parts = _rank_source_blocks(m, dtype)
    return np.concatenate(parts) if len(parts) > 1 else np.asarray(parts[0])


@partial(jax.jit, static_argnames=("src_size",))
def _stack_src_blocks(blocks, *, src_size):
    """Per-rank tuples of (HBM-resident, delta-uploaded) source blocks ->
    the padded (P, S+1) source stack, entirely on device (the trailing
    slot stays 0: it is the parking slot pad gathers read)."""
    rows = []
    for blks in blocks:
        src = jnp.concatenate(blks) if len(blks) > 1 else blks[0]
        rows.append(jnp.pad(src, (0, src_size + 1 - src.shape[0])))
    return jnp.stack(rows)


@partial(jax.jit, static_argnames=("local_shape",))
def _assemble_values(src_stack, perm_local, dest_local, perm_halo, scale,
                     *, local_shape):
    """(P, S) source stack -> (stacked local value storage, halo values).
    Pure gathers/scatter with static shapes; pads read the zero tail slot."""
    vals_l = scale * jnp.take_along_axis(src_stack, perm_local, axis=1)
    size = 1
    for s in local_shape:
        size *= int(s)

    def place(v, d):
        return jnp.zeros(size + 1, v.dtype).at[d].add(v)[:size]

    flat = jax.vmap(place)(vals_l, dest_local)
    local_vals = flat.reshape((flat.shape[0],) + local_shape)
    halo_vals = scale * jnp.take_along_axis(src_stack, perm_halo, axis=1)
    return local_vals, halo_vals


class DistAssembler:
    """Builds a DistMatrix from per-rank LduMatrix systems once, then
    re-assembles coefficients on device every later step (the
    PersistentSparsityPattern + update split of the reference)."""

    def __init__(self, ranks: list, dtype=np.float64, local_format: str = "auto",
                 scale: float = 1.0):
        self.dtype = np.dtype(dtype)
        # `scaling` applies to the MATRIX (reference HostMatrix.C:33); the
        # caller must scale b by the same factor (lduLduBase.H:244-252) so
        # the solution stays invariant
        self.scale = float(scale)
        p = len(ranks)
        local_sizes = tuple(m.n for m in ranks)
        n_local = max(local_sizes)
        global_n = sum(local_sizes)

        loc_shards = []   # (rows, cols, vals)
        halo_shards = []  # (rows, slots, vals)
        halo_sizes = []
        self._sp = []     # per-rank LduSparsity
        self._halo_perm = []  # per-rank halo permute into proc-iface concat
        src_lens = []
        for m in ranks:
            sp = ldu_mod.build_local_sparsity(m)
            self._sp.append(sp)
            src = self._sources(m)
            src_lens.append(len(src))
            vals = src[sp.permute]
            loc_shards.append((sp.rows.astype(np.int64), sp.cols.astype(np.int64), vals))
            hrows, hslots, hperm = ldu_mod.build_non_local_sparsity(m)
            self._halo_perm.append(hperm.astype(np.int64))
            off_proc = len(src) - sum(len(pi.face_cells) for pi in m.proc_interfaces)
            hvals = src[off_proc + hperm] if len(hperm) else np.zeros(0, self.dtype)
            halo_shards.append((hrows.astype(np.int64), hslots.astype(np.int64), hvals))
            halo_sizes.append(sum(len(pi.face_cells) for pi in m.proc_interfaces))

        halo_size = max(max(halo_sizes, default=0), 1)
        iface_lists = [[(int(pi.neighbor), np.asarray(pi.face_cells, np.int64))
                        for pi in m.proc_interfaces] for m in ranks]
        plan = build_halo_plan(iface_lists, halo_size)

        local, dest_local = pack_local_stack(
            loc_shards, n_local, self.dtype, fmt=local_format
        )
        halo = pack_halo_stack(halo_shards, self.dtype)

        from ogl_tpu.dist.affine import build_apply_affine

        self.dm = DistMatrix(
            local=local,
            halo=halo,
            plan=plan,
            n_local=n_local,
            local_sizes=local_sizes,
            global_n=global_n,
            halo_sizes=tuple(len(h[0]) for h in halo_shards),
            apply_affine=(build_apply_affine(halo_shards)
                          if plan.send_affine is not None else None),
        )

        # ---- update machinery (device gathers; pads read the zero slot S)
        self._src_size = max(src_lens) if src_lens else 1
        self._src_lens = src_lens
        s_pad = self._src_size  # parking index (src stack padded by one)
        e_l = dest_local.shape[1]
        perm_local = np.full((p, e_l), s_pad, np.int32)
        for i, sp in enumerate(self._sp):
            perm_local[i, : sp.nnz] = sp.permute
        e_h = int(halo.vals.shape[1])
        perm_halo = np.full((p, e_h), s_pad, np.int32)
        for i, (m, hperm) in enumerate(zip(ranks, self._halo_perm)):
            if len(hperm):
                off_proc = src_lens[i] - sum(len(pi.face_cells) for pi in m.proc_interfaces)
                perm_halo[i, : len(hperm)] = off_proc + hperm
        self._perm_local = jnp.asarray(perm_local)
        self._dest_local = dest_local
        self._perm_halo = jnp.asarray(perm_halo)
        if isinstance(local, DiaStack):
            self._local_kind = "Dia"
            self._local_shape = tuple(int(s) for s in local.data.shape[1:])
        else:  # GdiaStack / EllStack both store values under .vals
            self._local_kind = type(local).__name__.removesuffix("Stack")
            self._local_shape = tuple(int(s) for s in local.vals.shape[1:])

        # seed the host-change baseline from the construction-time values
        # (private copies): the first update() can then detect an
        # unchanged operator, which gates preconditioner regeneration
        self._blk_prev = [[np.array(x) for x in
                           _rank_source_blocks(m, self.dtype)] for m in ranks]
        self._blk_dev = [[None] * len(b) for b in self._blk_prev]
        self._blk_stale = [[False] * len(b) for b in self._blk_prev]
        # incremental-update machinery (lazy; see _build_block_plans)
        self._block_plans = ()  # () = not built yet; None = unsound
        self._incr_fns = {}
        self._eff_scale = self.scale  # construction assembled at `scaling`

    def _sources(self, m) -> np.ndarray:
        """Per-rank source vector with `scaling` applied (the scaled matrix
        is what every consumer — local/halo storage, Schwarz factorisation,
        export — must see, matching the reference's scaled HostMatrix)."""
        src = _rank_sources(m, self.dtype)
        if self.scale != 1.0:
            src = src * np.asarray(self.scale, self.dtype)
        return src

    def shard_triples(self, ranks):
        """Per-shard local-block COO triples with CURRENT values (host) —
        what the Schwarz preconditioner setup factorises, the reference's
        dist_A->get_local_matrix() (Preconditioner.H:62-66).  Reuses the
        source blocks gathered by the most recent update of the same step
        instead of re-concatenating every block."""
        blks = getattr(self, "_blocks_cache", None)
        if blks is not None and len(blks) == len(self._sp):
            srcs = [np.concatenate(b) if len(b) > 1 else np.asarray(b[0])
                    for b in blks]
            if self.scale != 1.0:  # cached blocks are raw; _sources scales
                srcs = [s * np.asarray(self.scale, s.dtype) for s in srcs]
        else:
            srcs = [self._sources(m) for m in ranks]
        out = []
        for sp, src in zip(self._sp, srcs):
            out.append((sp.rows.astype(np.int64), sp.cols.astype(np.int64),
                        src[sp.permute]))
        return out

    def _detect_changed_blocks(self, ranks) -> list:
        """Host-side per-(rank, block) change detection against the previous
        step's values (the delta-upload baseline; the reference always
        re-copies everything, HostMatrix.C:684-692).  Validates that each
        rank's source length matches construction — a changed face count
        means the sparsity changed and the cached permute tables would
        silently gather stale positions.  Returns the changed (rank, block)
        pairs; changed blocks' device copies are marked stale."""
        blks_host = []
        for i, m in enumerate(ranks):
            b = _rank_source_blocks(m, self.dtype)
            if sum(len(x) for x in b) != self._src_lens[i]:
                raise ValueError(
                    f"rank {i}: source length {sum(len(x) for x in b)} != "
                    f"{self._src_lens[i]} at construction — the sparsity "
                    "changed; rebuild the DistAssembler")
            blks_host.append(b)
        if getattr(self, "_blk_prev", None) is None or \
                len(self._blk_prev) != len(blks_host) or any(
                    len(p) != len(b)
                    for p, b in zip(self._blk_prev, blks_host)):
            self._blk_prev = [[None] * len(b) for b in blks_host]
            self._blk_dev = [[None] * len(b) for b in blks_host]
            self._blk_stale = [[False] * len(b) for b in blks_host]
        changed = []
        total = 0
        for i, blks in enumerate(blks_host):
            for j, blk in enumerate(blks):
                total += 1
                prev = self._blk_prev[i][j]
                if (prev is not None and prev.shape == blk.shape
                        and np.array_equal(prev, blk)):
                    continue
                changed.append((i, j))
                self._blk_prev[i][j] = np.array(blk)  # private baseline
                self._blk_stale[i][j] = True
        self.last_blocks_changed = (len(changed), total)
        self._blocks_cache = blks_host  # raw blocks; shard_triples re-scales
        return changed

    def _stage_blocks(self, pairs) -> tuple:
        """Upload the requested (rank, block) pairs whose device copy is
        missing or stale; resident-and-current blocks never cross the
        host->device boundary (cf. FoamSolver._stage_blocks).  Entries never
        requested stay None — the incremental path leaves untouched blocks
        unstaged."""
        uploaded = 0
        total = sum(len(b) for b in self._blk_prev)
        for i, j in pairs:
            if self._blk_dev[i][j] is not None and not self._blk_stale[i][j]:
                continue
            self._blk_dev[i][j] = jnp.asarray(self._blocks_cache[i][j])
            self._blk_stale[i][j] = False
            uploaded += 1
        self.last_blocks_uploaded = (uploaded, total)
        return tuple(tuple(row) for row in self._blk_dev)

    def _upload_changed_blocks(self, ranks) -> tuple:
        """Detect + stage ALL blocks (the full-update path's contract)."""
        self._detect_changed_blocks(ranks)
        p = len(self._blk_prev)
        return self._stage_blocks(
            [(i, j) for i in range(p) for j in range(len(self._blk_prev[i]))])

    def _build_block_plans(self):
        """Per-block-kind incremental update plans (the distributed twin of
        formats.block_update_plans).  None when per-kind overwrite is
        unsound: ranks disagree on block count, or some rank's local dest
        slots are not unique (duplicate slots accumulate in
        _assemble_values's .add — overwriting one contributor would drop
        the others)."""
        p = len(self._sp)
        counts = {len(b) for b in self._blk_prev}
        if len(counts) != 1:
            return None
        nb = counts.pop()
        perm_local = np.asarray(jax.device_get(self._perm_local), np.int64)
        dest_local = np.asarray(jax.device_get(self._dest_local), np.int64)
        perm_halo = np.asarray(jax.device_get(self._perm_halo), np.int64)
        flat_size = 1
        for s in self._local_shape:
            flat_size *= int(s)
        for i, sp in enumerate(self._sp):
            d = dest_local[i, : sp.nnz]
            if len(np.unique(d)) != len(d):
                return None
        lens = [[int(x.size) for x in blks] for blks in self._blk_prev]
        e_h = perm_halo.shape[1]
        plans = []
        for j in range(nb):
            offs = [sum(lens[i][:j]) for i in range(p)]
            ln = [lens[i][j] for i in range(p)]
            srcs, dsts, hqs, hsrcs = [], [], [], []
            for i in range(p):
                pl = perm_local[i, : self._sp[i].nnz]
                q = np.flatnonzero((pl >= offs[i]) & (pl < offs[i] + ln[i]))
                srcs.append(pl[q] - offs[i])
                dsts.append(dest_local[i, q])
                ph = perm_halo[i, : len(self._halo_perm[i])]
                hq = np.flatnonzero((ph >= offs[i]) & (ph < offs[i] + ln[i]))
                hqs.append(hq)
                hsrcs.append(ph[hq] - offs[i])
            b_max = max(max(ln), 1)
            # affine: every rank's entries are the identity map onto one
            # contiguous run at the same start (LDU diag -> DIA main plane):
            # ONE 2-D slice write replaces the element-serial scatter
            affine = None
            if len(set(ln)) == 1 and ln[0] > 0:
                starts = []
                for i in range(p):
                    o = np.argsort(srcs[i], kind="stable")
                    s_s, d_s = srcs[i][o], dsts[i][o]
                    if not (len(s_s) == ln[i]
                            and np.array_equal(s_s, np.arange(ln[i]))
                            and np.all(np.diff(d_s) == 1)):
                        starts = None
                        break
                    starts.append(int(d_s[0]))
                if starts is not None and len(set(starts)) == 1:
                    affine = (starts[0], ln[0])
            src_a = dst_a = None
            if affine is None and any(len(s) for s in srcs):
                lmax = max(len(s) for s in srcs)
                src_a = np.zeros((p, lmax), np.int32)
                dst_a = np.full((p, lmax), flat_size, np.int32)  # OOB: drop
                for i in range(p):
                    src_a[i, : len(srcs[i])] = srcs[i]
                    dst_a[i, : len(srcs[i])] = dsts[i]
                src_a, dst_a = jnp.asarray(src_a), jnp.asarray(dst_a)
            hsrc_a = hpos_a = None
            if any(len(h) for h in hsrcs):
                hmax = max(len(h) for h in hsrcs)
                hsrc_a = np.zeros((p, hmax), np.int32)
                hpos_a = np.full((p, hmax), e_h, np.int32)  # OOB: drop
                for i in range(p):
                    hsrc_a[i, : len(hsrcs[i])] = hsrcs[i]
                    hpos_a[i, : len(hqs[i])] = hqs[i]
                hsrc_a, hpos_a = jnp.asarray(hsrc_a), jnp.asarray(hpos_a)
            plans.append(_DistBlockPlan(
                b_max=b_max, affine=affine, src=src_a, dst=dst_a,
                hsrc=hsrc_a, hpos=hpos_a))
        return plans

    def _apply_block_updates(self, kinds, scale):
        """Overwrite ONLY the changed block kinds' entries in the stacked
        local/halo value storages: one jit'd program per changed-kind set
        (in practice one per run, e.g. 'diag only'), the LDU diag a single
        2-D slice write when its plan is affine.  Replaces the full-nnz
        gather+scatter of the general path, so a diag-only transient step
        drops from O(nnz) to O(n) device work (cf.
        FoamSolver._apply_block_updates)."""
        key = tuple(kinds)
        fn = self._incr_fns.get(key)
        if fn is None:
            plans = [self._block_plans[j] for j in kinds]
            local_shape = self._local_shape

            @jax.jit
            def upd(local_vals, halo_vals, s, *blocks):
                p = local_vals.shape[0]
                flat = local_vals.reshape(p, -1)
                hv = halo_vals
                for pl, blks in zip(plans, blocks):
                    stack = jnp.stack([
                        jnp.pad(b, (0, pl.b_max - b.shape[0]))
                        for b in blks])
                    if pl.affine is not None:
                        d0, ln = pl.affine
                        v = (s * stack[:, :ln]).astype(flat.dtype)
                        flat = jax.lax.dynamic_update_slice(flat, v, (0, d0))
                    elif pl.dst is not None:
                        v = (s * jnp.take_along_axis(stack, pl.src, axis=1)
                             ).astype(flat.dtype)
                        flat = jax.vmap(
                            lambda f, d, vv: f.at[d].set(vv, mode="drop")
                        )(flat, pl.dst, v)
                    if pl.hpos is not None:
                        w = (s * jnp.take_along_axis(stack, pl.hsrc, axis=1)
                             ).astype(hv.dtype)
                        hv = jax.vmap(
                            lambda h, pos, vv: h.at[pos].set(vv, mode="drop")
                        )(hv, pl.hpos, w)
                return flat.reshape((p,) + local_shape), hv

            self._incr_fns[key] = fn = upd
        dm = self.dm
        local_leaf = dm.local.data if isinstance(dm.local, DiaStack) \
            else dm.local.vals
        args = [tuple(self._blk_dev[i][j] for i in range(len(self._blk_dev)))
                for j in kinds]
        return fn(local_leaf, dm.halo.vals,
                  jnp.asarray(scale, self.dtype), *args)

    def update(self, ranks, scale=1.0) -> DistMatrix:
        """Steady-state coefficient update: same sparsity, new values — the
        distributed analogue of update_local_matrix_data /
        update_non_local_matrix_data + the device value overwrite
        (HostMatrix.C:593-732, CsrMatrixWrapper.H:74-136).  The blocks stay
        raw on the host; `scaling` is folded into the device gather.  A
        step that changes only SOME blocks (transient CFD: diag/RHS carry
        the time step) routes through _apply_block_updates; a bitwise
        unchanged operator skips device work entirely."""
        eff = self.scale * scale
        changed = self._detect_changed_blocks(ranks)
        total = sum(len(b) for b in self._blk_prev)
        if eff == self._eff_scale and not changed:
            self.last_blocks_uploaded = (0, total)
            return self.dm  # resident values already current
        if self._block_plans == ():  # lazy: first real update builds plans
            self._block_plans = self._build_block_plans()
        kinds = sorted({j for _, j in changed})
        nb = len(self._blk_prev[0]) if self._blk_prev else 0
        p = len(self._blk_prev)
        if (eff == self._eff_scale and self._block_plans is not None
                and 0 < len(kinds) < nb):
            # partial change: touch only the changed kinds' entries
            # (unchanged kinds stay unstaged on every rank)
            self._stage_blocks([(i, j) for i in range(p) for j in kinds])
            local_vals, halo_vals = self._apply_block_updates(kinds, eff)
        else:
            blocks = self._stage_blocks(
                [(i, j) for i in range(p) for j in range(len(self._blk_prev[i]))])
            src = _stack_src_blocks(blocks, src_size=self._src_size)
            local_vals, halo_vals = _assemble_values(
                src, self._perm_local, self._dest_local, self._perm_halo,
                jnp.asarray(eff, self.dtype),
                local_shape=self._local_shape,
            )
        self._eff_scale = eff
        dm = self.dm
        if isinstance(dm.local, DiaStack):
            local = dataclasses.replace(dm.local, data=local_vals)
        else:
            local = dataclasses.replace(dm.local, vals=local_vals)
        halo = dataclasses.replace(dm.halo, vals=halo_vals)
        self.dm = dataclasses.replace(dm, local=local, halo=halo)
        return self.dm


def dist_from_ldu_ranks(ranks: list, dtype=np.float64,
                        local_format: str = "auto") -> DistMatrix:
    """Build a sharded DistMatrix from one LduMatrix (with proc_interfaces)
    per rank (one-shot; use DistAssembler to keep the update path)."""
    return DistAssembler(ranks, dtype=dtype, local_format=local_format).dm
