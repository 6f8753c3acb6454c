"""Distributed Xell tier: fully unstructured
shards stacked on the parts axis with shared union statics, applied through
the crossed-gather kernel inside shard_map; plus the loud warning when
large shards fall to the XLA-gather Ell tier (the dist twin of
kernels/spmv.py pack_fast's warning).

Reference role: every inner format of Ginkgo's distributed matrix is
device-fast (CsrMatrixWrapper.H:138-161)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ogl_tpu import registry
from ogl_tpu.core.formats import Coo
from ogl_tpu.dist import partition as part
from ogl_tpu.dist.partition import (XellStack, pack_local_stack,
                                    partition_coo, shard_local_matrix,
                                    split_vector, gather_global)
from ogl_tpu.kernels.xell import xell_to_coo


@pytest.fixture(autouse=True)
def _clear():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _unstructured_coo(n=1024, deg=5, seed=0, spd=False):
    """Random symmetric kNN-ish graph: bandwidth ~n (no Dia/Gdia tier)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, size=n * deg)
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep], np.arange(n)])
    c = np.concatenate([dst[keep], src[keep], np.arange(n)])
    v = rng.normal(size=len(r))
    m = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    m = m + m.T  # symmetric
    if spd:
        m = sp.diags(np.abs(m).sum(axis=1).A1 + 1.0) - sp.diags(m.diagonal()) + m
    mc = m.tocoo()
    order = np.lexsort((mc.col, mc.row))
    return Coo(rows=mc.row[order].astype(np.int32),
               cols=mc.col[order].astype(np.int32),
               vals=mc.data[order].astype(np.float64),
               shape=(n, n)), m


def test_pack_xell_stack_roundtrip():
    """Per-shard structural inverse of the packed stack equals the input
    shard triples (union statics forced across shards)."""
    coo, _ = _unstructured_coo(n=700, deg=4)
    p = 4
    bounds = [round(i * 700 / p) for i in range(p + 1)]
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals)
    shards = []
    n_local = max(bounds[i + 1] - bounds[i] for i in range(p))
    for i in range(p):
        sel = (rows >= bounds[i]) & (rows < bounds[i + 1]) \
            & (cols >= bounds[i]) & (cols < bounds[i + 1])
        shards.append((rows[sel] - bounds[i], cols[sel] - bounds[i],
                       vals[sel]))
    stack, dest = pack_local_stack(shards, n_local, np.float64, fmt="Xell")
    assert isinstance(stack, XellStack)
    for i in range(p):
        m_i = jax.tree.map(lambda a: a[i:i + 1], stack)
        x = shard_local_matrix(m_i, n_local)
        got = xell_to_coo(x)
        want = sp.coo_matrix((shards[i][2],
                              (shards[i][0], shards[i][1])),
                             shape=(n_local, n_local)).tocsr()
        have = sp.coo_matrix((np.asarray(got.vals),
                              (np.asarray(got.rows), np.asarray(got.cols))),
                             shape=(n_local, n_local)).tocsr()
        assert abs(want - have).max() < 1e-12, f"shard {i} mismatch"
    # dest maps every entry to its flat value slot: scatter the values
    # through dest and compare against the stack's value leaf
    size = stack.vals.shape[1]
    for i in range(p):
        flat = np.zeros(size + 1)
        flat[np.asarray(dest[i][: len(shards[i][0])])] = shards[i][2]
        np.testing.assert_allclose(flat[:size], np.asarray(stack.vals[i]))


def test_partition_coo_auto_lands_xell_when_forced():
    """fmt='Xell' through partition_coo: the distributed SpMV through
    dist_ops matches scipy on an unstructured operator."""
    from jax.sharding import Mesh, PartitionSpec as P

    from ogl_tpu.dist.solve import dist_ops

    coo, acsr = _unstructured_coo(n=640, deg=4, seed=1)
    nparts = 4
    dm = partition_coo(coo, nparts, local_format="Xell")
    assert isinstance(dm.local, XellStack)
    rng = np.random.default_rng(2)
    x = rng.normal(size=640)
    xs = jnp.asarray(split_vector(dm, x))

    devs = np.array(jax.devices()[:nparts])
    mesh = Mesh(devs, ("x",))

    def body(local, halo, xv):
        lm = shard_local_matrix(local, dm.n_local)
        ops = dist_ops(lm, (halo.rows[0], halo.cols[0], halo.vals[0]),
                       dm.plan, dm.global_n, "x")
        return ops.matvec(xv[0])[None]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
        out_specs=P("x"), check_vma=False))
    y = gather_global(dm, fn(dm.local, dm.halo, xs))
    yref = acsr @ x
    rel = np.abs(y - yref).max() / np.abs(yref).max()
    assert rel < 1e-12, f"dist Xell SpMV mismatch: {rel}"


def test_dist_solve_on_xell_matches_single_device():
    """End-to-end distributed CG on an SPD unstructured operator with the
    Xell local tier: converges and matches the scipy direct solve."""
    coo, acsr = _unstructured_coo(n=768, deg=4, seed=3, spd=True)
    # hand the global COO through the LDU-free path: build a DistMatrix and
    # solve via dist_solve directly (foam front ends take LduMatrix)
    from jax.sharding import Mesh
    from ogl_tpu.config import StoppingConfig
    from ogl_tpu.dist.solve import dist_solve
    from ogl_tpu.solve.stopping import StoppingParams

    nparts = 4
    dm = partition_coo(coo, nparts, local_format="Xell")
    assert isinstance(dm.local, XellStack)
    rng = np.random.default_rng(4)
    x_true = rng.normal(size=768)
    b = acsr @ x_true
    bs = jnp.asarray(split_vector(dm, b))
    mesh = Mesh(np.array(jax.devices()[:nparts]), ("x",))
    sp_ = StoppingParams.of(StoppingConfig(
        tolerance=1e-10, rel_tol=0.0, max_iter=3000, frequency=1))
    xs, res = dist_solve(dm, bs, jnp.zeros_like(bs), sp_, mesh)
    assert bool(res.converged)
    x = gather_global(dm, xs)
    rel = np.abs(x - x_true).max() / np.abs(x_true).max()
    assert rel < 1e-6, f"dist Xell CG err {rel}"


def test_dist_assembler_xell_value_update():
    """Steady-state coefficient updates flow through the XellStack's flat
    value leaf (main + spill) — same dest machinery as Dia/Gdia/Ell."""
    from ogl_tpu import testing as problems
    from ogl_tpu.core import ldu as ldu_mod
    from ogl_tpu.dist.from_ranks import DistAssembler

    m = problems.poisson_ldu((12, 10))
    ranks = ldu_mod.decompose(m, 2)
    asm = DistAssembler(ranks, dtype=np.float64, local_format="Xell")
    assert isinstance(asm.dm.local, XellStack)

    import dataclasses as dc

    m2 = dc.replace(m, diag=m.diag * 1.5, upper=m.upper * 0.75)
    ranks2 = ldu_mod.decompose(m2, 2)
    asm.update(ranks2)
    # reconstruct each shard and compare against the expected local blocks
    coo2 = ldu_mod.ldu_to_coo_host(m2, dtype=np.float64)
    a2 = sp.csr_matrix((np.asarray(coo2.vals),
                        (np.asarray(coo2.rows), np.asarray(coo2.cols))),
                       shape=coo2.shape)
    half = m.n // 2
    for i, sl in enumerate((slice(0, half), slice(half, m.n))):
        m_i = jax.tree.map(lambda a: a[i:i + 1], asm.dm.local)
        x = shard_local_matrix(m_i, asm.dm.n_local)
        got = xell_to_coo(x)
        have = sp.csr_matrix((np.asarray(got.vals),
                              (np.asarray(got.rows), np.asarray(got.cols))),
                             shape=(asm.dm.n_local, asm.dm.n_local))
        want = a2[sl, sl]
        nl = want.shape[0]
        assert abs(want - have[:nl, :nl]).max() < 1e-12, f"shard {i}"


def test_local_diag_xell():
    from ogl_tpu.dist.solve import local_diag

    coo, acsr = _unstructured_coo(n=512, deg=4, seed=5, spd=True)
    dm = partition_coo(coo, 1, local_format="Xell")
    x = shard_local_matrix(dm.local, dm.n_local)
    d = np.asarray(jax.device_get(local_diag(x)))[:512]
    np.testing.assert_allclose(d, acsr.diagonal(), rtol=1e-12)


def test_ell_landing_warns_at_scale(monkeypatch):
    """Shards >= the Xell gate that STILL land on Ell (window too wide even
    for Xell) must warn loudly.  The gate is lowered so the test does not need 32k rows;
    a random non-RCM'd graph at c_max chunks... use an operator whose
    bandwidth exceeds the Xell window: dense-ish random columns at n=2048
    with the tile window capped by monkeypatching c_max via xell_layout's
    default — simplest trigger: force a huge spill by patching k_max."""
    monkeypatch.setattr(part, "_XELL_MIN_ROWS", 256)

    import ogl_tpu.kernels.xell as xk

    orig = xk.xell_layout

    def tiny_layout(*a, **kw):
        kw.setdefault("c_max", 0)  # every pattern overflows the window
        return orig(*a, **kw)

    monkeypatch.setattr(xk, "xell_layout", tiny_layout)
    # dense-ish rows: the Gdia union plane table overflows (>48 planes),
    # so the auto ladder reaches the (sabotaged) Xell tier and must warn
    # on the Ell landing
    coo, _ = _unstructured_coo(n=512, deg=60, seed=6)
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    with pytest.warns(RuntimeWarning, match="Ell tier"):
        stack, _ = pack_local_stack(
            [(rows, cols, np.asarray(coo.vals))], 512, np.float64,
            fmt="auto")
    assert type(stack).__name__ == "EllStack"


def _skewed_shards(n_local, left_chunks_a, right_chunks_b, seed=0):
    """Two shards over the same n_local whose windows are individually
    small but skew opposite ways: shard A reaches `left_chunks_a` chunks
    LEFT of the diagonal, shard B `right_chunks_b` chunks RIGHT (one
    chunk = 128 lane-blocks = 16384 columns at LANES=TB=128)."""
    rng = np.random.default_rng(seed)
    chunk = 128 * 128
    # wide column jitter (half a chunk) keeps the window statics exact but
    # spreads col-row offsets far past any Gdia plane budget, so fmt=auto
    # genuinely reaches the Xell tier
    rows_a = np.arange(left_chunks_a * chunk, n_local, 97)
    cols_a = rows_a - left_chunks_a * chunk + (rng.integers(
        0, chunk // 2, size=len(rows_a)))
    rows_b = np.arange(0, n_local - right_chunks_b * chunk, 101)
    cols_b = rows_b + (right_chunks_b - 1) * chunk + chunk // 2 + (
        rng.integers(0, chunk // 2, size=len(rows_b)))
    a = (rows_a.astype(np.int64), cols_a.astype(np.int64),
         rng.normal(size=len(rows_a)))
    b = (rows_b.astype(np.int64), cols_b.astype(np.int64),
         rng.normal(size=len(rows_b)))
    return [a, b]


def test_xell_stack_opposite_skew_union():
    """Regression (round-5 review): c_left and the right-chunk count must
    unionise SEPARATELY.  A left-skewed shard (c_left=2, right=1) plus a
    right-skewed one (c_left=0, right=3) used to agree (c_left=2,
    c_chunks=max(3,3)=3) and then fail the forced repack of the right
    shard with 'force_c_chunks=3 < required 5' — auto mode silently fell
    to the XLA-gather Ell tier (and multi-process builds could diverge:
    only the process owning the skewed shard fell back)."""
    n_local = 3 * 128 * 128 + 256  # room for 3 chunks of span
    shards = _skewed_shards(n_local, left_chunks_a=2, right_chunks_b=3)
    stack, dest = pack_local_stack(shards, n_local, np.float64, fmt="Xell")
    assert isinstance(stack, XellStack)
    assert stack.c_left == 2 and stack.c_chunks == 5  # 2 left + 3 right
    # per-shard structural inverse: the packed stack holds exactly the
    # input triples
    for i, (r, c, v) in enumerate(shards):
        m_i = jax.tree.map(lambda a: a[i:i + 1], stack)
        got = xell_to_coo(shard_local_matrix(m_i, n_local))
        want = sp.coo_matrix((v, (r, c)), shape=(n_local, n_local)).tocsr()
        have = sp.coo_matrix(
            (np.asarray(got.vals), (np.asarray(got.rows),
                                    np.asarray(got.cols))),
            shape=(n_local, n_local)).tocsr()
        assert abs(have - want).max() < 1e-14, f"shard {i} corrupted"


def test_xell_stack_union_over_budget_uniform():
    """When the agreed union window exceeds xell_layout's c_max (6), the
    raise happens on the UNION (identical on every process/shard mix),
    not inside one shard's forced repack: fmt='Xell' raises naming the
    union, fmt='auto' falls to Ell with the loud warning."""
    n_local = 4 * 128 * 128 + 256
    shards = _skewed_shards(n_local, left_chunks_a=3, right_chunks_b=4)
    with pytest.raises(ValueError, match="agreed Xell window"):
        pack_local_stack(shards, n_local, np.float64, fmt="Xell")
    with pytest.warns(RuntimeWarning, match="Ell tier"):
        stack, _ = pack_local_stack(shards, n_local, np.float64, fmt="auto")
    assert not isinstance(stack, XellStack)


def test_xell_union_agreed_across_processes():
    """Cross-process angle of the opposite-skew fix: a process owning only
    the LEFT-skewed shard must succeed when the agreement hook reports a
    right-skewed peer (c_right from another process) — the union recompose
    c_chunks = c_left + c_right covers both, so every process lands
    XellStack with IDENTICAL statics (no divergent SPMD structure)."""
    n_local = 3 * 128 * 128 + 256
    shard_a, shard_b = _skewed_shards(n_local, left_chunks_a=2,
                                      right_chunks_b=3)

    def peer_hook(values_of_peer):
        def hook(kind, *args):
            assert kind == "xell"
            ok, k, c_left, c_right, spill_e = args
            pok, pk, pl, pr, ps = values_of_peer
            return (ok and pok, max(k, pk), max(c_left, pl),
                    max(c_right, pr), max(spill_e, ps))
        return hook

    stacks = []
    # process 0 owns A (c_left=2, right=1); its peer reports B's statics
    # (c_left=0, right=3) — and vice versa
    for own, peer in ((shard_a, shard_b), (shard_b, shard_a)):
        lay_peer = None
        from ogl_tpu.kernels import xell as xk
        lay_peer = xk.xell_layout(peer[0], peer[1], n_local)
        peer_vals = (True, lay_peer.n_slots, lay_peer.c_left,
                     lay_peer.c_chunks - lay_peer.c_left,
                     int(lay_peer.spill_sel.sum()))
        prev = part.set_struct_agree_hook(peer_hook(peer_vals))
        try:
            # _pack_xell_stack directly: pack_local_stack's earlier ladder
            # rungs consult the hook with kind 'dia' first
            stack, _ = part._pack_xell_stack([own], n_local, np.float64,
                                             len(own[0]))
        finally:
            part.set_struct_agree_hook(prev)
        assert isinstance(stack, XellStack)
        stacks.append(stack)
    s0, s1 = stacks
    assert (s0.n_slots, s0.c_left, s0.c_chunks) == \
        (s1.n_slots, s1.c_left, s1.c_chunks) == (s0.n_slots, 2, 5), \
        [(s.n_slots, s.c_left, s.c_chunks) for s in stacks]
