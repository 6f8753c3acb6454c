"""Block-Jacobi preconditioner ("BJ", reference Preconditioner.H:91-105,
Ginkgo gko::preconditioner::Jacobi).

Shape: the diagonal blocks are one (n_blocks, bs, bs) batched dense array
— inverted once with a batched solve at setup, and applied as one batched
matmul (at HIGHEST precision) per iteration.  Blocking is uniform
contiguous rows of `max_block_size` (Ginkgo agglomerates supervariables up
to max_block_size; FV cell orderings make contiguous blocking the natural
equivalent).  max_block_size=1 degenerates to scalar Jacobi.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo

__all__ = ["block_jacobi", "diagonal_of"]


def diagonal_of(coo: Coo):
    """Host-side diagonal extraction."""
    rows = np.asarray(jax.device_get(coo.rows))
    cols = np.asarray(jax.device_get(coo.cols))
    vals = np.asarray(jax.device_get(coo.vals))
    d = np.zeros(coo.shape[0], vals.dtype)
    on_diag = rows == cols
    np.add.at(d, rows[on_diag], vals[on_diag])
    return d


def block_jacobi(coo: Coo, block_size: int = 1):
    from ogl_tpu.precond import PrecondOp

    n = coo.shape[0]
    bs = max(1, int(block_size))

    if bs == 1:
        inv_d = jnp.asarray(1.0 / diagonal_of(coo))
        return PrecondOp(lambda s, r: s.astype(r.dtype) * r, inv_d)

    nb = -(-n // bs)
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    vals = np.asarray(jax.device_get(coo.vals))
    blocks = np.zeros((nb, bs, bs), vals.dtype)
    same = rows // bs == cols // bs
    np.add.at(blocks, (rows[same] // bs, rows[same] % bs, cols[same] % bs), vals[same])
    # pad rows beyond n with identity so the batched inverse is well posed
    for i in range(nb * bs - n):
        blocks[nb - 1, bs - 1 - i, bs - 1 - i] = 1.0
    inv = jnp.linalg.inv(jnp.asarray(blocks))

    def apply(s, r):
        rp = jnp.pad(r, (0, nb * bs - n)).reshape(nb, bs)
        y = jnp.einsum("bij,bj->bi", s.astype(r.dtype), rp,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)[:n]

    return PrecondOp(apply, inv)
