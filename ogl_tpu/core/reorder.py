"""Bandwidth-reducing renumbering (reverse Cuthill-McKee).

OpenFOAM ships renumberMesh for exactly this; here it matters more: the
banded unstructured format (Gdia) stores one plane per block-row offset
class, so its SpMV cost scales with matrix bandwidth.  RCM brings FVM meshes
to near-banded form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ogl_tpu.core.formats import Coo

__all__ = ["rcm_permutation", "permute_coo", "bandwidth"]


def rcm_permutation(coo: Coo) -> np.ndarray:
    """perm such that A[perm][:, perm] has reduced bandwidth; perm[k] is the
    original index of new row k."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = coo.shape[0]
    rows = np.asarray(jax.device_get(coo.rows))
    cols = np.asarray(jax.device_get(coo.cols))
    a = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))


def permute_coo(coo: Coo, perm: np.ndarray) -> Coo:
    """Return P A Pᵀ as row-major COO (x_new = x_old[perm])."""
    n = coo.shape[0]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    rows = inv[np.asarray(jax.device_get(coo.rows))]
    cols = inv[np.asarray(jax.device_get(coo.cols))]
    vals = np.asarray(jax.device_get(coo.vals))
    order = np.lexsort((cols, rows))
    return Coo(
        rows=jnp.asarray(rows[order].astype(np.int32)),
        cols=jnp.asarray(cols[order].astype(np.int32)),
        vals=jnp.asarray(vals[order]),
        shape=coo.shape,
    )


def bandwidth(coo: Coo) -> int:
    rows = np.asarray(jax.device_get(coo.rows)).astype(np.int64)
    cols = np.asarray(jax.device_get(coo.cols)).astype(np.int64)
    return int(np.abs(rows - cols).max()) if len(rows) else 0
