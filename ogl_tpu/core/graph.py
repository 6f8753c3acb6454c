"""Graph-partitioned mesh decomposition (the `decomposePar scotch` role).

The reference's integration matrix decomposes cases with both contiguous
blocks (`simple`) and a graph partitioner (`scotch`)
(reference test/integration.yaml:47-57, .github/workflows: decompositions
simple-2 / simple-8 / scotch-8).  OGL itself never partitions — OpenFOAM's
decomposePar does — but a standalone framework must own this step, and
the partition quality directly sets the halo (ppermute) traffic of the
distributed SpMV.

Design: the partitioner only has to produce a cell→part map at
SETUP time (sparsity is constant across steps, HostMatrix.H:34), so it is
plain host NumPy/SciPy.  Method: recursive bisection on the cell-connectivity
graph, each bisection splitting a level-set (Cuthill-McKee) ordering of the
subgraph — the classic level-structure/greedy-growing heuristic family that
Scotch and Chaco ship as their cheap strategies.  Parts come out exactly
balanced (sizes fixed by the split ratio) with locality-driven boundaries,
which is the contract the halo plan cares about.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "adjacency_from_edges",
    "recursive_bisection",
    "edge_cut",
]


def adjacency_from_edges(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetric connectivity graph (scipy CSR, pattern only) from directed
    edge lists; self-edges are dropped."""
    import scipy.sparse as sp

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    a = sp.csr_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    a.data[:] = 1  # duplicates summed by construction; pattern only
    return a


def recursive_bisection(adj, n_parts: int) -> np.ndarray:
    """cell → part map by recursive level-set bisection of `adj` (scipy CSR).

    Each split orders the subgraph with (reverse) Cuthill-McKee — a BFS-level
    ordering from a pseudo-peripheral seed, correct on disconnected
    subgraphs — and cuts it at the balance point.  Part sizes are exact:
    |part i| ∈ {floor, ceil} of n/n_parts, matching decomposePar's balance."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = adj.shape[0]
    p = int(n_parts)
    if p < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if p > n:
        raise ValueError(
            f"n_parts={n_parts} exceeds the {n} graph vertices: some parts "
            "would be empty, and zero-cell rank matrices are not supported "
            "downstream (DistAssembler)")
    owner = np.zeros(n, np.int32)
    if p == 1:
        return owner
    stack = [(np.arange(n, dtype=np.int64), 0, p)]
    while stack:
        cells, p0, k = stack.pop()
        if k == 1:
            owner[cells] = p0
            continue
        k1 = k // 2
        t = int(round(len(cells) * k1 / k))
        sub = adj[cells][:, cells]
        order = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True))
        stack.append((cells[order[:t]], p0, k1))
        stack.append((cells[order[t:]], p0 + k1, k - k1))
    return owner


def edge_cut(rows: np.ndarray, cols: np.ndarray, owner: np.ndarray) -> int:
    """Number of (undirected) connectivity edges crossing parts — the total
    halo-exchange surface the partition induces."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = rows != cols
    return int(np.count_nonzero(owner[rows[keep]] != owner[cols[keep]]))
