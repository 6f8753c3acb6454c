"""Problem generators shared by tests and benchmarks.

The reference validates on OpenFOAM tutorial cases (cavity pressure Poisson,
channel); without OpenFOAM in the loop the equivalent systems are structured
finite-volume Poisson matrices expressed in LDU form, which exercise the
exact conversion + solve path (SURVEY.md §4 "solver-level tests on SPD
Poisson matrices").
"""

from __future__ import annotations

import numpy as np

from ogl_tpu.core import ldu

__all__ = ["poisson_ldu", "poisson_dense", "convection_diffusion_ldu",
           "channel_ldu", "to_dense_ldu", "grid_shape"]


def grid_shape(dims):
    return (dims, 1, 1) if isinstance(dims, int) else tuple(dims) + (1,) * (3 - len(dims))


def poisson_ldu(dims, dirichlet_boundary: bool = True) -> ldu.LduMatrix:
    """FV Poisson (pressure-equation-like) system on a structured grid in
    OpenFOAM LDU form: faces sorted by (owner, neighbour) ascending owners,
    diag = number of neighbours (+ boundary contribution), upper = -1.

    dims: int or tuple up to 3-D.  With dirichlet_boundary=True boundary
    cells get an extra diagonal unit (pinning the nullspace, like a fixed-
    value patch); otherwise the matrix is singular (pure Neumann) like a
    real incompressible pressure equation.
    """
    nx, ny, nz = grid_shape(dims)
    n = nx * ny * nz
    cid = np.arange(n).reshape(nz, ny, nx)  # (k, j, i) layout

    owners, nbrs = [], []
    if nx > 1:
        owners.append(cid[:, :, :-1].ravel())
        nbrs.append(cid[:, :, 1:].ravel())
    if ny > 1:
        owners.append(cid[:, :-1, :].ravel())
        nbrs.append(cid[:, 1:, :].ravel())
    if nz > 1:
        owners.append(cid[:-1, :, :].ravel())
        nbrs.append(cid[1:, :, :].ravel())
    owners = np.concatenate(owners) if owners else np.zeros(0, np.int64)
    nbrs = np.concatenate(nbrs) if nbrs else np.zeros(0, np.int64)
    order = np.lexsort((nbrs, owners))
    lower_addr = owners[order].astype(np.int64)
    upper_addr = nbrs[order].astype(np.int64)
    diag = np.zeros(n)
    np.add.at(diag, lower_addr, 1.0)
    np.add.at(diag, upper_addr, 1.0)
    if dirichlet_boundary:
        # boundary faces contribute to the diagonal only
        bmask = np.zeros((nz, ny, nx))
        for ax, m in ((2, nx), (1, ny), (0, nz)):
            if m > 1:
                idx = [slice(None)] * 3
                idx[ax] = 0
                bmask[tuple(idx)] += 1
                idx[ax] = m - 1
                bmask[tuple(idx)] += 1
        diag += bmask.ravel()
    return ldu.LduMatrix(
        n=n,
        lower_addr=lower_addr,
        upper_addr=upper_addr,
        diag=diag,
        upper=np.full(len(lower_addr), -1.0),
    )


def convection_diffusion_ldu(dims, peclet: float = 0.5) -> ldu.LduMatrix:
    """Non-symmetric convection-diffusion system (upwinded convection adds
    ±peclet to the off-diagonals), exercising the asymmetric LDU path
    (separate lower/upper arrays, like a momentum equation)."""
    base = poisson_ldu(dims)
    nf = base.n_faces
    upper = base.upper - peclet  # downstream coupling
    lower = np.full(nf, -1.0) + peclet  # upstream coupling
    diag = base.diag + 2 * abs(peclet)  # keep diagonally dominant
    return ldu.LduMatrix(
        n=base.n,
        lower_addr=base.lower_addr,
        upper_addr=base.upper_addr,
        diag=diag,
        upper=upper,
        lower=lower,
    )


def to_dense_ldu(m: ldu.LduMatrix) -> np.ndarray:
    """Densify any LduMatrix (incl. non-symmetric and local interfaces)."""
    a = np.zeros((m.n, m.n))
    np.fill_diagonal(a, m.diag)
    lower = m.upper if m.symmetric else m.lower
    np.add.at(a, (np.asarray(m.lower_addr), np.asarray(m.upper_addr)),
              np.asarray(m.upper))
    np.add.at(a, (np.asarray(m.upper_addr), np.asarray(m.lower_addr)),
              np.asarray(lower))
    for li in m.local_interfaces:
        np.add.at(a, (np.asarray(li.rows), np.asarray(li.cols)),
                  -np.asarray(li.coeffs))
    return a


def poisson_dense(dims, dirichlet_boundary: bool = True) -> np.ndarray:
    return to_dense_ldu(poisson_ldu(dims, dirichlet_boundary))


def channel_ldu(dims, aniso: float = 4.0, periodic: str = "x") -> ldu.LduMatrix:
    """Periodic-channel pressure system (the reference's second integration
    case family: periodicPlaneChannel/channel395, a cyclic-BC LES channel,
    test_matrix.json + integration.yaml): FV Poisson on a structured grid,
    PERIODIC along each axis in `periodic` ("x" streamwise; "xz" adds the
    spanwise cyclic pair of channel395) via cyclic LocalInterfaces pairing
    the first and last planes, wall-normal anisotropy `aniso` on the
    y-direction couplings (stretched-grid transmissibility).  Diagonal gets
    a small fixed-value pin so the periodic system stays SPD."""
    nx, ny, nz = grid_shape(dims)
    base = poisson_ldu(dims, dirichlet_boundary=False)
    n = base.n
    cid = np.arange(n).reshape(nz, ny, nx)

    # anisotropy: faces in the y direction carry coefficient -aniso
    upper = np.asarray(base.upper).copy()
    diag = np.asarray(base.diag).copy()
    if ny > 1:
        lo, up = base.lower_addr, base.upper_addr
        y_face = (up - lo) == nx  # neighbour one y-row away
        upper[y_face] = -aniso
        extra = (aniso - 1.0)
        np.add.at(diag, lo[y_face], extra)
        np.add.at(diag, up[y_face], extra)

    ifaces = []
    for axis in periodic:
        ax, m = {"x": (2, nx), "z": (0, nz)}[axis]
        if m <= 2:
            continue
        first = np.take(cid, 0, axis=ax).ravel()
        last = np.take(cid, m - 1, axis=ax).ravel()
        rows = np.concatenate([first, last])
        cols = np.concatenate([last, first])
        ifaces.append(ldu.LocalInterface(rows=rows, cols=cols,
                                         coeffs=np.ones(rows.shape[0])))
        np.add.at(diag, first, 1.0)
        np.add.at(diag, last, 1.0)
    ifaces = tuple(ifaces)
    # pin the nullspace (pure-Neumann + periodic would be singular)
    diag[0] += 1.0
    return ldu.LduMatrix(
        n=n,
        lower_addr=base.lower_addr,
        upper_addr=base.upper_addr,
        diag=diag,
        upper=upper,
        local_interfaces=ifaces,
    )
