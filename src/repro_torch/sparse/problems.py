"""Model problems: 3-D Poisson and a 3-D linear-elasticity-like operator.

The paper's application is an unstructured 3-D linear elasticity system from
MFEM (840k unknowns, 65M nnz ~ 77 nnz/row, i.e. a 27-point vertex stencil
with 3 dof/node).  Without MFEM we generate the same *structure*: a 27-point
hexahedral stencil with 3x3 displacement-coupling blocks and mild
coefficient jitter ("unstructured-like" variability).  Communication volume
and sparsity pattern — what the models consume — match the paper's regime;
FEM-exact entries are not required.

Port note: host-side numpy, identical to the reference generators for the
same arguments and seed.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None) -> CSR:
    """Standard 7-point Laplacian on an nx x ny x nz grid (Dirichlet)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 6.0)]
    for axis, extent in ((0, nx), (1, ny), (2, nz)):
        if extent < 2:
            continue
        lo = np.take(idx, np.arange(extent - 1), axis=axis).ravel()
        hi = np.take(idx, np.arange(1, extent), axis=axis).ravel()
        rows += [lo, hi]
        cols += [hi, lo]
        vals += [np.full(lo.size, -1.0), np.full(hi.size, -1.0)]
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def elasticity_like_3d(nx: int, ny: int | None = None, nz: int | None = None,
                       jitter: float = 0.1, seed: int = 0) -> CSR:
    """27-point vertex stencil with 3x3 blocks (3 dof/node), SPD by dominance.

    Structure-faithful stand-in for the paper's MFEM linear elasticity matrix:
    ~81 nnz/row, strong diagonal blocks, symmetric cross-component coupling.
    """
    ny = ny or nx
    nz = nz or nx
    n_nodes = nx * ny * nz
    idx = np.arange(n_nodes).reshape(nx, ny, nz)
    rng = np.random.default_rng(seed)

    # enumerate unique neighbor offsets (half-space to keep symmetry)
    offsets = [(dx, dy, dz)
               for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
               if (dx, dy, dz) > (0, 0, 0)]
    rows_l, cols_l, vals_l = [], [], []

    # per-node random symmetric 3x3 coupling scale ("material" jitter)
    node_w = 1.0 + jitter * rng.standard_normal(n_nodes)

    dof = np.arange(3)
    off_diag_total = np.zeros(n_nodes)      # accumulate |off-block| row sums
    for (dx, dy, dz) in offsets:
        sl_a = tuple(slice(max(0, -d), min(s, s - d))
                     for d, s in ((dx, nx), (dy, ny), (dz, nz)))
        sl_b = tuple(slice(max(0, d), min(s, s + d))
                     for d, s in ((dx, nx), (dy, ny), (dz, nz)))
        a = idx[sl_a].ravel()
        b = idx[sl_b].ravel()
        if a.size == 0:
            continue
        dist = abs(dx) + abs(dy) + abs(dz)
        w = -1.0 / dist * 0.5 * (node_w[a] + node_w[b])   # symmetric weight
        # 3x3 block: -w*I plus small symmetric coupling eps between components
        eps = 0.15 * w
        for di in range(3):
            for dj in range(3):
                coef = w if di == dj else eps
                rows_l += [3 * a + di, 3 * b + dj]
                cols_l += [3 * b + dj, 3 * a + di]
                vals_l += [coef, coef]
        blk_rowsum = np.abs(w) + 2 * np.abs(eps)
        np.add.at(off_diag_total, a, blk_rowsum)   # block a->b in a's rows
        np.add.at(off_diag_total, b, blk_rowsum)   # block b->a in b's rows

    # diagonal 3x3 blocks: full (cross-component coupling) + dominance margin
    nodes = np.arange(n_nodes)
    cross = 0.05 * (off_diag_total + 1e-3)         # symmetric off-diagonals
    diag_val = (off_diag_total + 2 * cross) * 1.05 + 1e-3
    for di in range(3):
        rows_l.append(3 * nodes + di)
        cols_l.append(3 * nodes + di)
        vals_l.append(diag_val)
        for dj in range(di + 1, 3):
            rows_l += [3 * nodes + di, 3 * nodes + dj]
            cols_l += [3 * nodes + dj, 3 * nodes + di]
            vals_l += [cross, cross]

    n = 3 * n_nodes
    return CSR.from_coo(np.concatenate([np.asarray(r) for r in rows_l]),
                        np.concatenate([np.asarray(c) for c in cols_l]),
                        np.concatenate([np.asarray(v) for v in vals_l]),
                        (n, n))
