"""Classical (Ruge-Stueben-style) algebraic multigrid in pure numpy.

Builds the hierarchy whose per-level SpMV/SpGEMM communication patterns the
paper models (Figs. 1, 10, 11): successively coarser but denser matrices,
with fine levels sending few large messages and coarse levels sending many
small ones.

Components: classical strength-of-connection, greedy independent-set C/F
splitting (PMIS-flavored, deterministic), direct interpolation with
positive/negative splitting, and the Galerkin product A_c = P^T A P via two
SpGEMMs.

The V-cycle (:func:`vcycle`, V(2,2) with damped Jacobi) runs on the device:
:meth:`DeviceHierarchy.build` moves each level's A, P and P^T to it once in
block-ELL form, with ``1/diag(A)`` in float32, and every SpMV of the cycle
is one call of :func:`repro_torch.kernels.spmv_ell.spmv_block_ell` (kernel
K3 on the card).

Port note: the hierarchy is built on the host in numpy, the same hierarchy as
the reference for the same matrix and seed; each level's SpMV halo pattern
and its block-ELL operators are what reach the device.  The cycle runs in
float32 where the reference runs in float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import spmv_ell as ell

from .csr import CSR


def strength_matrix(A: CSR, theta: float = 0.25) -> CSR:
    """Classical strength: keep a_ij with |a_ij| >= theta * max_{k!=i} |a_ik|."""
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    mags = np.where(off, np.abs(A.data), 0.0)
    row_max = np.zeros(A.n_rows)
    np.maximum.at(row_max, rows, mags)
    keep = off & (mags >= theta * row_max[rows]) & (mags > 0)
    indptr = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows[keep] + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(indptr, A.indices[keep], A.data[keep], A.shape)


def cf_split(S: CSR, seed: int = 0) -> np.ndarray:
    """Greedy independent-set C/F splitting.

    Returns +1 for C points, -1 for F points.  Weights = in-degree of the
    strength graph (how many points depend on me) with a deterministic random
    tiebreak; repeatedly promote the heaviest unassigned point to C and mark
    its strong neighbors F.
    """
    n = S.n_rows
    ST = S.transpose()
    weight = ST.row_lengths().astype(np.float64)
    rng = np.random.default_rng(seed)
    weight += rng.random(n)
    state = np.zeros(n, dtype=np.int8)          # 0 unassigned
    order = np.argsort(-weight, kind="stable")
    rows = np.repeat(np.arange(n), S.row_lengths())
    # adjacency (union of S and S^T) for marking neighbors F
    nbr_ptr_s, nbr_idx_s = S.indptr, S.indices
    nbr_ptr_t, nbr_idx_t = ST.indptr, ST.indices
    for i in order:
        if state[i] != 0:
            continue
        state[i] = 1                             # C point
        for ptr, idx in ((nbr_ptr_s, nbr_idx_s), (nbr_ptr_t, nbr_idx_t)):
            nbrs = idx[ptr[i]:ptr[i + 1]]
            free = nbrs[state[nbrs] == 0]
            state[free] = -1                     # F points
    state[state == 0] = 1                        # isolated points become C
    return state


def direct_interpolation(A: CSR, S: CSR, state: np.ndarray) -> CSR:
    """Classical direct interpolation with +/- splitting.

    F-point i interpolates from its strong C neighbors j with
        w_ij = -(sum_k a_ik^- / sum_{j in C_i} a_ij^-) * a_ij / a_ii    (negatives)
    plus the symmetric positive-part term; C points interpolate identity.
    """
    n = A.n_rows
    cpts = np.nonzero(state == 1)[0]
    coarse_id = -np.ones(n, dtype=np.int64)
    coarse_id[cpts] = np.arange(len(cpts))
    nc = len(cpts)

    diag = A.diagonal()
    rows_A = np.repeat(np.arange(n), A.row_lengths())
    off = rows_A != A.indices
    neg = off & (A.data < 0)
    pos = off & (A.data > 0)
    sum_neg = np.zeros(n)
    sum_pos = np.zeros(n)
    np.add.at(sum_neg, rows_A[neg], A.data[neg])
    np.add.at(sum_pos, rows_A[pos], A.data[pos])

    # strong C-neighbor entries of S
    rows_S = np.repeat(np.arange(n), S.row_lengths())
    sC = state[S.indices] == 1
    is_f_row = state[rows_S] == -1
    keep = sC & is_f_row
    r, c, v = rows_S[keep], S.indices[keep], S.data[keep]
    csum_neg = np.zeros(n)
    csum_pos = np.zeros(n)
    np.add.at(csum_neg, r[v < 0], v[v < 0])
    np.add.at(csum_pos, r[v > 0], v[v > 0])

    scale_neg = np.divide(sum_neg, csum_neg, out=np.zeros(n),
                          where=csum_neg != 0)
    scale_pos = np.divide(sum_pos, csum_pos, out=np.zeros(n),
                          where=csum_pos != 0)
    w = np.where(v < 0, -scale_neg[r] * v / diag[r],
                 -scale_pos[r] * v / diag[r])

    rows_P = np.concatenate([cpts, r])
    cols_P = np.concatenate([np.arange(nc), coarse_id[c]])
    vals_P = np.concatenate([np.ones(nc), w])
    good = cols_P >= 0
    return CSR.from_coo(rows_P[good], cols_P[good], vals_P[good], (n, nc))


def galerkin(A: CSR, P: CSR) -> CSR:
    """A_c = P^T (A P) — the two SpGEMMs the paper prices per level."""
    AP = A.matmul(P)
    return P.transpose().matmul(AP)


@dataclasses.dataclass
class AMGLevel:
    A: CSR
    P: CSR | None       # prolongation to THIS level's fine grid (None on finest)


def build_hierarchy(A: CSR, theta: float = 0.25, max_levels: int = 12,
                    min_size: int = 64, seed: int = 0,
                    prune_tol: float = 1e-10) -> list[AMGLevel]:
    """Build the AMG hierarchy (list of levels, finest first)."""
    levels = [AMGLevel(A=A, P=None)]
    while len(levels) < max_levels and levels[-1].A.n_rows > min_size:
        Af = levels[-1].A
        S = strength_matrix(Af, theta)
        state = cf_split(S, seed=seed + len(levels))
        nc = int((state == 1).sum())
        if nc == 0 or nc >= Af.n_rows:
            break
        P = direct_interpolation(Af, S, state)
        Ac = galerkin(Af, P).prune(prune_tol)
        levels.append(AMGLevel(A=Ac, P=P))
        if Ac.n_rows <= min_size:
            break
    return levels


# ----------------------------------------------------------- V-cycle --------
@dataclasses.dataclass
class DeviceLevel:
    """One level of a :class:`DeviceHierarchy`.  ``A``, ``P`` and ``PT`` are
    block-ELL ``(blocks, cols)`` pairs; vectors of the level are zero-padded
    to ``dinv.numel()`` entries (whole block rows)."""
    n: int                              # rows of A
    A: tuple[torch.Tensor, torch.Tensor]
    dinv: torch.Tensor                  # float32 1/diag(A), 0 past n
    P: tuple | None     # prolongation to the next finer level (None on finest)
    PT: tuple | None    # its transpose, the restriction


@dataclasses.dataclass
class DeviceHierarchy:
    """An AMG hierarchy on a torch device, in the layout K3 takes."""
    levels: list[DeviceLevel]
    device: torch.device

    @classmethod
    def build(cls, levels: list[AMGLevel], bs: int = 8,
              device=None) -> "DeviceHierarchy":
        """Move the host hierarchy ``levels`` to ``device`` (``None`` means
        CUDA) once: each level's A, P and P^T (transposed here, once) in
        block-ELL with ``bs x bs`` blocks, and ``1/diag(A)`` in float32."""
        dev = resolve_device(device)
        out = []
        for lv in levels:
            blocks, cols, _ = ell.csr_to_block_ell(lv.A, bs, dev)
            dinv = np.zeros(blocks.shape[0] * blocks.shape[2])
            dinv[:lv.A.n_rows] = 1.0 / lv.A.diagonal()
            P = PT = None
            if lv.P is not None:
                P = ell.csr_to_block_ell(lv.P, bs, dev)[:2]
                PT = ell.csr_to_block_ell(lv.P.transpose(), bs, dev)[:2]
            out.append(DeviceLevel(
                lv.A.n_rows, (blocks, cols),
                torch.from_numpy(dinv.astype(np.float32)).to(dev), P, PT))
        return cls(out, dev)

    def to(self, device) -> "DeviceHierarchy":
        """The same hierarchy on ``device`` (``None`` means CUDA).  Each
        operator's ``cols`` is range-checked once here
        (:func:`~repro_torch.kernels.spmv_ell.move_ell`), so that the
        V-cycle's SpMVs wait on no check."""
        dev = resolve_device(device)

        def move(op):
            return None if op is None else ell.move_ell(*op, dev)
        return DeviceHierarchy(
            [DeviceLevel(lv.n, move(lv.A), lv.dinv.to(dev), move(lv.P),
                         move(lv.PT)) for lv in self.levels], dev)


def _jacobi(lv: DeviceLevel, x: torch.Tensor, b: torch.Tensor,
            omega: float = 0.7, iters: int = 2) -> torch.Tensor:
    for _ in range(iters):
        x = x + omega * lv.dinv * (b - ell.spmv_block_ell(*lv.A, x))
    return x


def _vcycle(h: DeviceHierarchy, b: torch.Tensor, x: torch.Tensor,
            lvl: int) -> torch.Tensor:
    """The reference's recursion on padded device vectors."""
    lv = h.levels[lvl]
    if lvl == len(h.levels) - 1 or lv.n <= 8:
        # coarsest: a few strong Jacobi sweeps stand in for a direct solve
        return _jacobi(lv, x, b, iters=50)
    x = _jacobi(lv, x, b)
    r = b - ell.spmv_block_ell(*lv.A, x)
    coarse = h.levels[lvl + 1]
    rc = ell.spmv_block_ell(*coarse.PT, r)
    ec = _vcycle(h, rc, torch.zeros_like(rc), lvl + 1)
    x = x + ell.spmv_block_ell(*coarse.P, ec)
    return _jacobi(lv, x, b)


def vcycle(levels, b, x=None, lvl: int = 0, device=None) -> torch.Tensor:
    """One V(2,2) cycle with damped-Jacobi smoothing, on the device.

    ``levels`` is a :class:`DeviceHierarchy`, or the host hierarchy of
    :func:`build_hierarchy`, which is first moved to ``device`` (``None``
    means CUDA).  ``b`` and ``x`` (numpy or torch, length ``n`` of level
    ``lvl``; ``x=None`` starts from zero) go in as float32 zero-padded to
    whole block rows; returns ``x`` as a float32 tensor of length ``n`` on
    the hierarchy's device.
    """
    if isinstance(levels, DeviceHierarchy):
        if device is not None and \
                torch.device(device).type != levels.device.type:
            raise ValueError(f"hierarchy lies on {levels.device}, not on "
                             f"{device}")
        h = levels
    else:
        h = DeviceHierarchy.build(levels, device=device)
    lv = h.levels[lvl]

    def padded(v):
        v = torch.as_tensor(v).to(device=h.device, dtype=torch.float32)
        if v.shape != (lv.n,):
            raise ValueError(f"level {lvl} vectors have {lv.n} entries, got "
                             f"shape {tuple(v.shape)}")
        out = torch.zeros(lv.dinv.numel(), dtype=torch.float32,
                          device=h.device)
        out[:lv.n] = v
        return out

    bp = padded(b)
    xp = torch.zeros_like(bp) if x is None else padded(x)
    return _vcycle(h, bp, xp, lvl)[:lv.n]
