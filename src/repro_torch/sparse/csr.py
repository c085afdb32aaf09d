"""Compressed-sparse-row matrices in pure numpy.

Implements the operations the paper's applications need: SpMV, transpose,
and a vectorized Gustavson SpGEMM (row-chunked expand/sort/reduce, no Python
inner loops).

Port note: host-side construction and a float64 host SpMV; the device SpMV
is K3 (:mod:`repro_torch.kernels.spmv_ell`) on the block-ELL form that
:class:`repro_torch.sparse.amg.DeviceHierarchy` moves to the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray    # [n_rows + 1] int64
    indices: np.ndarray   # [nnz] int64 column ids
    data: np.ndarray      # [nnz] float64
    shape: tuple[int, int]

    # ------------------------------------------------------------ basics ----
    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def copy(self) -> "CSR":
        return CSR(self.indptr.copy(), self.indices.copy(), self.data.copy(),
                   self.shape)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "CSR":
        """Build CSR from COO triplets, summing duplicates."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        key = rows * shape[1] + cols
        order = np.argsort(key, kind="stable")
        key, vals = key[order], vals[order]
        uniq, starts = np.unique(key, return_index=True)
        summed = np.add.reduceat(vals, starts) if vals.size else vals
        r = (uniq // shape[1]).astype(np.int64)
        c = (uniq % shape[1]).astype(np.int64)
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr, c, summed, shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        out[rows, self.indices] = self.data
        return out

    # --------------------------------------------------------------- ops ----
    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x on the host in float64 (the device path is K3)."""
        prod = self.data * x[self.indices]
        out = np.zeros(self.n_rows)
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        np.add.at(out, rows, prod)
        return out

    def transpose(self) -> "CSR":
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        return CSR.from_coo(self.indices, rows, self.data,
                            (self.n_cols, self.n_rows))

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape))
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        on_diag = rows == self.indices
        d[rows[on_diag]] = self.data[on_diag]
        return d

    def scale_rows(self, s: np.ndarray) -> "CSR":
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        return CSR(self.indptr, self.indices, self.data * s[rows], self.shape)

    def matmul(self, B: "CSR", chunk_rows: int = 4096) -> "CSR":
        """C = A @ B — vectorized Gustavson (expand, sort, reduce) by chunks."""
        assert self.n_cols == B.n_rows, (self.shape, B.shape)
        n, m = self.n_rows, B.n_cols
        out_i: list[np.ndarray] = []
        out_j: list[np.ndarray] = []
        out_v: list[np.ndarray] = []
        Blen = B.row_lengths()
        for r0 in range(0, n, chunk_rows):
            r1 = min(r0 + chunk_rows, n)
            s, e = self.indptr[r0], self.indptr[r1]
            if s == e:
                continue
            a_rows = np.repeat(np.arange(r0, r1),
                               np.diff(self.indptr[r0:r1 + 1]))
            a_cols = self.indices[s:e]
            a_vals = self.data[s:e]
            cnt = Blen[a_cols]
            total = int(cnt.sum())
            if total == 0:
                continue
            # flat indices into B storage for each expanded product
            starts = B.indptr[a_cols]
            base = np.repeat(starts, cnt)
            csum = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            within = np.arange(total) - np.repeat(csum, cnt)
            flat = base + within
            ci = np.repeat(a_rows, cnt)
            cj = B.indices[flat]
            cv = np.repeat(a_vals, cnt) * B.data[flat]
            # reduce duplicates within the chunk
            key = ci * m + cj
            order = np.argsort(key, kind="stable")
            key, cv = key[order], cv[order]
            uniq, ustarts = np.unique(key, return_index=True)
            out_i.append((uniq // m).astype(np.int64))
            out_j.append((uniq % m).astype(np.int64))
            out_v.append(np.add.reduceat(cv, ustarts))
        if not out_i:
            return CSR(np.zeros(n + 1, dtype=np.int64),
                       np.zeros(0, dtype=np.int64), np.zeros(0), (n, m))
        rows = np.concatenate(out_i)
        cols = np.concatenate(out_j)
        vals = np.concatenate(out_v)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, cols, vals, (n, m))

    def __matmul__(self, other):
        if isinstance(other, CSR):
            return self.matmul(other)
        return self.spmv(np.asarray(other))

    def prune(self, tol: float = 0.0) -> "CSR":
        """Drop entries with |a_ij| <= tol."""
        keep = np.abs(self.data) > tol
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())[keep]
        indptr = np.zeros(self.n_rows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, self.indices[keep], self.data[keep], self.shape)



def eye(n: int) -> CSR:
    return CSR(np.arange(n + 1, dtype=np.int64),
               np.arange(n, dtype=np.int64), np.ones(n), (n, n))


def diag(d: np.ndarray) -> CSR:
    n = len(d)
    return CSR(np.arange(n + 1, dtype=np.int64),
               np.arange(n, dtype=np.int64), np.asarray(d, dtype=np.float64),
               (n, n))
