"""Compressed-sparse-row matrices in pure numpy.

Implements the operations the AMG hierarchy needs: transpose, diagonal,
pruning and a vectorized Gustavson SpGEMM (row-chunked expand/sort/reduce,
no Python inner loops).

Port note: host-side construction; the sparse substrate stays numpy and only
its communication patterns reach the device.
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

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

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

    # --------------------------------------------------------------- ops ----
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

    def prune(self, tol: float = 0.0) -> "CSR":
        """Drop entries with |a_ij| <= tol."""
        keep = np.abs(self.data) > tol
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())[keep]
        indptr = np.zeros(self.n_rows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, self.indices[keep], self.data[keep], self.shape)

