"""d-dimensional torus topology: dense link ids and dimension-ordered routes.

The paper's contention model assumes the job occupies a perfect cube of Blue
Waters' 3-D Gemini torus (Fig. 8) and estimates the bytes crossing the hottest
link as ``ell = 2 * h^d * b * ppn`` where ``h`` is the average hops per byte.
The torus dimension is a parameter.

Port note: :meth:`TorusTopology.route_link_ids` runs as torch ops on the
device of its inputs (the arena's device) — one segment expansion per torus
dimension (``repeat_interleave`` + ``cumsum``), no per-message loop.  The
cube-partition estimate is scalar host arithmetic that also accepts tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class TorusTopology:
    """A torus with extent ``dims[i]`` in dimension ``i`` (row-major ranks)."""

    dims: tuple[int, ...]
    wrap: bool = True   # tori wrap; a job partition inside a larger torus may not

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def link_slots(self) -> int:
        """Size of the dense link-id space: link (node, dim) <-> node*ndim+dim."""
        return self.size * self.ndim

    def strides(self) -> tuple[int, ...]:
        """Row-major rank stride of each dimension."""
        s = [1] * self.ndim
        for i in range(self.ndim - 2, -1, -1):
            s[i] = s[i + 1] * self.dims[i + 1]
        return tuple(s)

    def coords(self, rank: torch.Tensor) -> torch.Tensor:
        """Ranks ``[n]`` -> coordinates ``[n, ndim]`` (int64, same device)."""
        out = torch.empty(rank.shape + (self.ndim,), dtype=torch.int64,
                          device=rank.device)
        rem = rank.to(torch.int64)
        for i in range(self.ndim - 1, -1, -1):
            out[..., i] = rem % self.dims[i]
            rem = rem // self.dims[i]
        return out

    def _dim_delta(self, a: torch.Tensor, b: torch.Tensor,
                   i: int) -> torch.Tensor:
        """Signed minimal step count along dimension ``i``."""
        if not self.wrap:
            return b - a
        d = (b - a) % self.dims[i]
        alt = d - self.dims[i]            # the other way around the ring
        return torch.where(alt.abs() < d, alt, d)

    def route_link_ids(self, a: torch.Tensor, b: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dimension-ordered routing over message tensors.

        For messages ``a[k] -> b[k]`` (torus-unit ranks), emit every
        traversed link as a pair ``(message index k, dense link id
        node*ndim + dim)``; the id names the undirected link between
        ``node`` and its +1 neighbour along ``dim``.  All messages' hops
        along dimension ``i`` are emitted at once, with coordinates
        ``dims < i`` already at the destination and ``dims > i`` still at
        the source.  Both outputs are int64 on the inputs' device, in
        dimension-major order.
        """
        a = a.reshape(-1).to(torch.int64)
        b = b.reshape(-1).to(torch.int64)
        dev = a.device
        ca, cb = self.coords(a), self.coords(b)
        strides = self.strides()
        n = a.numel()
        ids = torch.arange(n, device=dev)
        msg_parts: list[torch.Tensor] = []
        link_parts: list[torch.Tensor] = []
        for i in range(self.ndim):
            delta = self._dim_delta(ca[:, i], cb[:, i], i)
            hops = delta.abs()
            total = int(hops.sum())
            if total == 0:
                continue
            msg = torch.repeat_interleave(ids, hops, output_size=total)
            first = torch.cumsum(hops, 0) - hops
            k = torch.arange(total, device=dev) - first[msg]  # 0..hops-1
            down = (delta < 0)[msg]
            c0 = ca[msg, i]
            # +1 steps own the link at the pre-step coord; -1 steps at the
            # post-step coord (normalized to the lower-coordinate node)
            coord = torch.where(down, c0 - k - 1, c0 + k) % self.dims[i]
            base = torch.zeros(n, dtype=torch.int64, device=dev)
            for j in range(self.ndim):
                if j != i:
                    cj = cb[:, j] if j < i else ca[:, j]
                    base = base + cj * strides[j]
            node = base[msg] + coord * strides[i]
            msg_parts.append(msg)
            link_parts.append(node * self.ndim + i)
        if not msg_parts:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            return z, z.clone()
        return torch.cat(msg_parts), torch.cat(link_parts)


# -- the paper's cube-partition estimate -----------------------------------

def cube_side(n_units: int, ndim: int) -> int:
    """Side length of the smallest ndim-cube holding n_units torus nodes."""
    return max(1, math.ceil(n_units ** (1.0 / ndim) - 1e-9))


def average_hops(n_units: int, ndim: int) -> float:
    """Average hops ``h`` per byte under the perfect-cube assumption.

    For uniform random endpoints on a line of length c (no wraparound inside
    the job partition), E|i-j| = (c^2-1)/(3c); L1 distance sums over ndim
    dimensions.
    """
    c = cube_side(n_units, ndim)
    if c <= 1:
        return 0.0
    per_dim = (c * c - 1.0) / (3.0 * c)
    return ndim * per_dim


def contention_ell(n_units: int, ndim: int, avg_bytes_per_proc, ppn: int):
    """The paper's Eq. (7): ell = 2 * h^d * b * ppn.

    ``h^d`` estimates how many torus nodes are within ``h`` hops of a given
    link and ``2*b*ppn`` is the average bytes leaving each torus node.
    ``avg_bytes_per_proc`` may be a float or a tensor of per-phase values.
    """
    h = average_hops(n_units, ndim)
    return 2.0 * (h ** ndim) * avg_bytes_per_proc * ppn
