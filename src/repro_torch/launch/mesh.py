"""Production meshes as ``torch.distributed`` device meshes (counterpart
of ``repro.launch.mesh``).

Every function builds a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the default process group, which must already hold as many ranks as
the mesh.  :func:`fake_world` opens one of any size in this one process
with PyTorch's fake process group (its collectives return at once and
move nothing), the counterpart of the reference forcing 512 host devices
inside its dry run; :func:`one_rank_world` opens a real group of one rank
(NCCL on the card, gloo on the host).  Only one default group exists at a
time, so neither nests.
"""
from __future__ import annotations

import contextlib
import socket

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` with the axis names ``axes`` over the ranks of
    the default group, rank-major (the last axis innermost)."""
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_rank_mesh(n_ranks: int, device_type: str = "cpu") -> DeviceMesh:
    """1-D ``("rank",)`` mesh over ``n_ranks`` ranks.  Raises
    ``ValueError`` when the default group holds another number of ranks."""
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n_ranks:
        raise ValueError(
            f"make_rank_mesh({n_ranks}) needs a world of {n_ranks} ranks but "
            f"the default group holds {have}; open one with "
            "fake_world(n_ranks) to trace without devices")
    return make_mesh((n_ranks,), ("rank",), device_type)


def make_host_mesh(model_parallel: int = 1,
                   device_type: str = "cpu") -> DeviceMesh:
    """``("data", "model")`` mesh over every rank of the default group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel "
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), device_type)


def _open(backend: str, **kwargs) -> None:
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group is already open; worlds do not nest")
    dist.init_process_group(backend, **kwargs)


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """A default process group of ``n_ranks`` fake ranks, this process
    being ``rank``, destroyed on exit (errors included).  Raises
    ``RuntimeError`` when a default group is already open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _open("fake", store=FakeStore(), rank=rank, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_world(backend: str = "nccl"):
    """A real default process group of one rank (``backend`` ``"nccl"`` on
    the card, ``"gloo"`` on the host) on a free local port, destroyed on
    exit."""
    _open(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
          world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
