"""Production meshes as ``torch.distributed`` device meshes (counterpart
of ``repro.launch.mesh``).

Every function builds a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the default process group, which must already hold as many ranks as
the mesh.  :func:`fake_world` opens one of any size in this one process
with PyTorch's fake process group (its collectives return at once and
move nothing), the counterpart of the reference forcing 512 host devices
inside its dry run; :func:`one_rank_world` opens a real group of one rank
(NCCL on the card, gloo on the host); :func:`run_ranks` runs a function on
a real world of ranks as threads of this process (PyTorch's threaded
process group, whose collectives are copies between the ranks' tensors),
the counterpart of the reference forcing 8 host devices: on one card,
every rank computes and exchanges on that card.  Only one default group
exists at a time, so none of them nests.
"""
from __future__ import annotations

import contextlib
import socket
import threading
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


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


def run_ranks(n_ranks: int, fn, *args, device=None,
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on a world of ``n_ranks`` ranks, each a
    thread of this process in its own default group of PyTorch's threaded
    backend, and return the results in rank order.

    ``device`` (``None`` = CUDA, raising without it; the CPU only when
    asked for) is made current in every thread, and on the card the
    kernels are built before the threads start.  All ranks share the
    device and its default stream, so their work runs one launch after
    another on it.  If a rank raises, the ranks waiting in a collective
    are released and the first exception is raised here; a world not done
    after ``timeout`` seconds is released and ``TimeoutError`` raised
    (a rank thread hung outside a collective may then outlive the world:
    the threads are daemons and are not killed).  The threaded backend is
    installed for the run only: the default group and autograd's
    multithreading flag are restored after, and the process-group
    registry's thread isolation, which torch offers no way to read, is
    turned on for the run and off after, as torch's own threaded tests do.
    Raises ``RuntimeError`` when a default group is already open: worlds
    do not nest.
    """
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group is already open; worlds do not nest")
    if dev.type == "cuda":
        from repro_torch.kernels.build import build_kernels
        build_kernels()
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
    store = dist.HashStore()
    results = [None] * n_ranks
    failures = []                       # (rank, exception), first first
    lock = threading.Lock()

    def rank_main(rank):
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(index)
            dist.init_process_group("threaded", rank=rank,
                                    world_size=n_ranks, store=store)
            try:
                results[rank] = fn(rank, *args)
            finally:
                dist.destroy_process_group()
        except BaseException as exc:    # raised again by run_ranks
            with lock:
                failures.append((rank, exc))
            # wakes every rank waiting in a collective (they exit)
            mtpg.ProcessLocalGroup.exception_handle(exc)

    multithreading = torch._C._is_multithreading_enabled()
    mtpg.ProcessLocalGroup.reset()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = mtpg._install_threaded_pg()
    if not hasattr(world, "comms"):
        # torch 2.11's threaded world lacks the list of communicators that
        # its destroy_process_group reads (2.13 has it)
        world.comms = []
    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                name=f"rank-{r}") for r in range(n_ranks)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, t in enumerate(threads) if t.is_alive()]
        if hung:
            mtpg.ProcessLocalGroup.exception_handle(None)
            for t in threads:
                t.join(5.0)
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        torch._C._set_multithreading_enabled(multithreading)
        mtpg.ProcessLocalGroup.reset()
    raised = [(r, e) for r, e in failures if not isinstance(e, SystemExit)]
    if raised:
        rank, exc = raised[0]
        exc.add_note(f"raised on rank {rank} of {n_ranks}")
        raise exc
    if hung:
        raise TimeoutError(f"ranks {hung} of {n_ranks} were not done after "
                           f"{timeout} s")
    if failures:
        raise RuntimeError(f"ranks {[r for r, _ in failures]} of {n_ranks} "
                           "exited")
    return results
