"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` beside this module is one kernel source with a plain C
interface; ``csrc/*.cuh`` are headers they share.  :func:`build_kernels`
compiles each source that has no library yet with ``nvcc`` for ``sm_90a``
into ``_build/`` (one shared library per source, all compiled at once,
named by a hash of source, headers and flags), and
:func:`kernel` binds one of its entry points with ``ctypes``.  Nothing is
compiled when the module is imported, and nothing here runs on a host
without a CUDA device: the kernel modules reach it only for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
#: Kernel source per library name (the file's stem).
SOURCES = {p.stem: p.name for p in sorted(CSRC.glob("*.cu"))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# serialises builds within a process: two threads making a first call at
# once would otherwise both compile the same library
_BUILD_LOCK = threading.Lock()
# serialises the launch counts: ranks run as threads launch at once
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the shared library of source ``name`` is built: the name
    carries a hash of the source, the shared headers and the compiler
    flags, so an edit to any of them builds a new library."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_kernels() -> dict[str, str]:
    """Compile every kernel source that has no library yet, one ``nvcc``
    process per source, all started together.  Returns each compiled
    source's compiler output (``-Xptxas -v``: registers, spills); a failed
    compile raises with its output after every process has ended.

    A module lock lets one build run at a time in a process: a second
    caller waits, then finds the libraries built, so two threads making a
    first call at once cannot compile into the same temporary file."""
    with _BUILD_LOCK:
        return _build_missing()


def _build_missing() -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, src in SOURCES.items():
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def kernel(library: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of library ``library``, bound with
    ``argtypes`` plus a trailing stream pointer (built on first use)."""
    build_kernels()
    fn = getattr(ctypes.CDLL(str(library_path(library))), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def count(launches: dict, *names: str) -> None:
    """Add one to each of ``names`` in the launch counts ``launches``,
    under a lock: the ranks of ``launch.mesh.run_ranks`` are threads that
    launch at once, and ``+=`` on a dict entry is no atomic operation."""
    with _COUNT_LOCK:
        for name in names:
            launches[name] += 1


def launch(fn, device: torch.device, *args) -> None:
    """Call the bound entry point ``fn`` on ``device``'s current stream and
    raise if it reports a CUDA error (a refused launch never runs, and a
    later synchronize would not report it).  The device is made current
    only when it is not already, and the stream is read as a raw pointer:
    the host time of a small kernel's call is mostly this wrapper's."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA "
                           f"error {err}")
