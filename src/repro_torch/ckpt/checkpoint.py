"""Checkpointing: atomic commits, async writes, content hashes and
resume-from-latest (counterpart of ``repro.ckpt.checkpoint``).

Layout per step, the reference's own, so a checkpoint written by either
package restores in the other::

    <dir>/step_<N>.tmp/          (written)
    <dir>/step_<N>/              (atomic rename on commit)
        manifest.json            leaf keys, shapes, dtypes, crc32s
        <flat_key>.npy           one file per leaf

A tree is nested dicts whose leaves are tensors, numpy arrays or numbers;
a leaf's key is its path joined by ``/`` (``params/layers/attn/wq``,
``opt/step``), as the reference's ``jax.tree_util`` paths give it for the
same tree, and bf16 is stored as float32.  Every leaf is copied to the
host before :func:`save_checkpoint` returns, so training may go on
updating its tensors in place while the writer thread serialises.
:func:`load_checkpoint`'s ``shardings`` restores onto the DTensor
placements of a given mesh (the elastic restore): a checkpoint written by
either package comes back laid out on any mesh, a stacked ``[L, ...]``
leaf split into its layers when the port's per-layer parameters ask for
that (:func:`repro_torch.parallel.sharding.checkpoint_shardings`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """The leaves of nested dicts keyed by their ``/``-joined paths, dict
    keys in sorted order (as ``jax.tree_util`` flattens them)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _flatten_layouts(tree, prefix: str = "") -> dict:
    """:func:`_flatten` for a ``shardings`` tree, whose leaves are tuples
    and lists."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten_layouts(tree[k],
                                    f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    if not isinstance(like, dict):
        return leaves[prefix]
    return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


def _host_copy(v) -> np.ndarray:
    """A leaf as a numpy array of its own (bf16 as float32, exactly)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(v)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def save_checkpoint(directory: str, step: int, tree,
                    wait: bool = True) -> threading.Thread:
    """Write a checkpoint of ``tree``; atomic commit by rename.

    ``wait=False`` returns once the leaves are on the host and writes them
    in a background thread (training continues while the step
    serialises)."""
    host = {k: _host_copy(v) for k, v in _flatten(tree).items()}

    def _write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype),
                                       "crc32": _crc(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if wait:
        t.join()
    return t


def latest_step(directory: str) -> int | None:
    """The newest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _distribute(arr: np.ndarray, like, sharding):
    """``arr`` in the like's dtype as a DTensor laid out by ``sharding``:
    ``(mesh, placements)``, or a list of them, one a layer of a stacked
    leaf (a list of DTensors, the leaf split along axis 0)."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
    if isinstance(sharding, list):
        if len(sharding) != t.shape[0]:
            raise ValueError(f"{len(sharding)} layer layouts for a stack of "
                             f"{t.shape[0]}")
        return [distribute_tensor(t[i].to(mesh.device_type), mesh, pl)
                for i, (mesh, pl) in enumerate(sharding)]
    mesh, pl = sharding
    return distribute_tensor(t.to(mesh.device_type), mesh, pl)


def load_checkpoint(directory: str, step: int, like_tree,
                    verify: bool = True, shardings=None):
    """Load a checkpoint into the structure of ``like_tree``: a tensor
    leaf comes back as a tensor on the like's device in its dtype, any
    other leaf as a numpy array in the like's dtype.  With ``verify``,
    each leaf's crc32 is checked first and a mismatch raises
    ``IOError``.

    ``shardings`` (the elastic restore): a tree like ``like_tree`` whose
    leaves are ``(mesh, placements)``; each leaf comes back a DTensor on
    that mesh (``distribute_tensor`` from the whole leaf), in the like's
    dtype.  A list of them for a stacked leaf gives a list of DTensors, one
    a layer."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    sh_leaves = None if shardings is None else _flatten_layouts(shardings)
    out = {}
    for key, like in _flatten(like_tree).items():
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {key}: crc "
                          f"{_crc(arr)} != {meta['crc32']}")
        if sh_leaves is not None:
            out[key] = _distribute(arr, like, sh_leaves[key])
        elif isinstance(like, torch.Tensor):
            out[key] = torch.from_numpy(arr).to(like.device, like.dtype)
        else:
            out[key] = arr.astype(np.asarray(like).dtype)
    return _unflatten(like_tree, out)


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-k manager with async writes and resume support."""

    directory: str
    keep: int = 3
    _pending: threading.Thread | None = None

    def save(self, step: int, tree, wait: bool = False):
        os.makedirs(self.directory, exist_ok=True)
        if self._pending is not None:
            self._pending.join()         # one outstanding async write max
        self._pending = save_checkpoint(self.directory, step, tree, wait=wait)
        if wait:
            self._gc()
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._gc()

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1])
                       for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, shardings=None):
        """(step, tree) of the newest committed checkpoint, or (None,
        None); ``shardings`` as :func:`load_checkpoint` takes it."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, load_checkpoint(self.directory, step, like_tree,
                                     shardings=shardings)
