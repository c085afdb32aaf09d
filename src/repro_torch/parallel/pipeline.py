"""GPipe-style pipeline parallelism over a mesh axis (default: "pod")
(counterpart of ``repro.parallel.pipeline``).

Multi-pod note: inter-pod bandwidth is far below the links inside a pod,
so the pod axis is the natural pipeline boundary — each pod holds a
contiguous stage of layers and only [microbatch, seq, d_model]
activations cross between pods per tick, instead of per-layer
collectives.  The schedule is plain GPipe: M microbatches flow through S
stages in M + S - 1 ticks, one :func:`~repro_torch.parallel.collectives.
ppermute` on the ring ``i -> (i + 1) % S`` a tick; every stage computes on
every tick, and the bubble ticks' results are masked out
(:mod:`repro_torch.workloads.pipe` prices this schedule).

``gpipe`` is generic over a ``stage_fn(stage_params, x) -> y`` with
matching x/y shapes (transformer blocks) and runs on every rank of the
axis' process group.  Forward only: the collectives carry no gradient.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .collectives import axis_group, axis_index, axis_size, ppermute, psum


def stack_stages(layer_params, n_stages: int):
    """Per-layer parameters -> per-stage parameters: a pytree of ``[L,
    ...]`` stacked leaves becomes ``[S, L/S, ...]`` stage-major leaves, as
    in the reference; a list of L layers (a model's ``ModuleList``)
    becomes a list of S lists of L/S consecutive layers."""
    if isinstance(layer_params, (list, tuple, torch.nn.ModuleList)):
        L = len(layer_params)
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        k = L // n_stages
        return [list(layer_params[s * k:(s + 1) * k])
                for s in range(n_stages)]

    def f(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return pytree.tree_map(f, layer_params)


def _stage_of(stage_params, s: int):
    """Stage ``s``'s parameters: entry ``s`` of a list of stages, or the
    ``s``-th slice of each leaf with a leading stage dim."""
    if isinstance(stage_params, (list, tuple)):
        return stage_params[s]
    return pytree.tree_map(lambda a: a[s], stage_params)


def gpipe(stage_fn, stage_params, microbatches: torch.Tensor, mesh=None,
          axis: str = "pod") -> torch.Tensor:
    """Run microbatches through the pipeline stages laid out on ``mesh``'s
    axis ``axis`` (the default group when ``mesh`` is None); called on
    every rank of it.

    stage_fn: (per-stage params, x [mb, ...]) -> y [mb, ...]
    stage_params: leaves with a leading stage dim S (the axis' size), or
    a list of S stages (:func:`stack_stages`)
    microbatches: [M, mb, ...], the same on every rank
    Returns [M, mb, ...]: the last stage's outputs, on every rank.
    """
    group = axis_group(mesh, axis)
    S, s = axis_size(group), axis_index(group)
    M = microbatches.shape[0]
    perm = [(i, (i + 1) % S) for i in range(S)]
    p = _stage_of(stage_params, s)
    carry = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        recv = ppermute(carry, perm, group)
        x_in = microbatches[min(t, M - 1)] if s == 0 else recv
        carry = stage_fn(p, x_in)
        if s == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = carry
    # every stage but the last holds zeros: the sum broadcasts its outputs
    return psum(outs, group)
