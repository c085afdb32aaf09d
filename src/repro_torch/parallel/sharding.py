"""Sharding rules: parameter / batch / cache layouts per architecture, and
their DTensor placements (counterpart of ``repro.parallel.sharding``).

Baseline layout (what the dry run traces):

* **DP** over ``("pod", "data")`` (or ``("data",)`` single-pod): batch dims.
* **TP** over ``"model"``: attention head projections, MLP hidden, vocab.
* **EP** over ``"model"``: MoE expert dimension (experts are co-sharded with
  TP — the standard "experts replace MLP shards" layout).
* **SP** over ``"model"`` for decode KV caches where the KV heads and the
  head dim do not divide.

Every rule degrades to replication when a dimension is not divisible by the
axis size (e.g. whisper's 51865 vocab), so all 10 archs trace on the same
mesh and no shard is ever uneven.

A layout is a tuple with one entry a tensor dim: None (replicated), an
axis name, or a tuple of axis names (the dim split over several axes, the
first outermost), entry for entry the reference's ``PartitionSpec``.  The
rules run on the reference's stacked ``[L, ...]`` shapes
(:func:`repro_torch.nn.model.param_shapes`); a parameter of one layer of
the port's ``nn.ModuleList`` takes its stack's layout with axis 0 dropped,
which no rule shards.  :func:`shardings` turns layouts into DTensor
placements, one a mesh dim; a dim split over ``("pod", "data")`` is
``Shard(dim)`` on both, pod-major as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.nn import model as M
from repro_torch.nn.config import ArchConfig

from .context import axis_sizes, dp_spec

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: object                  # a DeviceMesh, or {axis name: size}
    dp_axes: tuple[str, ...]      # ("pod", "data") or ("data",)
    model_axis: str = MODEL_AXIS

    @property
    def sizes(self) -> dict:
        return axis_sizes(self.mesh)

    @property
    def dp_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp_axes)

    @property
    def model_size(self) -> int:
        return int(self.sizes[self.model_axis])

    def dp_spec_for(self, batch: int):
        """Largest prefix of dp axes that divides ``batch`` (1 -> None)."""
        return dp_spec(self.sizes, self.dp_axes, batch)


def make_mesh_plan(mesh) -> MeshPlan:
    """The plan of a ``DeviceMesh`` (or of ``{axis name: size}`` in mesh
    order): every axis but ``"model"`` is a data axis."""
    names = tuple(axis_sizes(mesh))
    return MeshPlan(mesh=mesh,
                    dp_axes=tuple(a for a in names if a != MODEL_AXIS))


def _leaf_map(fn, shapes: dict, path=()):
    """``fn(path, shape)`` over a nested dict of shape tuples."""
    return {k: (_leaf_map(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in shapes.items()}


def _tree_map(fn, tree: dict, path=()):
    """``fn(path, leaf)`` over a nested dict of tensors (or shapes)."""
    return {k: (_tree_map(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


# ------------------------------------------------------------- params -------
def _param_rule(names: tuple, shape: tuple, cfg: ArchConfig, tp: int):
    """Layout of one parameter leaf (names = path, shape incl. [L])."""
    name = names[-1]
    group = names[-2] if len(names) >= 2 else ""
    nd = len(shape)

    def last_dim_tp():
        specs = [None] * nd
        if shape[-1] % tp == 0:
            specs[-1] = MODEL_AXIS
        return tuple(specs)

    def dim_tp(axis_from_end: int):
        specs = [None] * nd
        if shape[nd - axis_from_end] % tp == 0:
            specs[nd - axis_from_end] = MODEL_AXIS
        return tuple(specs)

    if name == "embed":
        return (MODEL_AXIS, None) if shape[0] % tp == 0 else (None, None)
    if name == "lm_head":
        return (None, MODEL_AXIS) if shape[1] % tp == 0 else (None, None)
    if name == "frontend_proj":
        return last_dim_tp()
    if name in ("scale", "bias", "q_norm", "k_norm", "A_log", "D", "dt_bias",
                "norm", "conv_w", "conv_b", "router"):
        return (None,) * nd
    if group in ("attn", "xattn"):
        if name in ("wq", "wk", "wv"):
            return last_dim_tp()        # column-parallel
        if name == "wo":
            return dim_tp(2)            # row-parallel
    if group == "moe":
        if name in ("w1", "w2", "w3"):
            # [L, E, d, f] / [L, E, f, d]: shard experts (EP == TP axis)
            specs = [None] * nd
            if shape[1] % tp == 0:
                specs[1] = MODEL_AXIS
            return tuple(specs)
        if name.startswith("shared_"):
            return last_dim_tp() if name in ("shared_w1", "shared_w3") \
                else dim_tp(2)
    if group == "mlp":
        if name in ("w1", "w3"):
            return last_dim_tp()
        if name == "w2":
            return dim_tp(2)
    if group == "ssm":
        if name == "in_proj":
            return last_dim_tp()
        if name == "out_proj":
            return dim_tp(2)
    return (None,) * nd


def _add_data_sharding(spec: tuple, shape: tuple, plan: MeshPlan,
                       skip_leading: bool = True) -> tuple:
    """Shard one replicated dim over the data axes (ZeRO / FSDP style).

    Prefers a non-leading dim (so a stacked leaf's layer axis stays whole:
    the port's per-layer parameters drop it).  Uses the innermost data axis
    ("data", not "pod") — DCN-crossing weight gathers would be
    pathological.
    """
    axis = plan.dp_axes[-1]
    size = plan.sizes[axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if axis in parts:                 # already data-sharded (FSDP + ZeRO-1)
        return spec
    start = 1 if (skip_leading and len(shape) > 1) else 0
    for i in range(start, len(shape)):
        if parts[i] is None and shape[i] % size == 0 and shape[i] >= size:
            parts[i] = axis
            return tuple(parts)
    return spec


def param_pspecs(cfg: ArchConfig, plan: MeshPlan, fsdp: bool = False):
    """Nested dict of layouts matching ``param_shapes(cfg)``.

    ``fsdp=True`` additionally shards every parameter over the data axis
    (ZeRO-3 style) — used for >20B-parameter training cells where even
    TP-sharded bf16 weights + grads exceed HBM.
    """
    tp = plan.model_size

    def rule(path, sh):
        spec = _param_rule(path, sh, cfg, tp)
        if fsdp:
            spec = _add_data_sharding(spec, sh, plan)
        return spec

    return _leaf_map(rule, M.param_shapes(cfg))


def zero1_pspecs(param_specs, cfg: ArchConfig, plan: MeshPlan):
    """Optimizer-moment layouts: parameter layouts + data-axis sharding
    (ZeRO-1)."""
    return _leaf_map(
        lambda p, sh: _add_data_sharding(lookup(param_specs, p), sh, plan),
        M.param_shapes(cfg))


def lookup(tree, path):
    """The leaf of the nested dict ``tree`` at ``path``."""
    node = tree
    for k in path:
        node = node[k]
    return node


# -------------------------------------------------------------- batch -------
def batch_pspecs(plan: MeshPlan, batch_tree):
    """Layouts matching a batch dict of tensors (``meta`` ones too).

    Every leading dim is treated as batch (DP-sharded when divisible);
    remaining dims replicated.
    """
    def rule(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        dp = plan.dp_spec_for(leaf.shape[0])
        return (dp,) + (None,) * (len(leaf.shape) - 1)

    if not isinstance(batch_tree, dict):
        return rule((), batch_tree)
    return _tree_map(rule, batch_tree)


def cache_pspecs(plan: MeshPlan, cache_tree):
    """Decode-cache layouts: batch over DP, and KV heads, the head dim or
    the sequence over the model axis."""
    tp = plan.model_size

    def rule(path, leaf):
        name = path[-1]
        sh = tuple(leaf.shape)
        dp = plan.dp_spec_for(sh[1]) if len(sh) > 1 else None
        if name in ("k", "v"):
            # [L, B, S, KH, hd]: shard a dim whose update index is static so
            # the per-token cache write stays shard-local — KV heads first,
            # head_dim second, the sequence last
            if sh[3] % tp == 0:
                return (None, dp, None, MODEL_AXIS, None)
            if sh[4] % tp == 0:
                return (None, dp, None, None, MODEL_AXIS)
            seq_ax = MODEL_AXIS if sh[2] % tp == 0 else None
            return (None, dp, seq_ax, None, None)
        if name in ("k_scale", "v_scale"):
            if sh[3] % tp == 0:
                return (None, dp, None, MODEL_AXIS)
            return (None, dp, None, None)
        if name == "conv":
            return (None, dp, None, None)
        if name == "ssd":
            # [L, B, H, N, P]: shard heads when divisible
            h_ax = MODEL_AXIS if sh[2] % tp == 0 else None
            return (None, dp, h_ax, None, None)
        if name == "enc_out":
            return (None, dp, None, None)
        return (None,) * len(sh)

    return _tree_map(rule, cache_tree)


# ---------------------------------------------------------- placements ------
def placements(spec: tuple, mesh, shape: tuple | None = None) -> tuple:
    """DTensor placements (one a mesh dim) of the layout ``spec``.

    A dim split over several axes is ``Shard(dim)`` on each, which DTensor
    splits outermost first in mesh order: the axes must come in mesh
    order, as the reference's rules give them.  With ``shape``, checks
    that every sharded dim divides evenly (the rules never make an uneven
    shard)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"layout {spec}: axes {axes} of dim {dim} out "
                             f"of mesh order {names}")
        parts = math.prod(sizes[a] for a in axes)
        if shape is not None and shape[dim] % parts:
            raise ValueError(f"layout {spec} splits dim {dim} of {shape} "
                             f"into {parts} uneven shards")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def shardings(tree_of_specs, mesh):
    """Layout tree -> tree of DTensor placement tuples on ``mesh``."""
    if isinstance(tree_of_specs, tuple):
        return placements(tree_of_specs, mesh)
    return _tree_map(lambda p, s: placements(s, mesh), tree_of_specs)


def place(t: torch.Tensor, mesh, spec: tuple) -> DTensor:
    """``t`` (the whole tensor) as a DTensor laid out by ``spec``.  A
    ``meta`` tensor becomes its local shard's ``meta`` tensor, with no
    collective; any other is split by ``distribute_tensor``."""
    pl = placements(spec, mesh, tuple(t.shape))
    if t.device.type != "meta":
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, mesh, pl)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
        run_check=False, shape=t.shape, stride=t.stride())


def layer_spec(spec: tuple, name: str) -> tuple:
    """The layout of the :class:`~repro_torch.nn.model.Model` parameter
    ``name``: its stack's layout with axis 0 (the layers) dropped for a
    parameter of a stack, which must not shard that axis."""
    _, i = M.leaf_path(name)
    if i is None:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"{name}: a stacked layout may not shard the layer "
                         f"axis, got {spec}")
    return tuple(spec[1:])


@torch.no_grad()
def distribute_model(model, pspecs, mesh):
    """``model``'s parameters as DTensors laid out by ``pspecs``
    (:func:`param_pspecs`' tree), in place; returns the model."""
    for name, p in list(model.named_parameters()):
        path, _ = M.leaf_path(name)
        spec = layer_spec(lookup(pspecs, path), name)
        *owner, leaf = name.split(".")
        mod = model.get_submodule(".".join(owner)) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(place(p.data, mesh, spec),
                                              requires_grad=p.requires_grad))
    return model


def checkpoint_shardings(cfg: ArchConfig, pspecs, mesh) -> dict:
    """The ``shardings`` tree that :func:`repro_torch.ckpt.load_checkpoint`
    takes to restore a parameter tree in the reference's stacked layout
    (``params_to_numpy``'s) onto ``mesh`` as the port's model lays it out:
    ``(mesh, placements)`` a leaf, a list of them (one a layer, the layer
    axis dropped) for a stacked leaf."""
    def rule(path, sh):
        spec = lookup(pspecs, path)
        if path[0] in M.STACKS:
            name = f"{path[0]}.0.{'.'.join(path[1:])}"
            one = placements(layer_spec(spec, name), mesh, tuple(sh[1:]))
            return [(mesh, one)] * sh[0]
        return (mesh, placements(spec, mesh, tuple(sh)))
    return _leaf_map(rule, M.param_shapes(cfg))
