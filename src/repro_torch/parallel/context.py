"""Ambient sharding context for model-internal layout constraints
(counterpart of ``repro.parallel.context``).

The model code is mesh-agnostic; when a :class:`ShardingContext` is active
(the dry run sets it) and the activations are DTensors, the model
redistributes them at layer boundaries:

* residual stream [B, S, d] -> (dp, "model", None)  (Megatron-style
  sequence sharding: the tensor-parallel all-reduces become
  reduce-scatter / all-gather pairs and per-rank activation memory drops by
  the TP degree);
* the MoE token groups and capacity buffer to (dp, ...), experts on
  "model".

This is the *production default*; the §Perf baselines toggle these off to
quantify their effect.  A layout is the port's spelling of a
``PartitionSpec``: a tuple with one entry a tensor dim, each None, an axis
name or a tuple of axis names (:mod:`repro_torch.parallel.sharding`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_STATE = threading.local()


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_spec(sizes: dict, dp_axes, batch: int):
    """Largest prefix of the dp axes whose sizes divide ``batch`` (None
    when none does; one name, or a tuple of names)."""
    axes = []
    rem = batch
    for a in dp_axes:
        s = sizes[a]
        if rem % s == 0 and rem >= s:
            axes.append(a)
            rem //= s
        else:
            break
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    mesh: object                    # a DeviceMesh
    dp_axes: tuple[str, ...]
    model_axis: str = "model"
    seq_shard: bool = True          # sequence-shard residual stream
    q_chunk: int = 1024             # the reference's attention block
    unroll_loops: bool = False      # the reference's scan unrolling

    def __post_init__(self):
        # K4 is blockwise with its own tiles and the layer loops are
        # Python: the port takes neither setting, so it refuses any value
        # but the reference's default rather than ignore it
        if self.q_chunk != 1024:
            raise ValueError(f"q_chunk {self.q_chunk}: K4 is blockwise and "
                             "takes no query-chunk size (only the "
                             "reference's 1024)")
        if self.unroll_loops:
            raise ValueError("unroll_loops: the port's layer loops are "
                             "Python loops, traced unrolled always")

    def residual_sharding(self, batch: int, seq: int):
        """Layout of a [B, S, d] residual, or None if not applicable."""
        if not self.seq_shard:
            return None
        sizes = axis_sizes(self.mesh)
        if seq % sizes[self.model_axis] != 0:
            return None
        return (dp_spec(sizes, self.dp_axes, batch), self.model_axis, None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def constrain(t, spec):
    """``t`` redistributed to the layout ``spec`` when a context is active
    and ``t`` is a DTensor (the counterpart of the reference's
    ``with_sharding_constraint``); else ``t`` itself."""
    ctx = current()
    if ctx is None or spec is None or not is_dtensor(t):
        return t
    from .sharding import placements
    pl = placements(tuple(spec), t.device_mesh)
    return t if tuple(t.placements) == pl else t.redistribute(
        t.device_mesh, pl)


def replicate_dims(t, dims):
    """DTensor ``t`` with every mesh dim that shards a tensor dim in
    ``dims`` (negative counts from the end) replicated; any other tensor
    is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % t.ndim for d in dims}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def reduce_output(y):
    """A mixer's output [B, S, d] under the ambient context: the DTensor
    ``y`` (partial sums over the model axis after a row-parallel product)
    laid out as the residual it is added to: reduce-scattered to the
    sequence-sharded layout under ``seq_shard`` (where the sequence
    divides), else all-reduced (Megatron's all-reduce after each
    row-parallel product, in the activations' dtype); else ``y``
    itself."""
    ctx = current()
    if ctx is None or not is_dtensor(y):
        return y
    spec = ctx.residual_sharding(y.shape[0], y.shape[1])
    if spec is None:
        spec = (dp_spec(axis_sizes(ctx.mesh), ctx.dp_axes, y.shape[0]),
                None, None)
    return constrain(y, spec)


def vocab_parallel_embedding(tokens, table):
    """Rows of the DTensor ``table`` [V, d] at ``tokens`` (Megatron's
    vocab-parallel embedding, through ``local_map``): each rank looks up
    the tokens in its own vocab shard and zeroes the rest, so the result
    is a partial sum over the model axis (``Partial``), not a gathered
    table.  The table is whole over the other axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    ctx = current()
    model_axis = ctx.model_axis if ctx is not None else "model"
    names = tuple(mesh.mesh_dim_names)
    split = tuple(n == model_axis and p == Shard(0)
                  for n, p in zip(names, table.placements))
    w_pl = tuple(Shard(0) if s else Replicate() for s in split)
    t_pl = tuple(Replicate() if n == model_axis else p
                 for n, p in zip(names, tokens.placements))
    o_pl = tuple(Partial() if s else p for s, p in zip(split, t_pl))
    v_local = table.shape[0]
    offset = 0
    for s, n, size in zip(split, names, mesh.shape):
        if s:
            v_local //= size
            offset = mesh.get_local_rank(n) * v_local

    def lookup(tok, w):
        if v_local == table.shape[0]:
            return torch.nn.functional.embedding(tok, w)
        local = tok - offset
        hit = (local >= 0) & (local < v_local)
        rows = torch.nn.functional.embedding(local.clamp(0, v_local - 1), w)
        return torch.where(hit[..., None], rows, 0)

    split = tuple(isinstance(p, Shard) for p in t_pl)
    mapped = local_map(lookup, out_placements=(o_pl,),
                       in_placements=(t_pl, w_pl),
                       in_grad_placements=grad_placements((t_pl, w_pl),
                                                          split),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(tokens, table)


def local_op(fn, t):
    """``fn`` (which keeps the layout: it changes no sharded dim) on each
    rank's shard of the DTensor ``t``, the result laid out as ``t``."""
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(t.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=t.device_mesh)(t)


def grad_placements(in_pl, split):
    """Each ``local_map`` input's gradient placements: where a mesh dim
    divides the work among its ranks (``split``, a flag a mesh dim) and
    an input is whole on it, each rank's gradient of that input is its
    share of a sum (``Partial``); elsewhere the gradient is laid out as
    the input."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(tuple(Partial() if s and p == Replicate() else p
                       for s, p in zip(split, pl)) for pl in in_pl)


def local_product(x, w):
    """``x @ w`` for a DTensor ``x`` [..., k] and a weight ``w`` [k, n],
    rank by rank: each rank multiplies its own rows of ``x`` (split over
    any dims but the last) by the whole ``w``, so no rank multiplies
    another's rows and no collective runs but the gathers of ``w`` (an
    FSDP layout).  The weight's gradient is a partial sum over the mesh
    dims that split ``x``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x = replicate_dims(x, [-1])
    x_pl = tuple(x.placements)
    w_pl = tuple(Replicate() for _ in x_pl)
    split = tuple(isinstance(p, Shard) for p in x_pl)
    return local_map(lambda a, b: a @ b, out_placements=(x_pl,),
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=grad_placements((x_pl, w_pl), split),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def gather_model(x):
    """A mixer's input under the ambient context: the DTensor ``x`` whole
    over the model axis (its sequence gathered, Megatron-SP's all-gather
    before the column-parallel products); else ``x`` itself."""
    if current() is None or not is_dtensor(x):
        return x
    return _replicate_model(x)


def model_size(t) -> int:
    """Size of the ambient model axis in the DTensor ``t``'s mesh (1 where
    the mesh has none)."""
    names = tuple(t.device_mesh.mesh_dim_names)
    axis = _model_axis()
    return t.device_mesh.shape[names.index(axis)] if axis in names else 1


def model_shards(t, dim: int) -> bool:
    """Whether the model axis splits the DTensor ``t``'s dim ``dim``."""
    from torch.distributed.tensor import Shard
    names = tuple(t.device_mesh.mesh_dim_names)
    axis = _model_axis()
    return any(n == axis and p == Shard(dim % t.ndim)
               for n, p in zip(names, t.placements))


def _model_axis() -> str:
    ctx = current()
    return ctx.model_axis if ctx is not None else "model"


def shard_parts(t, dim: int) -> int:
    """Into how many parts the mesh splits the DTensor ``t``'s ``dim``."""
    from torch.distributed.tensor import Shard
    parts = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            parts *= size
    return parts


def _local_reshape(t, local_shape, placements):
    """The DTensor ``t`` reshaped rank by rank (each shard to
    ``local_shape(shard)``), laid out by ``placements``: a reshape of a
    sharded dim that keeps each rank's rows, done locally."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(lambda a: a.reshape(local_shape(a)),
                     out_placements=(tuple(placements),),
                     in_placements=(tuple(t.placements),),
                     device_mesh=t.device_mesh)(t)


def split_dim(t, shape, dim: int = -1):
    """``t.reshape(shape)`` where ``shape`` splits ``t``'s dim ``dim`` in
    two (``shape[dim]`` outer).  A DTensor's split runs rank by rank, its
    shards of ``dim`` becoming shards of the outer part; where the parts
    do not divide ``shape[dim]`` (they would cut rows of the split), the
    dim is gathered first."""
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Shard
    dim = dim % t.ndim
    if shape[dim] % shard_parts(t, dim):
        t = replicate_dims(t, [dim])
    inner = shape[dim + 1]
    out = tuple(Shard(p.dim + 1) if isinstance(p, Shard) and p.dim > dim
                else p for p in t.placements)
    return _local_reshape(
        t, lambda a: a.shape[:dim] + (a.shape[dim] // inner, inner)
        + a.shape[dim + 1:], out)


def reshape_rows(t, shape):
    """``t.reshape(shape)`` where only the leading dim is split over the
    ranks (as a batch of rows is): a DTensor reshapes rank by rank, its
    rows staying put, so the new leading dim is sharded as the old one
    was (every other sharded dim is gathered first).  ``shape[0]`` must
    divide into the ranks' parts."""
    if not is_dtensor(t):
        return t.reshape(shape)
    t = replicate_dims(t, range(1, t.ndim))
    parts = shard_parts(t, 0)
    if shape[0] % parts:
        raise ValueError(f"{shape[0]} rows do not split into {parts} parts")
    return _local_reshape(t, lambda a: (shape[0] // parts,) + tuple(
        shape[1:]), t.placements)


def merge_dims(t, dim: int):
    """``t`` with dims ``dim`` and ``dim + 1`` merged.  A DTensor's merge
    runs rank by rank, shards of the outer dim becoming shards of the
    merged one (the inner dim is gathered first where it is sharded)."""
    if not is_dtensor(t):
        return t.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 2:])
    from torch.distributed.tensor import Shard
    dim = dim % t.ndim
    t = replicate_dims(t, [dim + 1])
    out = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim + 1
                else p for p in t.placements)
    return _local_reshape(
        t, lambda a: a.shape[:dim] + (a.shape[dim] * a.shape[dim + 1],)
        + a.shape[dim + 2:], out)


def head_local(fn, args, head_dims, out_head_dims, batch_dims=None):
    """``fn`` on the local shards of the DTensors ``args``, through
    ``local_map``: each rank runs ``fn`` on its own heads (attention and
    the SSD scan are head-local under tensor parallelism), so a kernel
    gets plain tensors and never a DTensor.

    ``head_dims`` / ``out_head_dims`` give each argument's and output's
    head dim (None: no heads, replicated over the model axis); the model
    axis shards the heads when every head count divides its size, else
    replicates them (:func:`item_local` splits such work instead).
    ``batch_dims`` (default 0 for every tensor with heads, None otherwise)
    name the dim each data axis shards where the first argument's is
    sharded there already."""
    first = args[0]
    mesh = first.device_mesh
    model_axis = _model_axis()
    tp = model_size(first)
    if batch_dims is None:
        batch_dims = tuple(0 if h is not None else None for h in head_dims)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = tuple(mesh.mesh_dim_names)
    heads_ok = all(h is None or a.shape[h] % tp == 0
                   for a, h in zip(args, head_dims))

    def pick(head, batch):
        out = []
        for i, name in enumerate(names):
            if name == model_axis:
                out.append(Shard(head) if head is not None and heads_ok
                           else Replicate())
            elif (batch is not None and first.placements[i] == Shard(0)):
                out.append(Shard(batch))
            else:
                out.append(Replicate())
        return tuple(out)

    in_pl = tuple(pick(h, b) for h, b in zip(head_dims, batch_dims))
    out_batch = tuple(None if h is None else 0 for h in out_head_dims)
    out_pl = tuple(pick(h, b) for h, b in zip(out_head_dims, out_batch))
    split = tuple(heads_ok if name == model_axis
                  else first.placements[i] == Shard(0)
                  for i, name in enumerate(names))
    mapped = local_map(fn, out_placements=out_pl, in_placements=in_pl,
                       in_grad_placements=grad_placements(in_pl, split),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(*args)


def item_local(fn, args, row_args, n_out: int):
    """``fn(rank, ranks, *shards)`` on each rank's shards of the DTensors
    ``args`` through ``local_map``, for work whose heads do not split over
    the model axis: each rank gets its data shard's rows whole over the
    model axis (``row_args`` flags the arguments with rows in dim 0; the
    others are whole), runs its share of the work items (``rank``,
    ``rank + ranks``, ...: ``fn`` picks them) and returns its ``n_out``
    outputs zero but for its items.  The outputs are summed over the model
    axis and returned whole over it; every input's gradient is a partial
    sum there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    first = args[0]
    mesh = first.device_mesh
    axis = _model_axis()
    names = tuple(mesh.mesh_dim_names)
    tp = model_size(first)
    rank = mesh.get_local_rank(axis) if axis in names else 0
    rows = tuple(n != axis and first.placements[i] == Shard(0)
                 for i, n in enumerate(names))
    whole = tuple(Replicate() for _ in names)
    row_pl = tuple(Shard(0) if r else Replicate() for r in rows)
    in_pl = tuple(row_pl if r else whole for r in row_args)
    out_pl = tuple(Partial() if n == axis else p
                   for n, p in zip(names, row_pl))
    split = tuple(r or n == axis for r, n in zip(rows, names))
    def run(*a):
        # an exact zero from every input, so that each rank's backward
        # reaches each input (and its collectives) however few items it
        # has: a rank with none would skip them and the others would wait
        anchor = sum(t.reshape(-1)[:0].float().sum() for t in a)
        outs = fn(rank, tp, *a)
        if n_out == 1:
            return outs + anchor.to(outs.dtype)
        return tuple(o + anchor.to(o.dtype) for o in outs)

    mapped = local_map(run, out_placements=(out_pl,) * n_out,
                       in_placements=in_pl,
                       in_grad_placements=grad_placements(in_pl, split),
                       device_mesh=mesh, redistribute_inputs=True)
    outs = mapped(*args)
    if n_out == 1:
        return _replicate_model(outs)
    return tuple(_replicate_model(o) for o in outs)


def _replicate_model(t):
    """The DTensor ``t`` whole over the model axis."""
    from torch.distributed.tensor import Replicate
    axis = _model_axis()
    pl = tuple(Replicate() if n == axis else p for n, p in
               zip(t.device_mesh.mesh_dim_names, t.placements))
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def current() -> ShardingContext | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use(ctx: ShardingContext | None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev
