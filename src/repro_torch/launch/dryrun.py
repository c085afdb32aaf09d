"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
256- or 512-rank world and price its collectives (counterpart of
``repro.launch.dryrun``).

Where the reference lowers and compiles each cell with XLA on 512 forced
host devices and parses the collectives out of the compiled HLO, the port
runs the cell's step itself, once, on ``meta`` tensors (shapes and dtypes,
nothing computed) inside :func:`~repro_torch.launch.mesh.fake_world`:
parameters, ZeRO-1 moments, batch and cache are DTensors laid out by
:mod:`repro_torch.parallel.sharding` on the production mesh, and DTensor
inserts each collective the layout needs.  A dispatch mode under DTensor
(:class:`TraceRecorder`) sees every rank-0 local op and collective, and
records:

  * each collective's kind, per-rank result bytes and groups (the device-id
    rows of the mesh dim it runs over), as :class:`~repro_torch.core.hlo.
    CollectiveOp` rows, identical ops merged into ``count``;
  * FLOPs per rank (``torch.utils.flop_counter``'s formulas on the local
    shapes), bytes per rank (the operand and result bytes of every local
    op: unfused, so larger than XLA's fused count) and the high-water mark
    of the step's own tensors (its temporaries).

The collectives are then priced by :func:`repro_torch.core.price_step` with
the reference's TPU v5e parameters: one K1 launch a cell on the card.  The
trace is unrolled, so the reference's 2/4-layer ``calibrate`` compiles have
no counterpart (``*_raw`` equals the corrected figures).  A train cell of
``m`` microbatches traces one slice and counts it ``m`` times (the slices
are identical), unless ``full_microbatches``.

Artifacts are JSON files under ``artifacts/dryrun_torch/`` in the
reference's schema, resumable (existing cells are skipped unless
``--force``)::

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time
import traceback
import weakref

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_applicable,
                                 get_config, get_smoke_config)
from repro_torch.core import collective_summary, price_step
from repro_torch.core.decompose import PodGeometry
from repro_torch.core.hlo import CollectiveOp
from repro_torch.core.params import tpu_v5e
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.nn import model as M
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import (batch_pspecs, cache_pspecs,
                                           distribute_model, layer_spec,
                                           lookup, make_mesh_plan,
                                           param_pspecs, place, zero1_pspecs)
from repro_torch.train.optim import AdamWConfig, adamw_update

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

#: What the per-rank byte count is, written into every artifact.
BYTES_NOTE = ("operand + result bytes of every local op, unfused (no "
              "fusion or rematerialisation by a compiler): larger than "
              "XLA's bytes accessed")

#: Collective ops of the traced program and their HLO kinds.
COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_PASS = ("_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_"
         "autograd")
#: Ops that allocate and move no bytes (their tensors still count toward
#: the high-water mark where another op writes them).
_ALLOCATIONS = ("aten.empty", "aten.empty_strided", "aten.empty_like",
                "aten.new_empty", "aten.new_empty_strided")
_TRANSCENDENTAL = {"exp", "exp_", "log", "rsqrt", "sqrt", "sin", "cos",
                   "tanh", "sigmoid", "silu", "gelu", "softplus",
                   "_softmax", "_log_softmax", "logsumexp", "pow", "expm1",
                   "log1p"}


def cell_path(arch: str, shape: str, mesh_name: str, out_dir: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def local_bytes(tree) -> int:
    """Bytes of rank 0's shards of the tensors of ``tree`` (a DTensor's
    local tensor, a plain tensor whole)."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


class TraceRecorder(TorchDispatchMode):
    """Records what rank 0 runs under DTensor: collectives (kind, result
    bytes, mesh dim) with a multiplicity, FLOPs, bytes and transcendental
    elements of the local ops, and the high-water mark of the bytes the
    local ops allocate (freed when their tensors die).

    An op on DTensors is handed back to DTensor (``NotImplemented``), which
    runs it as local ops and collectives that come back here.  ``scale``
    multiplies what is recorded while it is set (a traced microbatch counted
    once a slice)."""

    def __init__(self, group_dims: dict):
        super().__init__()
        self.group_dims = group_dims      # group name -> mesh dim
        self.collectives: dict = {}       # (kind, bytes, dim, op) -> count
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.scale = 1
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or _in_propagation():
            return out
        name = str(func._overloadpacket)
        if name in COLLECTIVES:
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            if group not in self.group_dims:
                raise RuntimeError(f"{name} over group {group!r}, which is "
                                   "no dim of the mesh")
            key = (COLLECTIVES[name], _nbytes(out), self.group_dims[group],
                   name)
            self.collectives[key] = self.collectives.get(key, 0) + self.scale
            return out
        if name in _PASS or "c10d" in name:
            if "c10d" in name and name not in _PASS:
                raise RuntimeError(f"unexpected collective {name} in a trace")
            return out
        outs = [t for t in _tensors(out)]
        if func._overloadpacket in flop_registry:
            self.flops += self.scale * flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if not aliased:
            if name not in _ALLOCATIONS:
                moved = sum(_nbytes(t) for t in _tensors(args)) \
                    + sum(_nbytes(t) for t in outs)
                self.bytes += self.scale * moved
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        if name.split(".")[-1] in _TRANSCENDENTAL:
            self.transcendentals += self.scale * sum(t.numel() for t in outs)
        return out


def _in_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs ops (an op's own, or those of its decomposition) on global-shape
    ``meta`` tensors to learn an output's shape and strategy: no rank runs
    those.  The stack is walked from the op up: propagation's frames lie
    between the op and the model code that called DTensor, so the first
    frame of this package ends the walk."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name in _PROPAGATION_FILES:
            return True
        if name.startswith(_PACKAGE):
            return False
        f = f.f_back
    return False


def _propagation_files() -> tuple:
    """The source files of DTensor's sharding propagation in the installed
    torch: ``_sharding_prop`` (raises if torch has none), and
    ``_decompositions`` where torch derives strategies from
    decompositions."""
    import importlib.util
    files = []
    for module, required in (("torch.distributed.tensor._sharding_prop",
                              True),
                             ("torch.distributed.tensor._decompositions",
                              False)):
        spec = importlib.util.find_spec(module)
        if spec is None or not spec.origin:
            if required:
                raise ImportError(f"{module} is not in this torch: the dry "
                                  "run cannot tell DTensor's sharding "
                                  "propagation from rank work")
            continue
        files.append(spec.origin)
    return tuple(files)


_PROPAGATION_FILES = _propagation_files()
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_CANARY = itertools.count(1)


def check_recorder(mesh, group_dims: dict) -> None:
    """Raise unless the recorder counts rank 0's work only: a
    column-parallel product [8, k] @ [k, 32 * tp] traced on ``mesh`` must
    count 2 * 8 * k * 32 FLOPs, the local product's, and no collective.
    A torch whose propagation the recorder does not see adds the global
    product's, which propagation runs on ``meta`` the first time it meets
    a shape (``k`` is new at each call, so it always does)."""
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    k = 64 + next(_CANARY)
    x = place(torch.empty(8, k, device="meta"), mesh, ())
    w = place(torch.empty(k, 32 * tp, device="meta"), mesh,
              (None, "model" if tp > 1 else None))
    rec = TraceRecorder(group_dims)
    with rec:
        x @ w
    if rec.flops != 2 * 8 * k * 32 or rec.collectives:
        raise RuntimeError(f"the trace recorder counted {rec.flops} FLOPs "
                           f"and {rec.collectives} for a local product of "
                           f"{2 * 8 * k * 32}: DTensor's propagation in "
                           f"this torch is not in {_PROPAGATION_FILES}")


def mesh_groups(mesh) -> tuple[dict, dict]:
    """({group name: mesh dim}, {mesh dim: device-id rows [n_groups,
    size]}) of ``mesh``: the groups of a mesh dim are its ranks with the
    other dims fixed."""
    names, rows = {}, {}
    ids = mesh.mesh.cpu().numpy()
    for i in range(ids.ndim):
        names[mesh.get_group(i).group_name] = i
        rows[i] = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
    return names, rows


def collective_ops(rec: TraceRecorder, rows: dict, mesh) -> list:
    """The recorded collectives as :class:`CollectiveOp` rows (``line``
    holds the op and its mesh axis)."""
    axes = tuple(mesh.mesh_dim_names)
    return [CollectiveOp(kind=kind, result_bytes=float(b),
                         groups=rows[dim].copy(), source_target_pairs=None,
                         count=int(n), line=f"{op} over {axes[dim]}")
            for (kind, b, dim, op), n in sorted(rec.collectives.items())]


def microbatches_for(cfg, global_batch: int, dp_size: int) -> int:
    """The reference's microbatch rule for a train cell, halved until a
    slice holds at least a row for each data rank: a narrower slice would
    split over a prefix of the data axes only (``dp_spec``), and every
    rank of the rest would run the others' rows."""
    m = (16 if cfg.n_params() > 50e9
         else 4 if (cfg.n_params() > 20e9 or cfg.is_moe)
         else 2 if cfg.cross_attention else 1)
    while m > 1 and global_batch // m < dp_size:
        m //= 2
    return m


def fsdp_for(cfg, kind: str) -> bool:
    """The reference's FSDP rule: >20B training, >15B serving."""
    return (cfg.n_params() > 20e9 if kind == "train"
            else cfg.n_params() > 15e9)


def _opt_state(model, pspecs, plan, mesh, cfg):
    """ZeRO-1 moments laid out as ``zero1_pspecs`` says, on ``meta``."""
    zspecs = zero1_pspecs(pspecs, cfg, plan)
    state = steps.abstract_opt_state(model)
    for key in ("m", "v"):
        state[key] = {name: place(t, mesh, layer_spec(
            lookup(zspecs, M.leaf_path(name)[0]), name))
            for name, t in state[key].items()}
    state["step"] = place(state["step"], mesh, ())
    return state


def _trace_train(rec, model, cfg, batch, opt_state, microbatches: int,
                 full: bool):
    """The train step: ``microbatches`` slices of loss and gradients
    (one traced and counted a slice, unless ``full``), then AdamW."""
    model.trainable()
    if microbatches == 1:
        _, _, grads = steps.grads_of(model, cfg, batch, device="meta")
    else:
        slices = steps.split_microbatches(batch, microbatches)
        loss = torch.zeros((), dtype=torch.float32, device="meta")
        grads = steps.zero_grads(model)
        if full:
            for i in range(microbatches):
                loss, _ = steps.accumulate_microbatch(
                    model, cfg, slices, i, grads, loss, microbatches,
                    device="meta")
        else:
            rec.scale = microbatches
            loss, _ = steps.accumulate_microbatch(
                model, cfg, slices, 0, grads, loss, microbatches,
                device="meta")
            rec.scale = 1
    adamw_update(model, grads, opt_state, AdamWConfig())
    return (model, opt_state)


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               seq_shard: bool = True, q_chunk: int = 1024,
               cfg_overrides: dict | None = None,
               mesh_shape: tuple | None = None,
               microbatch_override: int | None = None, device=None,
               full_microbatches: bool = False) -> dict:
    """Trace one cell on a fake world and price its collectives on
    ``device`` (None: CUDA, one K1 launch).  Returns the artifact dict
    (the reference's schema, plus ``trace_s``, ``price_s``,
    ``microbatches``, ``collective_ops`` and ``bytes_note``).

    ``cfg_overrides`` replace fields of the registry's config of ``arch``
    (a cut config: every field of a smoke config, say); ``mesh_shape`` a
    ``(data, model)`` mesh replaces the production one.  ``q_chunk`` is
    the reference's argument: K4 is blockwise, so only its default is
    taken (the artifact records the reference's 512 for a prefill).
    """
    art, ops = trace_collectives(
        arch, shape_name, multi_pod, seq_shard, q_chunk, cfg_overrides,
        mesh_shape, microbatch_override, full_microbatches)
    if ops is None:
        return art
    return price_cell(art, ops, multi_pod, device)


def price_cell(art: dict, ops: list, multi_pod: bool, device=None) -> dict:
    """``art`` with its collectives ``ops`` priced by ``price_step`` on
    ``device`` (None: CUDA): ``comm_model`` and ``price_s`` added."""
    t0 = time.time()
    geom = PodGeometry(n_pods=2 if multi_pod else 1)
    comm = price_step(ops, geom, tpu_v5e(), device=device)
    art = dict(art, price_s=time.time() - t0, comm_model=comm.as_dict())
    art["comm_model"]["ops"] = [
        {k: o[k] for k in ("kind", "count", "payload_bytes", "naive_time",
                           "transport", "queue", "contention")}
        for o in art["comm_model"]["ops"]]
    return art


def trace_collectives(arch: str, shape_name: str, multi_pod: bool,
                      seq_shard: bool = True, q_chunk: int = 1024,
                      cfg_overrides: dict | None = None,
                      mesh_shape: tuple | None = None,
                      microbatch_override: int | None = None,
                      full_microbatches: bool = False):
    """:func:`trace_cell` without the pricing: (the artifact dict without
    ``comm_model``, the :class:`CollectiveOp` rows), or (the skipped
    cell's dict, None)."""
    if q_chunk != 1024:
        raise ValueError(f"q_chunk {q_chunk}: K4 is blockwise and takes no "
                         "query-chunk size (only the reference's 1024)")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if (shape.kind == "decode" and cfg.n_params() > 50e9
            and not cfg_overrides):
        # production serving default for 72B-class: int8 KV cache
        cfg = dataclasses.replace(cfg, kv_quant=True)
    ok, why = cell_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params()}
    if not ok:
        return {**base, "status": "skipped", "reason": why}, None
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
    elif multi_pod:
        dims, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        dims, axes = (16, 16), ("data", "model")
    if shape.kind == "prefill":
        q_chunk = min(q_chunk, 512)   # the reference's prefill setting
    n_scanned = cfg.n_layers - cfg.first_dense_layers
    microbatches = 1
    t0 = time.time()
    with fake_world(int(np.prod(dims))):
        mesh = make_mesh(dims, axes, device_type="cuda")
        plan = make_mesh_plan(mesh)
        group_dims, rows = mesh_groups(mesh)
        check_recorder(mesh, group_dims)
        pspecs = param_pspecs(cfg, plan, fsdp=fsdp_for(cfg, shape.kind))
        model = distribute_model(M.abstract_params(cfg), pspecs, mesh)
        ctx = pctx.ShardingContext(mesh=mesh, dp_axes=plan.dp_axes,
                                   seq_shard=seq_shard)
        spec = steps.input_specs(cfg, shape)
        rec = TraceRecorder(group_dims)
        if shape.kind == "train":
            microbatches = microbatch_override or microbatches_for(
                cfg, shape.global_batch, plan.dp_size)
            batch = {k: place(v, mesh, s) for (k, v), s in zip(
                spec["batch"].items(),
                batch_pspecs(plan, spec["batch"]).values())}
            opt_state = _opt_state(model, pspecs, plan, mesh, cfg)
            args = (model, opt_state, batch)
            run = lambda: _trace_train(rec, model, cfg, batch,  # noqa: E731
                                       opt_state, microbatches,
                                       full_microbatches)
        elif shape.kind == "prefill":
            batch = {k: place(v, mesh, s) for (k, v), s in zip(
                spec["batch"].items(),
                batch_pspecs(plan, spec["batch"]).values())}
            args = (model, batch)
            step = steps.make_prefill_step(cfg, device="meta")
            run = lambda: step(model, batch)  # noqa: E731
        else:
            cspecs = cache_pspecs(plan, spec["cache"])
            cache = {g: {k: place(t, mesh, cspecs[g][k])
                         for k, t in leaves.items()}
                     for g, leaves in spec["cache"].items()}
            token = place(spec["token"], mesh,
                          batch_pspecs(plan, spec["token"]))
            args = (model, cache, token)
            step = steps.make_serve_step(cfg, device="meta")
            run = lambda: step(model, cache, token,  # noqa: E731
                               shape.seq_len - 1)
        arg_bytes = local_bytes([dict(model.named_parameters())]
                                + list(args[1:]))
        # the step's host-made constants (positions, masks, RoPE tables,
        # accumulators) are the same on every rank: taken as replicated.
        # Work that should be split and is not shows in the FLOPs a rank
        # (``tests/test_torch_dryrun.py`` holds it to one rank's / ranks)
        with implicit_replication(), pctx.use(ctx), rec:
            out = run()
        if shape.kind == "train":
            out_bytes = alias_bytes = arg_bytes - local_bytes(args[2])
        else:
            out_bytes = local_bytes(out)
            alias_bytes = local_bytes(args[1]) if shape.kind == "decode" \
                else 0
        del out
        ops = collective_ops(rec, rows, mesh)
    t_trace = time.time() - t0
    art = {
        **base,
        "status": "ok",
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "trace_s": t_trace,
        "seq_shard": seq_shard,
        "q_chunk": q_chunk,
        "mesh_shape": list(dims),
        "microbatches": microbatches,
        "traced_microbatches": (microbatches if full_microbatches
                                or shape.kind != "train" else 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": rec.peak,
            "alias_bytes": alias_bytes,
            "peak_bytes": arg_bytes + out_bytes + rec.peak - alias_bytes,
        },
        "cost": {
            "flops_per_device_raw": rec.flops,
            "bytes_per_device_raw": rec.bytes,
            "flops_per_device": rec.flops,
            "bytes_per_device": rec.bytes,
            "transcendentals": rec.transcendentals,
        },
        "bytes_note": BYTES_NOTE,
        "collectives": collective_summary(ops),
        "collective_ops": [{"kind": o.kind, "count": o.count,
                            "result_bytes": o.result_bytes,
                            "group_size": o.group_size, "op": o.line}
                           for o in ops],
        "scan_trip_count": n_scanned,
    }
    return art, ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable Megatron-SP residual sequence sharding")
    ap.add_argument("--q-chunk", type=int, default=1024,
                    help="the reference's query-chunk size; K4 is "
                         "blockwise, so any other value is refused")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="accepted for the reference's command line; the "
                         "trace is unrolled and needs no calibration")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix (for variant runs)")
    ap.add_argument("--device", default=None,
                    help="where K1 prices the collectives (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs (a host-sized check)")
    ap.add_argument("--mesh-shape", default=None,
                    help="DATA,MODEL: a (data, model) mesh of that many "
                         "fake ranks in place of the production one")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = n_cached = 0
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = ("pod2x16x16" if mp else "pod16x16") + args.tag
                path = cell_path(arch, shape, mesh_name, args.out)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        n_cached += 1
                        continue
                t0 = time.time()
                try:
                    art = trace_cell(
                        arch, shape, mp, seq_shard=not args.no_seq_shard,
                        q_chunk=args.q_chunk, device=args.device,
                        mesh_shape=mesh_shape,
                        cfg_overrides=dataclasses.asdict(
                            get_smoke_config(arch)) if args.smoke else None)
                    art["mesh"] = mesh_name
                except Exception as e:  # noqa: BLE001
                    art = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "failed", "error": str(e),
                           "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(art, f, indent=1, default=float)
                st = art["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                msg = ""
                if st == "ok":
                    peak = art["memory"]["peak_bytes"] / 2**30
                    msg = (f"peak={peak:.2f}GiB "
                           f"flops/dev={art['cost']['flops_per_device']:.3e} "
                           f"trace={art['trace_s']:.1f}s")
                elif st == "failed":
                    msg = art["error"][:160]
                print(f"[{time.strftime('%H:%M:%S')}] {arch} x {shape} x "
                      f"{mesh_name}: {st} {msg} ({time.time()-t0:.1f}s)",
                      flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"cached={n_cached} wall={time.time() - t_all:.1f}s")
    return n_fail


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
