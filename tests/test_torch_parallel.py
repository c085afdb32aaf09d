"""The port's parallel layout (``repro_torch.parallel``) against the JAX
package's (``repro.parallel``): layouts equal to the reference's
``PartitionSpec``s entry by entry, the abstract trees of the dry run, the
row-parallel counts, the model's layout hooks, the elastic restore, the
fake world and the shape-only (``meta``) path of K4 and K5.

The reference's rules run on ``jax.sharding.AbstractMesh`` meshes (no
devices), so every config id is held on the production meshes (16 x 16
and 2 x 16 x 16) and on (2, 4) and (8, 32).  Every comparison is exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.nn import model as ref_model  # noqa: E402
from repro.parallel import context as ref_pctx  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.workloads import tp as ref_tp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ssd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_mesh,  # noqa: E402
                                     one_rank_world)
from repro_torch.nn import model as M  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.parallel import context as pctx  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.workloads import (row_parallel_ops_from_pspecs,  # noqa: E402
                                   row_parallel_ops_per_layer)

ARCHS = list(configs.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x32": ((8, 32), ("data", "model"))}
SHAPES = list(configs.SHAPES)


def _plans(mesh_id):
    shape, axes = MESHES[mesh_id]
    ref = ref_sharding.make_mesh_plan(AbstractMesh(shape, axes))
    port = sharding.make_mesh_plan(dict(zip(axes, shape)))
    return ref, port


def _stub_mesh(mesh_id):
    """What :func:`sharding.placements` reads of a mesh, without a world."""
    shape, axes = MESHES[mesh_id]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _ref_flat(tree):
    """{path: tuple(PartitionSpec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {ref_model._names(p): tuple(s) for p, s in flat}


def _port_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _shapes_of(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes_of(v, path + (k,)))
        else:
            out[path + (k,)] = tuple(v.shape)
    return out


def _assert_even(specs: dict, shapes: dict, mesh_id):
    mesh = _stub_mesh(mesh_id)
    for path, spec in specs.items():
        sharding.placements(spec, mesh, shapes[path])   # raises if uneven


# -- layouts against the reference's PartitionSpecs ---------------------------

@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_layouts_equal_the_reference(arch, mesh_id):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref_plan, plan = _plans(mesh_id)
    shapes = dict(M._leaves(M.param_shapes(cfg)))
    for fsdp in (False, True):
        want = _ref_flat(ref_sharding.param_pspecs(rcfg, ref_plan, fsdp=fsdp))
        got = _port_flat(sharding.param_pspecs(cfg, plan, fsdp=fsdp))
        assert got == want, (arch, mesh_id, fsdp)
        _assert_even(got, shapes, mesh_id)
        # a stacked leaf never shards its layer axis
        for path, spec in got.items():
            if path[0] in M.STACKS:
                assert spec[0] is None, path
        # ZeRO-1 on top of either
        zwant = _ref_flat(ref_sharding.zero1_pspecs(
            ref_sharding.param_pspecs(rcfg, ref_plan, fsdp=fsdp), rcfg,
            ref_plan))
        zgot = _port_flat(sharding.zero1_pspecs(
            sharding.param_pspecs(cfg, plan, fsdp=fsdp), cfg, plan))
        assert zgot == zwant, (arch, mesh_id, fsdp)
        _assert_even(zgot, shapes, mesh_id)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", configs.PORT_ONLY_IDS)
def test_port_only_layouts_are_even_and_keep_the_layer_axis(arch, mesh_id):
    # the reference has no such config: the port's layouts of its params
    # (plain, FSDP, ZeRO-1) and of its decode caches split every leaf
    # evenly and never a stack's layer axis
    cfg = configs.get_config(arch)
    _, plan = _plans(mesh_id)
    shapes = dict(M._leaves(M.param_shapes(cfg)))
    for fsdp in (False, True):
        specs = _port_flat(sharding.param_pspecs(cfg, plan, fsdp=fsdp))
        assert set(specs) == set(shapes)
        for got in (specs, _port_flat(sharding.zero1_pspecs(
                sharding.param_pspecs(cfg, plan, fsdp=fsdp), cfg, plan))):
            _assert_even(got, shapes, mesh_id)
            for path, spec in got.items():
                if path[0] in M.STACKS:
                    assert spec[0] is None, path
    for name in ("decode_32k", "long_500k"):
        shape = configs.SHAPES[name]
        cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        got = _port_flat(sharding.cache_pspecs(plan, cache))
        assert set(got) == set(_shapes_of(cache))
        _assert_even(got, _shapes_of(cache), mesh_id)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_layouts_equal_the_reference(arch, mesh_id):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref_plan, plan = _plans(mesh_id)
    for name in ("train_4k", "prefill_32k"):
        batch = steps.input_specs(cfg, configs.SHAPES[name])["batch"]
        rbatch = ref_steps.input_specs(
            rcfg, ref_configs.SHAPES[name])["batch"]
        want = {k: tuple(s) for k, s in
                ref_sharding.batch_pspecs(ref_plan, rbatch).items()}
        got = sharding.batch_pspecs(plan, batch)
        assert got == want, (arch, mesh_id, name)
        _assert_even(got, {k: tuple(v.shape) for k, v in batch.items()},
                     mesh_id)
    for name in ("decode_32k", "long_500k"):
        shape = configs.SHAPES[name]
        cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        rcache = ref_model.abstract_cache(rcfg, shape.global_batch,
                                          shape.seq_len)
        want = _ref_flat(ref_sharding.cache_pspecs(ref_plan, rcache))
        got = _port_flat(sharding.cache_pspecs(plan, cache))
        assert got == want, (arch, mesh_id, name)
        _assert_even(got, _shapes_of(cache), mesh_id)
        token = steps.input_specs(cfg, shape)["token"]
        assert (sharding.batch_pspecs(plan, token)
                == tuple(ref_sharding.batch_pspecs(
                    ref_plan, ref_steps.input_specs(rcfg, ref_configs.SHAPES[
                        name])["token"])))


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_dp_spec_and_residual_layout_equal_the_reference(mesh_id):
    shape, axes = MESHES[mesh_id]
    ref_plan, plan = _plans(mesh_id)
    assert plan.dp_axes == ref_plan.dp_axes
    assert plan.dp_size == ref_plan.dp_size
    assert plan.model_size == ref_plan.model_size
    amesh = AbstractMesh(shape, axes)
    for batch in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 3, 48):
        assert plan.dp_spec_for(batch) == ref_plan.dp_spec_for(batch), batch
        for seq in (1, 8, 4096, 32768, 100):
            for seq_shard in (True, False):
                rctx = ref_pctx.ShardingContext(
                    mesh=amesh, dp_axes=ref_plan.dp_axes,
                    seq_shard=seq_shard)
                ctx = pctx.ShardingContext(
                    mesh=dict(zip(axes, shape)), dp_axes=plan.dp_axes,
                    seq_shard=seq_shard)
                ns = rctx.residual_sharding(batch, seq)
                want = None if ns is None else tuple(ns.spec)
                assert ctx.residual_sharding(batch, seq) == want


def test_a_dim_over_pod_and_data_splits_pod_major():
    # the reference splits a dim over ("pod", "data") pod-major: the rank at
    # (p, d, m) holds block p * 16 + d of 32; DTensor's placements give
    # each rank the same slice
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    spec = (("pod", "data"), None)
    for rank in (0, 17, 16 * 16 + 5 * 16 + 3, 511):
        with fake_world(512, rank=rank):
            mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), "cuda")
            pl = sharding.placements(spec, mesh, (64, 8))
            assert pl == (Shard(0), Shard(0), Replicate())
            assert sharding.shardings({"w": {"x": spec}}, mesh) == \
                {"w": {"x": pl}}
            local, offset = compute_local_shape_and_global_offset(
                (64, 8), mesh, pl)
        p, d = rank // 256, (rank // 16) % 16
        assert tuple(local) == (2, 8)
        assert tuple(offset) == ((p * 16 + d) * 2, 0), rank


def test_placements_refuse_uneven_and_out_of_order_layouts():
    mesh = _stub_mesh("2x16x16")
    with pytest.raises(ValueError, match="uneven"):
        sharding.placements(("model", None), mesh, (24, 8))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"), None), mesh, (64, 8))
    with pytest.raises(ValueError, match="layer axis"):
        sharding.layer_spec(("model", None, None), "layers.0.attn.wq")
    assert sharding.layer_spec((None, None, "model"),
                               "layers.3.attn.wq") == (None, "model")
    assert sharding.layer_spec(("model", None), "embed") == ("model", None)


# -- the dry run's abstract trees ---------------------------------------------

@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_have_the_reference_shapes_and_dtypes(arch,
                                                             shape_name):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    model = M.abstract_params(cfg)
    names = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in names.values())
    ref_params = ref_model.abstract_params(rcfg)
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    want = {ref_model._names(p): (tuple(s.shape), str(s.dtype))
            for p, s in flat}
    got = {}
    for name, p in names.items():
        path, i = M.leaf_path(name)
        if i is None:
            got[path] = (tuple(p.shape), str(p.dtype).split(".")[-1])
        else:
            n = sum(1 for k in names if M.leaf_path(k)[0] == path)
            got[path] = ((n,) + tuple(p.shape), str(p.dtype).split(".")[-1])
    assert got == want
    opt = steps.abstract_opt_state(model)
    assert set(opt["m"]) == set(names) == set(opt["v"])
    assert all(opt["m"][k].shape == names[k].shape
               and opt["m"][k].dtype == torch.float32 for k in names)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    ropt = ref_steps.abstract_opt_state(ref_params)
    assert str(ropt["step"].dtype) == "int32"

    shape, rshape = configs.SHAPES[shape_name], ref_configs.SHAPES[shape_name]
    spec, rspec = steps.input_specs(cfg, shape), ref_steps.input_specs(
        rcfg, rshape)
    rflat = jax.tree_util.tree_flatten_with_path(rspec)[0]
    want = {ref_model._names(p): (tuple(s.shape), str(s.dtype))
            for p, s in rflat}
    got = {p: (s, str(_port_leaf(spec, p).dtype).split(".")[-1])
           for p, s in _shapes_of(spec).items()}
    assert got == want
    assert all(t.device.type == "meta" for t in _tensors(spec))


def _port_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def test_meta_is_taken_only_when_named():
    from repro_torch.device import resolve_device
    assert resolve_device("meta", meta=True).type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None, meta=True)


# -- row-parallel counts ------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_row_parallel_ops_from_pspecs_equal_the_reference(arch, tp):
    for get, rget in ((configs.get_config, ref_configs.get_config),
                      (configs.get_smoke_config,
                       ref_configs.get_smoke_config)):
        cfg, rcfg = get(arch), rget(arch)
        ref_plan = ref_sharding.make_mesh_plan(
            AbstractMesh((2, tp), ("data", "model")))
        plan = sharding.make_mesh_plan({"data": 2, "model": tp})
        got = row_parallel_ops_from_pspecs(cfg, plan)
        want = ref_tp.row_parallel_ops_from_pspecs(rcfg, ref_plan)
        assert got == want
        # the numpy twin agrees wherever the reference's does (whisper's
        # cross-attention wo is row-parallel in the tree and not counted
        # by the twin, in both packages)
        assert (got == row_parallel_ops_per_layer(cfg, tp)) == \
            (want == ref_tp.row_parallel_ops_per_layer(rcfg, tp))
    assert row_parallel_ops_from_pspecs(cfg) == \
        ref_tp.row_parallel_ops_from_pspecs(rcfg, ref_sharding.make_mesh_plan(
            AbstractMesh((1, 1), ("data", "model"))))


# -- the model's layout hooks -------------------------------------------------

def test_hooks_are_the_identity_without_a_context():
    x = torch.randn(2, 8, 16)
    assert pctx.current() is None
    assert M._constrain_residual(x) is x
    assert moe._constrain(x, (None, "model", None)) is x
    buf = torch.randn(1, 4, 8, 16)
    assert moe._constrain_moe_buf(buf, None) is buf
    assert pctx.gather_model(x) is x and pctx.reduce_output(x) is x
    assert moe._dp_groups(8) == (1, None)
    ctx = pctx.ShardingContext(mesh={"data": 4, "model": 2},
                               dp_axes=("data",))
    with pctx.use(ctx):
        assert pctx.current() is ctx
        assert moe._dp_groups(8) == (4, "data")
        assert moe._dp_groups(6) == (1, None)
        # plain tensors pass the constraints untouched under a context
        assert M._constrain_residual(x) is x
        assert moe._constrain_moe_buf(buf, "data") is buf
    assert pctx.current() is None


_MOE_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.launch.mesh import make_mesh
from repro.nn import moe
from repro.parallel import context as pctx
d = sys.argv[1]
cfg = dataclasses.replace(configs.get_smoke_config(sys.argv[2]),
                          capacity_factor=float(sys.argv[3]))
p = {k[:-4]: jnp.asarray(np.load(os.path.join(d, k)))
     for k in os.listdir(d) if k.startswith("p_")}
p = {k[2:]: v for k, v in p.items()}
x = jnp.asarray(np.load(os.path.join(d, "x.npy")))
mesh = make_mesh((4, 2), ("data", "model"))
ctx = pctx.ShardingContext(mesh=mesh, dp_axes=("data",))
with mesh, pctx.use(ctx):
    y, aux = jax.jit(lambda x, p: moe.moe_ffn(x, p, cfg))(x, p)
np.save(os.path.join(d, "y.npy"), np.asarray(y))
np.save(os.path.join(d, "aux.npy"), np.asarray(aux))
"""


@pytest.mark.parametrize("arch,cf", [("qwen3-moe-30b-a3b", 1.25),
                                     ("qwen3-moe-30b-a3b", 0.5),
                                     ("deepseek-moe-16b", 0.5)])
def test_grouped_routing_equals_the_reference_on_four_data_shards(
        tmp_path, arch, cf):
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              capacity_factor=cf)
    rng = np.random.default_rng(3)
    shapes = moe.moe_param_shapes(cfg)
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32)
         for k, sh in shapes.items()}
    x = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    for k, v in p.items():
        np.save(tmp_path / f"p_{k}.npy", v)
    np.save(tmp_path / "x.npy", x)
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _MOE_REF_SCRIPT,
                          str(tmp_path), arch, str(cf)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    y_ref = np.load(tmp_path / "y.npy")
    aux_ref = np.load(tmp_path / "aux.npy")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ctx = pctx.ShardingContext(mesh={"data": 4, "model": 2},
                               dp_axes=("data",))
    with pctx.use(ctx):
        y, aux = moe.moe_ffn(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    # routing in four groups is not routing in one: each group's capacity
    # comes from its own tokens
    y1, _ = moe.moe_ffn(torch.from_numpy(x), tp, cfg)
    if cf < 1:
        assert not torch.allclose(y, y1, rtol=1e-4, atol=1e-5)


# -- the elastic restore ------------------------------------------------------

def test_elastic_restore_onto_placements(tmp_path):
    t = {"w": torch.arange(64.0).reshape(8, 8)}
    save_checkpoint(str(tmp_path), 1, t)
    with one_rank_world("gloo"):
        mesh = make_mesh((1,), ("data",), "cpu")
        sh = {"w": (mesh, (Shard(0),))}
        t2 = load_checkpoint(str(tmp_path), 1, t, shardings=sh)
        assert tuple(t2["w"].placements) == (Shard(0),)
        assert t2["w"].device_mesh == mesh
        assert torch.equal(t2["w"].full_tensor(), t["w"])


def test_a_reference_checkpoint_restores_onto_the_port_layout(tmp_path):
    from repro.ckpt import save_checkpoint as ref_save
    from repro.nn import init_params as ref_init
    arch = "deepseek-moe-16b"
    cfg, rcfg = configs.get_smoke_config(arch), ref_configs.get_smoke_config(
        arch)
    params = ref_init(rcfg, seed=4)
    ref_save(str(tmp_path), 2, {"params": params})
    model = M.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), cfg,
        device="cpu")
    with one_rank_world("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        plan = sharding.make_mesh_plan(mesh)
        specs = sharding.param_pspecs(cfg, plan, fsdp=True)
        like = {"params": jax.tree.map(np.asarray, params)}
        back = load_checkpoint(str(tmp_path), 2, like, shardings={
            "params": sharding.checkpoint_shardings(cfg, specs, mesh)})
        for name, p in model.named_parameters():
            path, i = M.leaf_path(name)
            leaf = _port_leaf(back["params"], path)
            got = leaf if i is None else leaf[i]
            spec = sharding.layer_spec(sharding.lookup(specs, path), name)
            assert tuple(got.placements) == sharding.placements(spec, mesh)
            assert torch.equal(got.full_tensor().float(), p.float()), name


# -- the fake world -----------------------------------------------------------

def test_fake_world_closes_on_error_and_does_not_nest():
    import torch.distributed as dist
    with pytest.raises(KeyError):
        with fake_world(8):
            assert dist.get_world_size() == 8
            raise KeyError("boom")
    assert not dist.is_initialized()
    with fake_world(4):
        with pytest.raises(RuntimeError, match="do not nest"):
            with fake_world(4):
                pass
        with pytest.raises(RuntimeError, match="do not nest"):
            with one_rank_world("gloo"):
                pass
        mesh = make_mesh((2, 2), ("data", "model"))
        assert mesh.shape == (2, 2)
    assert not dist.is_initialized()


# -- the shape-only path of K4 and K5 -----------------------------------------

def test_meta_inputs_build_and_launch_nothing(monkeypatch):
    def no_build(*_):
        raise AssertionError("a kernel was built")

    monkeypatch.setattr(fa, "kernel", no_build)
    monkeypatch.setattr(ssd, "kernel", no_build)
    before = (dict(fa.LAUNCHES), dict(ssd.LAUNCHES))
    q = torch.empty(2, 4096, 8, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 4096, 2, 128, dtype=torch.bfloat16, device="meta")
    out = ops.mha_flash(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16
    qa = q.clone().requires_grad_(True)
    ops.flash_attention(qa, k, k).float().sum().backward()
    assert qa.grad.shape == q.shape
    args = [torch.empty(6, 64, x, device="meta") for x in (32, 16, 16, 1)]
    y, s = ssd.ssd_intra_chunk(*args)
    assert y.shape == (6, 64, 32) and s.shape == (6, 16, 32)
    assert y.device.type == "meta"
    assert (dict(fa.LAUNCHES), dict(ssd.LAUNCHES)) == before


def test_kernels_refuse_a_dtensor():
    from torch.distributed.tensor import distribute_tensor
    with one_rank_world("gloo"):
        mesh = make_mesh((1,), ("data",), "cpu")
        q = distribute_tensor(torch.zeros(1, 8, 2, 16), mesh, (Replicate(),))
        with pytest.raises(TypeError, match="local_map"):
            fa.flash_attention(q, q, q)
        t = distribute_tensor(torch.zeros(2, 8, 4), mesh, (Replicate(),))
        with pytest.raises(TypeError, match="local_map"):
            ssd.ssd_intra_chunk(t, t[..., :3], t[..., :3], t[..., :1])


@pytest.mark.parametrize("arch,change", [
    ("hymba-1.5b", {}), ("whisper-small", {}), ("deepseek-moe-16b", {}),
    ("llama3.2-3b", {"kv_quant": True}),
    ("granite-4.0-h-small", {"router_experts": 16, "expert_first": 8})])
def test_a_model_under_a_one_rank_layout_equals_the_plain_model(arch,
                                                                change):
    # prefill and two decode steps on a 1 x 1 gloo mesh (K4 and K5 through
    # local_map, the cache laid out by cache_pspecs, MoE routed in data
    # groups): logits and cache equal the plain model's, bit for bit
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **change)
    model = M.init_params(cfg, seed=1, device="cpu")
    inputs = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 32),
        generator=torch.Generator().manual_seed(0))}
    if cfg.encoder_layers:
        inputs["enc_frames"] = torch.randn(
            2, cfg.encoder_seq, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    nxt = torch.tensor([3, 5])

    def run(model, inputs, nxt):
        logits, cache = M.prefill(model, cfg, max_seq=40, device="cpu",
                                  **inputs)
        outs = [logits]
        for pos in (32, 33):
            lg, cache = M.decode_step(model, cfg, cache, nxt, pos,
                                      device="cpu")
            outs.append(lg)
        return outs, cache

    want, cache = run(model, inputs, nxt)
    with one_rank_world("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        plan = sharding.make_mesh_plan(mesh)
        sharding.distribute_model(model, sharding.param_pspecs(cfg, plan),
                                  mesh)
        laid = {k: sharding.place(v, mesh, sharding.batch_pspecs(plan, v))
                for k, v in inputs.items()}
        tok = sharding.place(nxt, mesh, sharding.batch_pspecs(plan, nxt))
        ctx = pctx.ShardingContext(mesh=mesh, dp_axes=plan.dp_axes)
        with implicit_replication(), pctx.use(ctx):
            got, c2 = run(model, laid, tok)
        for a, b in zip(got, want):
            assert torch.equal(a.full_tensor(), b)
        for g, leaves in cache.items():
            for k, v in leaves.items():
                assert torch.equal(c2[g][k].full_tensor(), v), (g, k)


# A real world of four gloo ranks in forked processes: a (1, 4) mesh whose
# model axis shards the decode cache on the head dim (smoke llama: 2 kv
# heads, head dim 16) or on the sequence (3 kv heads, head dim 6); three
# decode steps from a seeded cache against the plain model in float32.
_GLOO_SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import model as M
from repro_torch.parallel import context as pctx, sharding

MODE, PORT = sys.argv[1], int(sys.argv[2])


def cfg_of():
    cfg = configs.get_smoke_config("llama3.2-3b")
    if MODE == "seq":
        cfg = dataclasses.replace(cfg, d_model=36, n_heads=6, n_kv_heads=3,
                                  d_head=6, d_ff=72)
    return cfg


def run(model, cfg, cache, nxt):
    outs = []
    for pos in (20, 21, 22):
        lg, cache = M.decode_step(model, cfg, cache, nxt, pos, device="cpu")
        outs.append(lg)
    return outs, cache


def worker(rank):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            rank=rank, world_size=4)
    try:
        cfg = cfg_of()
        model = M.init_params(cfg, seed=1, device="cpu").float()
        gen = torch.Generator().manual_seed(0)
        cache = M.init_cache(cfg, 2, 40, device="cpu")
        for leaves in cache.values():
            for t in leaves.values():
                t[:, :, :20] = torch.randn(t[:, :, :20].shape,
                                           generator=gen).to(t.dtype)
        start = {g: {k: t.clone() for k, t in v.items()}
                 for g, v in cache.items()}
        nxt = torch.tensor([3, 5])
        want, cache = run(model, cfg, cache, nxt)
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        plan = sharding.make_mesh_plan(mesh)
        sharding.distribute_model(model, sharding.param_pspecs(cfg, plan),
                                  mesh)
        specs = sharding.cache_pspecs(plan, start)
        laid = {g: {k: sharding.place(t, mesh, specs[g][k])
                    for k, t in v.items()} for g, v in start.items()}
        nx = sharding.place(nxt, mesh, sharding.batch_pspecs(plan, nxt))
        ctx = pctx.ShardingContext(mesh=mesh, dp_axes=plan.dp_axes)
        with implicit_replication(), pctx.use(ctx):
            got, c2 = run(model, cfg, laid, nx)
        k = c2["layers"]["k"]
        err = max(float((a.full_tensor() - b).abs().max() /
                        b.abs().max()) for a, b in zip(got, want))
        cerr = max(float((c2["layers"][n].full_tensor().float()
                          - cache["layers"][n].float()).abs().max())
                   for n in ("k", "v"))
        if rank == 0:
            print(json.dumps({"err": err, "cache_err": cerr,
                              "placement": k.placements[1].dim}))
    finally:
        dist.destroy_process_group()


mp.start_processes(worker, nprocs=4, start_method="fork")
"""


@pytest.mark.parametrize("mode,placement", [("dim", 4), ("seq", 2)])
def test_laid_out_decode_on_four_gloo_ranks(mode, placement):
    from repro_torch.launch.mesh import _free_port
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _GLOO_SCRIPT, mode,
                          str(_free_port())], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["placement"] == placement, res
    # float32 products split over four ranks: the row-parallel partial
    # sums add in another order, which can flip a bf16 cache entry by one
    # ulp (2^-6 at the entries' magnitude, below 4)
    assert res["err"] < 1e-3 and res["cache_err"] <= 2 ** -6, res


# The training step (loss and every gradient) on a real world of four gloo
# ranks in forked processes, against the plain model in float32, where the
# model axis splits neither the heads nor the vocab: the attention and SSD
# scans then deal their (row, head) items out over it, one model rank
# each in turn, and the SSM's input projection and the
# logits run on the sequence-sharded residual.  Cut configs: hymba with 5
# heads over 1 kv head, 10 SSM heads and a vocab of 258; whisper with 6
# heads; mamba2 with 10 SSM heads; llama with 6 heads over 2 kv heads.
# MoE routes in D = 1 group on the (1, 4) mesh, as the plain model does.
_CUTS = {
    "hymba": ("hymba-1.5b", {"d_model": 80, "n_heads": 5, "n_kv_heads": 1,
                             "vocab_size": 258}),
    "whisper": ("whisper-small", {"n_heads": 6, "n_kv_heads": 6,
                                  "vocab_size": 258}),
    "mamba2": ("mamba2-130m", {"d_model": 80, "vocab_size": 258}),
    "llama": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2}),
    "llama-even": ("llama3.2-3b", {}),
    "deepseek": ("deepseek-moe-16b", {}),
}
TRAIN_CASES = [  # (cut, rows, mesh)
    ("hymba", 4, (1, 4)),       # 4 items, one a model rank
    ("hymba", 2, (1, 4)),       # 2 items: two ranks idle
    ("whisper", 2, (1, 4)),     # 12 items over 4 ranks
    ("whisper", 4, (2, 2)),     # data-parallel too
    ("mamba2", 4, (1, 4)),
    ("llama", 2, (1, 4)),       # grouped heads as items
    ("llama-even", 4, (2, 2)),  # heads split, data-parallel embedding
    ("deepseek", 4, (1, 4)),    # experts split over the model axis
]
_TRAIN_SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import model as M
from repro_torch.parallel import context as pctx, sharding

CASES, PORT = json.loads(sys.argv[1]), int(sys.argv[2])


def case(arch, cut, rows, mesh_shape):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **cut)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, 32),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(rows, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    model = M.init_params(cfg, seed=1, device="cpu").float().trainable()
    loss, _, want = steps.grads_of(model, cfg, batch, device="cpu")
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
    plan = sharding.make_mesh_plan(mesh)
    sharding.distribute_model(model, sharding.param_pspecs(cfg, plan), mesh)
    laid = {k: sharding.place(v, mesh, sharding.batch_pspecs(plan, v))
            for k, v in batch.items()}
    ctx = pctx.ShardingContext(mesh=mesh, dp_axes=plan.dp_axes)
    with implicit_replication(), pctx.use(ctx):
        got_loss, _, got = steps.grads_of(model, cfg, laid, device="cpu")
    err = max(float((got[k].full_tensor() - want[k]).abs().max()
                    / want[k].abs().max().clamp(min=1e-30)) for k in want)
    return {"loss": float(loss), "laid": float(got_loss.full_tensor()),
            "grad_err": err}


def checked(*c):
    try:
        return case(*c)
    except Exception as e:  # every rank raises alike: the next case runs
        return {"error": f"{type(e).__name__}: {e}"[:400]}


def worker(rank):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            rank=rank, world_size=4)
    try:
        out = [checked(*c) for c in CASES]
        if rank == 0:
            print(json.dumps(out))
    finally:
        dist.destroy_process_group()


mp.start_processes(worker, nprocs=4, start_method="fork")
"""


@pytest.fixture(scope="module")
def trained_on_four_ranks():
    from repro_torch.launch.mesh import _free_port
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cases = [(*_CUTS[c], rows, mesh) for c, rows, mesh in TRAIN_CASES]
    out = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT,
                          json.dumps(cases), str(_free_port())], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)),
                         ids=[f"{c}-{r}rows-{m[0]}x{m[1]}"
                              for c, r, m in TRAIN_CASES])
def test_a_training_step_on_four_gloo_ranks_equals_the_plain_one(
        trained_on_four_ranks, i):
    res = trained_on_four_ranks[i]
    assert "error" not in res, res
    # float32 sums split over ranks add in another order: the loss within
    # 1e-6 and every gradient within 1e-4 of its largest entry
    assert abs(res["laid"] - res["loss"]) <= 1e-6 * abs(res["loss"]), res
    assert res["grad_err"] < 1e-4, res
