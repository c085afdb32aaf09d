"""The port's programs across ranks against the JAX package's.

The reference's ``moe_ffn_ep``, ``gpipe`` and ``dp_grads_compressed`` run
once, in a subprocess with 8 forced host devices (as
``tests/test_multidevice.py`` runs them), on inputs drawn from seeded
``np.random.default_rng``; inputs and outputs go to an ``.npz``.  The
port's counterparts run on a world of ranks as threads
(``launch.mesh.run_ranks``, ``device="cpu"``) on the same inputs:

* ``moe_ffn_ep`` on 2, 4 and 8 ranks, with generous capacity (no drops)
  and with the config's 1.25 (drops): within rtol 1e-4 / atol 1e-6;
* ``gpipe`` over the reference's tanh layers (8 layers, d 16, 4 stages
  on the ``pod`` axis of a (4, 2) mesh, 6 microbatches): max abs 1e-5;
* ``dp_grads_compressed`` over three error-feedback steps: each mean
  within one quantisation step (``scale / n``) per entry, each rank's
  error row within one step (``scale``) — float32 gradients from torch
  and jax differ in their last bits, so an entry near a half step may
  round to the next int8 level;
* ``gpipe`` over the port's smoke hymba layers against
  ``forward_hidden``;
* the three programs on four real gloo processes, bit-equal to the
  threaded world;
* the messages each program sends against the patterns
  ``workloads.moe`` prices; ``run_ranks``' failure handling.
"""
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, one_rank_world,  # noqa: E402
                                     run_ranks)
from repro_torch.nn import model as M  # noqa: E402
from repro_torch.nn import moe as nn_moe  # noqa: E402
from repro_torch.nn.blocks import block_forward  # noqa: E402
from repro_torch.nn.layers import norm  # noqa: E402
from repro_torch.parallel import (dp_grads_compressed, gpipe,  # noqa: E402
                                  moe_ffn_ep, stack_stages)
from repro_torch.parallel.collectives import (pmax, ppermute,  # noqa: E402
                                              psum)
from repro_torch.parallel.compression import shard_grads  # noqa: E402
from repro_torch.workloads.moe import (ACT_BYTES, a2a_capacity,  # noqa: E402
                                       pattern_from_counts)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = "cpu"
EP_RANKS = (2, 4, 8)
EP_CAPACITY = {"generous": 8.0, "drops": 1.25}
EF_STEPS = 3

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.parallel.compression import dp_grads_compressed
from repro.parallel.ep_a2a import moe_ffn_ep
from repro.parallel.pipeline import gpipe, stack_stages

out = {}
devs = np.array(jax.devices())

# -- EP all-to-all: smoke qwen3-moe (d 64, 8 experts top-2), 128 tokens
cfg = get_smoke_config("qwen3-moe-30b-a3b")
rng = np.random.default_rng(5)
d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
     "w1": rng.standard_normal((E, d, f)) / np.sqrt(d),
     "w3": rng.standard_normal((E, d, f)) / np.sqrt(d),
     "w2": rng.standard_normal((E, f, d)) / np.sqrt(f)}
p = {k: v.astype(np.float32) for k, v in p.items()}
# a mean of 0.5 skews the routing: the config's capacity factor drops
x = (rng.standard_normal((4, 32, d)) + 0.5).astype(np.float32)
out.update({"ep_" + k: v for k, v in p.items()}, ep_x=x)
pj = {k: jnp.asarray(v) for k, v in p.items()}
for n in (2, 4, 8):
    mesh = Mesh(devs[:n], ("model",))
    for name, cf in (("generous", 8.0), ("drops", 1.25)):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        y = jax.jit(lambda x, p: moe_ffn_ep(x, p, c, mesh,
                                            axis_name="model"))(
            jnp.asarray(x), pj)
        out[f"ep_y_{n}_{name}"] = np.asarray(y)

# -- GPipe over tanh layers on the pod axis of a (4, 2) mesh
rng = np.random.default_rng(6)
L, dm, M_, mb = 8, 16, 6, 4
w = (rng.standard_normal((L, dm, dm)) / np.sqrt(dm)).astype(np.float32)
xs = rng.standard_normal((M_, mb, dm)).astype(np.float32)

def stage_fn(sp, h):
    h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), ()), h, sp["w"])
    return h

mesh2 = Mesh(devs.reshape(4, 2), ("pod", "data"))
y = jax.jit(lambda w, xs: gpipe(stage_fn, stack_stages({"w": w}, 4), xs,
                                mesh2, axis="pod"))(jnp.asarray(w),
                                                    jnp.asarray(xs))
out.update(pipe_w=w, pipe_x=xs, pipe_y=np.asarray(y))

# -- int8 compressed all-reduce with error feedback on 8 data ranks
rng = np.random.default_rng(7)
params = {"w": rng.standard_normal((16, 4)).astype(np.float32)}
batch = {"x": rng.standard_normal((32, 16)).astype(np.float32),
         "y": rng.standard_normal((32, 4)).astype(np.float32)}
out.update(cmp_w=params["w"], cmp_x=batch["x"], cmp_y=batch["y"])
mesh3 = Mesh(devs, ("data",))

def loss_fn(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

pj = {"w": jnp.asarray(params["w"])}
bj = {k: jnp.asarray(v) for k, v in batch.items()}
errs = {"w": jnp.zeros((8, 16, 4), jnp.float32)}
step_fn = jax.jit(lambda e: dp_grads_compressed(loss_fn, pj, bj, mesh3,
                                                errors=e))
for step in range(3):
    g, errs = step_fn(errs)
    out[f"cmp_g_{step}"] = np.asarray(g["w"])
    out[f"cmp_e_{step}"] = np.asarray(errs["w"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("multirank") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ep_inputs(ref):
    p = {k: _t(ref["ep_" + k]) for k in ("router", "w1", "w3", "w2")}
    return _t(ref["ep_x"]), p


def _route_counts(x, p, cfg):
    """The routing histogram [E] of one rank's tokens (every rank routes
    every token: ``x`` is replicated)."""
    xf = x.reshape(-1, x.shape[-1])
    idx = nn_moe.top_k(xf.float() @ p["router"].float(),
                       cfg.n_experts_active)[2]
    return np.bincount(idx.reshape(-1).numpy(), minlength=cfg.n_experts)


# ------------------------------------------------------------- moe_ffn_ep --

@pytest.mark.parametrize("n", EP_RANKS)
@pytest.mark.parametrize("capacity", sorted(EP_CAPACITY))
def test_moe_ffn_ep_matches_reference(ref, n, capacity):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-moe-30b-a3b"),
                              capacity_factor=EP_CAPACITY[capacity])
    x, p = _ep_inputs(ref)
    ys = run_ranks(n, lambda r: moe_ffn_ep(x, p, cfg), device=CPU)
    want = ref[f"ep_y_{n}_{capacity}"]
    for y in ys:
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-6)
    counts = _route_counts(x, p, cfg)
    dropped = np.maximum(counts - a2a_capacity(x.shape[0] * x.shape[1],
                                               cfg), 0).sum()
    assert (dropped > 0) == (capacity == "drops"), dropped


def test_moe_ffn_ep_without_drops_is_moe_ffn(ref):
    # with no drop, the per-rank buffers hold what moe_ffn's one buffer
    # holds: the same products, whichever capacity rounding
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-moe-30b-a3b"),
                              capacity_factor=8.0)
    x, p = _ep_inputs(ref)
    want, _ = nn_moe.moe_ffn(x, p, cfg)
    ys = run_ranks(4, lambda r: moe_ffn_ep(x, p, cfg), device=CPU)
    for y in ys:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_moe_ffn_ep_takes_dtensor_expert_shards(ref):
    from torch.distributed.tensor import Shard, distribute_tensor
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    x, p = _ep_inputs(ref)

    def rank(r):
        mesh = make_mesh((4,), ("model",), CPU)
        laid = {k: (v if k == "router" else
                    distribute_tensor(v, mesh, [Shard(0)]))
                for k, v in p.items()}
        return moe_ffn_ep(x, laid, cfg, mesh, axis_name="model")

    for y in run_ranks(4, rank, device=CPU):
        np.testing.assert_allclose(y.numpy(), ref["ep_y_4_drops"],
                                   rtol=1e-4, atol=1e-6)


def test_moe_slots_sent_are_the_priced_pattern(ref, monkeypatch):
    # the occupied slots each rank's dispatch sends to each peer are the
    # token counts workloads.moe derives from the same routing histogram
    # and capacity (the diagonal stays on the rank: no message)
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    x, p = _ep_inputs(ref)
    n = 4
    sent = {}
    real = dist.all_to_all_single

    def spy(output, input, *args, **kwargs):
        sent.setdefault(dist.get_rank(), []).append(input.clone())
        return real(output, input, *args, **kwargs)

    monkeypatch.setattr(dist, "all_to_all_single", spy)
    run_ranks(n, lambda r: moe_ffn_ep(x, p, cfg), device=CPU)
    T = x.shape[0] * x.shape[1]
    C = a2a_capacity(T, cfg)
    counts = np.tile(_route_counts(x, p, cfg), (n, 1))
    pat = pattern_from_counts(counts, cfg.d_model, C)
    want = np.zeros((n, n), dtype=np.int64)
    want[pat.dispatch.src, pat.dispatch.dst] = \
        pat.dispatch.size / (cfg.d_model * ACT_BYTES)
    got = np.zeros((n, n), dtype=np.int64)
    for r in range(n):
        assert len(sent[r]) == 2                # dispatch, then combine
        buf = sent[r][0]
        assert buf.shape == (cfg.n_experts, C, cfg.d_model)
        slots = buf.reshape(n, -1, cfg.d_model).abs().sum(-1) > 0
        got[r] = slots.sum(1).numpy()
        assert got[r, r] == pat.sent[r].reshape(n, -1)[r].sum()
    np.fill_diagonal(got, 0)
    np.testing.assert_array_equal(got, want)
    assert pat.dropped_tokens > 0


# ------------------------------------------------------------------ gpipe --

def _tanh_stage(sp, h):
    for w in sp["w"]:
        h = torch.tanh(h @ w)
    return h


@pytest.mark.parametrize("layout", ["pod_of_4x2", "ring_of_4"])
def test_gpipe_matches_reference(ref, layout):
    stages = stack_stages({"w": _t(ref["pipe_w"])}, 4)
    xs = _t(ref["pipe_x"])

    def rank(r):
        if layout == "ring_of_4":
            return gpipe(_tanh_stage, stages, xs)
        mesh = make_mesh((4, 2), ("pod", "data"), CPU)
        return gpipe(_tanh_stage, stages, xs, mesh, axis="pod")

    n = 8 if layout == "pod_of_4x2" else 4
    for y in run_ranks(n, rank, device=CPU):
        assert float(np.abs(y.numpy() - ref["pipe_y"]).max()) < 1e-5


def test_gpipe_over_hymba_layers_is_forward_hidden():
    cfg = configs.get_smoke_config("hymba-1.5b")
    model = M.init_params(cfg, seed=2, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 1, 16)))
    positions = torch.arange(16)[None]

    def stage_fn(layers, x):
        for lp in layers:
            x = block_forward(x, lp, cfg, positions)[0]
        return x

    stages = stack_stages(model.layers, cfg.n_layers)
    mbs = model.embed[tokens]

    def rank(r):
        with torch.no_grad():
            return gpipe(stage_fn, stages, mbs)

    outs = run_ranks(cfg.n_layers, rank, device=CPU)
    for y in outs:
        got = norm(y, model.final_norm, cfg.norm_type, cfg.norm_eps)
        for m in range(tokens.shape[0]):
            want, _ = M.forward_hidden(model, cfg, tokens[m], remat=False,
                                       device=CPU)
            assert torch.equal(got[m], want)


# ------------------------------------------------------------ compression --

def _linear_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def test_compressed_grads_within_one_step_of_reference(ref):
    params = {"w": _t(ref["cmp_w"])}
    batch = {"x": _t(ref["cmp_x"]), "y": _t(ref["cmp_y"])}
    n = 8

    def rank(r):
        errs, steps = None, []
        for _ in range(EF_STEPS):
            g = shard_grads(_linear_loss, params, batch)["w"]
            x = g if errs is None else g + errs["w"][0]
            scale = float(pmax(x.abs().max())) / 127.0
            mean, errs = dp_grads_compressed(_linear_loss, params, batch,
                                             errors=errs)
            steps.append((mean["w"], errs["w"], scale))
        return steps

    outs = run_ranks(n, rank, device=CPU)
    for step in range(EF_STEPS):
        want_g, want_e = ref[f"cmp_g_{step}"], ref[f"cmp_e_{step}"]
        assert want_e.shape == (n, 16, 4)
        for r, steps in enumerate(outs):
            mean, err, scale = steps[step]
            assert err.shape == (1, 16, 4)
            step_mean = scale / n * (1 + 1e-5)
            assert np.abs(mean.numpy() - want_g).max() <= step_mean
            assert np.abs(err[0].numpy() - want_e[r]).max() <= \
                scale * (1 + 1e-5)


def test_error_feedback_takes_only_the_rank_own_row(ref):
    # each rank passes its own [1, ...] row; the reference's stacked
    # [n, ...] state is refused, not read at some row
    params = {"w": _t(ref["cmp_w"])}
    batch = {"x": _t(ref["cmp_x"]), "y": _t(ref["cmp_y"])}
    stacked = {"w": _t(ref["cmp_e_0"])}
    with pytest.raises(ValueError, match=r"its own \[1, \.\.\.\] row"):
        run_ranks(8, lambda r: dp_grads_compressed(
            _linear_loss, params, batch, errors=stacked), device=CPU)


def test_compressed_grads_of_a_module_alias_its_parameters():
    # each entry of the mean of the ranks' int8 levels lies within half a
    # step (scale / 2) of the mean of the ranks' own gradients; those
    # average to the gradient of the mean loss (bf16 in both: 2^-7)
    cfg = configs.get_smoke_config("hymba-1.5b")
    model = M.init_params(cfg, seed=4, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 16)))

    def loss_fn(m, b):
        return M.lm_loss(m, cfg, b, device=CPU)[0]

    def rank(r):
        mean, errs = dp_grads_compressed(loss_fn, model, {"tokens": tokens})
        own = shard_grads(loss_fn, model, {"tokens": tokens})
        gaps = {}
        for k, g in own.items():
            u = psum(g.float()) / 4
            scale = float(pmax(g.float().abs().max())) / 127.0
            gaps[k] = (float((mean[k] - u).abs().max()), scale, u)
        return mean, errs, gaps

    full = M.init_params(cfg, seed=4, device=CPU).trainable()
    names = [k for k, _ in full.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(
        loss_fn(full, {"tokens": tokens}), list(full.parameters()))))
    for mean, errs, gaps in run_ranks(4, rank, device=CPU):
        assert list(mean) == names and list(errs) == names
        for k in names:
            gap, scale, u = gaps[k]
            assert gap <= 0.5 * scale * (1 + 1e-5), (k, gap, scale)
            assert errs[k].shape == (1,) + tuple(want[k].shape)
            w = want[k].float()
            assert float((u - w).norm()) <= 2 ** -7 * float(w.norm()), k
    assert not any(p.requires_grad for p in model.parameters())


# -------------------------------------------------------------- gloo ranks --

# The three programs on the reference's inputs ``z``, run on every rank of
# the default group: by four gloo processes (``_GLOO``) and by four thread
# ranks (the test, which executes this source).
_PROGRAMS = r"""
import numpy as np
import torch
from repro_torch import configs
from repro_torch.parallel import (dp_grads_compressed, gpipe, moe_ffn_ep,
                                  stack_stages)


def programs(z):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    p = {k: t(z["ep_" + k]) for k in ("router", "w1", "w3", "w2")}
    y = moe_ffn_ep(t(z["ep_x"]), p, cfg)

    def stage(sp, h):
        for w in sp["w"]:
            h = torch.tanh(h @ w)
        return h

    pipe = gpipe(stage, stack_stages({"w": t(z["pipe_w"])}, 4),
                 t(z["pipe_x"]))
    loss = lambda q, b: torch.mean((b["x"] @ q["w"] - b["y"]) ** 2)
    g, e = dp_grads_compressed(loss, {"w": t(z["cmp_w"])},
                               {"x": t(z["cmp_x"]), "y": t(z["cmp_y"])})
    return {"ep": y, "pipe": pipe, "g": g["w"], "e": e["w"]}
"""

_GLOO = _PROGRAMS + r"""
import sys
import torch.distributed as dist
import torch.multiprocessing as mp

REF, OUT, PORT = sys.argv[1], sys.argv[2], int(sys.argv[3])


def worker(rank):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            rank=rank, world_size=4)
    try:
        with np.load(REF) as z:
            out = programs(z)
        np.savez(f"{OUT}.{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(worker, nprocs=4, start_method="fork")
"""


def test_programs_on_four_gloo_ranks_equal_the_threaded_world(
        ref, tmp_path):
    from repro_torch.launch.mesh import _free_port
    path = tmp_path / "in.npz"
    np.savez(path, **ref)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _GLOO, str(path),
                          str(tmp_path / "out"), str(_free_port())],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ns = {}
    exec(_PROGRAMS, ns)
    with np.load(path) as z:
        threaded = run_ranks(4, lambda r: ns["programs"](z), device=CPU)
    for r, want in enumerate(threaded):
        with np.load(tmp_path / f"out.{r}.npz") as got:
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------- run_ranks --

def test_run_ranks_returns_in_rank_order_and_restores_the_world():
    before = torch._C._is_multithreading_enabled()

    def rank(r):
        x = torch.full((2,), float(r))
        return r, ppermute(x, [(i, (i + 1) % 3) for i in range(3)])

    outs = run_ranks(3, rank, device=CPU)
    assert [r for r, _ in outs] == [0, 1, 2]
    assert [float(y[0]) for _, y in outs] == [2.0, 0.0, 1.0]
    assert not dist.is_initialized()
    assert torch._C._is_multithreading_enabled() == before
    # a rank no pair sends to gets zeros
    outs = run_ranks(3, lambda r: ppermute(torch.ones(2) * (r + 1),
                                           [(0, 2)]), device=CPU)
    assert [y.tolist() for y in outs] == [[0, 0], [0, 0], [1, 1]]


def test_run_ranks_raises_the_first_rank_error_without_hanging():
    def rank(r):
        if r == 2:
            raise ValueError("rank two fails")
        return pmax(torch.tensor(float(r)))      # the others wait here

    with pytest.raises(ValueError, match="rank two fails") as info:
        run_ranks(4, rank, device=CPU, timeout=60)
    assert any("rank 2 of 4" in n for n in info.value.__notes__)
    assert not dist.is_initialized()
    assert threading.active_count() < 20
    # the world is usable again at once
    assert run_ranks(2, lambda r: float(pmax(torch.tensor(float(r)))),
                     device=CPU) == [1.0, 1.0]


def test_run_ranks_times_out_a_world_that_does_not_finish():
    def rank(r):
        if r == 0:
            pmax(torch.tensor(1.0))       # rank 1 never joins
        return r

    with pytest.raises(TimeoutError, match="not done"):
        run_ranks(2, rank, device=CPU, timeout=2)
    assert run_ranks(2, lambda r: r, device=CPU) == [0, 1]


def test_run_ranks_does_not_nest_and_needs_cuda_unless_asked(monkeypatch):
    with one_rank_world("gloo"):
        with pytest.raises(RuntimeError, match="do not nest"):
            run_ranks(2, lambda r: r, device=CPU)
    with pytest.raises(ValueError, match="not a permutation"):
        run_ranks(2, lambda r: ppermute(torch.ones(1), [(0, 1), (1, 1)]),
                  device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(2, lambda r: r)


def test_launch_counts_lose_no_update_across_threads():
    # ranks as threads launch kernels at once: the shared counts are
    # bumped under a lock, so none of 64 x 2,000 increments is lost
    from repro_torch.kernels.build import count
    launches = {"a": 0, "b": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            count(launches, "a", "b") for _ in range(2000)])
            for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert launches == {"a": 128000, "b": 128000}


def test_programs_need_a_group_that_fits():
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")   # 8 experts
    x = torch.zeros(1, 4, cfg.d_model)
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    with pytest.raises(ValueError, match="do not split over 3"):
        run_ranks(3, lambda r: moe_ffn_ep(x, p, cfg), device=CPU)
    with pytest.raises(ValueError, match="do not split into 3"):
        stack_stages({"w": torch.zeros(8, 2)}, 3)
    with pytest.raises(ValueError, match="do not split over 3"):
        run_ranks(3, lambda r: dp_grads_compressed(
            _linear_loss, {"w": torch.zeros(2, 1)},
            {"x": torch.zeros(4, 2), "y": torch.zeros(4, 1)}), device=CPU)
