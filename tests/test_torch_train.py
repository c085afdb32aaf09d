"""Training on the port against the JAX package: the loss, its gradients,
AdamW, the train step, and K4's and K5's backwards.

Every config's smoke version runs in float32 on the reference's weights
(``repro.nn.init_params`` carried over by ``params_from_numpy``) and one
seeded batch of 2 x 32 tokens (patch embeddings for qwen2-vl, frame
embeddings for whisper).  Bounds, each named where it is held:

* the loss, ``nll`` and ``aux`` within rtol 1e-5 of
  ``jax.value_and_grad`` of ``repro.nn.lm_loss``;
* every gradient leaf within 1e-4 relative L2 with an atol floor of 1e-6
  (``LEAF_RTOL``, ``LEAF_ATOL``: qwen2-vl's ``embed`` gets no gradient in
  either package);
* over three carried AdamW steps, the moments bit-equal to the
  reference's while the clip is inactive; with it active, the global
  norm (whose sum runs over other leaves in another order) within rtol
  1e-5 and the moments within rtol 2e-5 (v is quadratic in the clip
  scale) plus 2e-5 of the leaf's largest moment (an element that cancels
  keeps its terms' error); float32 parameters within rtol 1e-6 and bf16
  parameters within one bf16 ulp;
* after a whole train step the parameters within ``2 lr`` of the
  reference's (at step 1 AdamW moves each element by ``lr`` times the
  sign of its gradient, which a rounding can flip for a near-zero
  gradient);
* K4's and K5's backwards within rtol 1e-5 of the largest gradient entry
  of ``torch.autograd`` of their plain versions in float32; in bf16, K4's
  within 2^-6 of it (both sides round each gradient to bf16, and the
  backward's ``rowsum(dO * O)`` reads the bf16 output).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import nn as ref_nn  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ssd  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.nn import (forward_hidden, init_params,  # noqa: E402
                            lm_loss, params_from_numpy, params_to_numpy)
from repro_torch.nn.model import (named_from_tree,  # noqa: E402
                                  named_to_tree, param_dtype)
from repro_torch.train import Trainer, TrainConfig  # noqa: E402
from repro_torch.train.optim import (AdamWConfig, adamw_update,  # noqa: E402
                                     init_opt_state, opt_state_from_numpy,
                                     opt_state_to_numpy, schedule)

LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
MOMENT_RTOL = 1e-6
NORM_RTOL = 1e-5
CLIPPED_MOMENT_RTOL = 2 * NORM_RTOL
KERNEL_RTOL = 1e-5
K4_BF16_RTOL = 2.0 ** -6
B, S = 2, 32


def batch_for(cfg, seed=0, B=B, S=S):
    """A seeded training batch of ``cfg``'s family as numpy arrays, in the
    reference's batch contract."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32),
                "positions": np.broadcast_to(
                    np.arange(S, dtype=np.int32)[None, :, None],
                    (B, S, 3)).copy(),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def ref_tree(arch):
    """The reference's float32 parameters of ``arch``'s smoke config."""
    params = ref_nn.init_params(ref_configs.get_smoke_config(arch), 0)
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def port_model(arch, tree, dtype=torch.float32):
    cfg = configs.get_smoke_config(arch)
    return cfg, params_from_numpy(np_tree(tree), cfg, device="cpu",
                                  dtype=dtype)


def port_grads(model, cfg, batch, **kw):
    """(loss, metrics, {name: grad}) of the port's ``lm_loss``."""
    model.trainable()
    loss, metrics = lm_loss(model, cfg, batch, device="cpu", **kw)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), metrics, {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(named.items(), grads)}


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v, dtype=np.float32)


def assert_leaves_close(got: dict, want: dict, what: str):
    """Every leaf of ``got`` within LEAF_RTOL relative L2 of ``want``'s
    plus the LEAF_ATOL floor; the same leaves on both sides."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w)
        assert err <= LEAF_RTOL * np.linalg.norm(w) + LEAF_ATOL, \
            f"{what} {k}: |diff| {err}, |want| {np.linalg.norm(w)}"


# -- the loss and its gradients ------------------------------------------------
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_lm_loss_and_gradients_match_reference(arch):
    rcfg = ref_configs.get_smoke_config(arch)
    tree = ref_tree(arch)
    batch = batch_for(rcfg)

    def loss_fn(p):
        return ref_nn.lm_loss(p, rcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()})

    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    cfg, model = port_model(arch, tree)
    loss, metrics, grads = port_grads(model, cfg, batch)
    for got, want, what in ((loss, r_loss, "loss"),
                            (metrics["nll"], r_m["nll"], "nll"),
                            (metrics["aux"], r_m["aux"], "aux")):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=f"{arch} {what}")
    assert np.isfinite(float(loss))
    assert_leaves_close(named_to_tree({n: g.numpy() for n, g in
                                       grads.items()}),
                        np_tree(r_grads), f"{arch} gradient")


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_remat_on_and_off_give_the_same_gradients(arch):
    cfg, model = port_model(arch, ref_tree(arch))
    batch = batch_for(cfg, seed=1)
    l_on, _, g_on = port_grads(model, cfg, batch, remat=True)
    l_off, _, g_off = port_grads(model, cfg, batch, remat=False)
    # the recompute runs the same ops on the same values
    assert torch.equal(l_on, l_off)
    for name, g in g_on.items():
        assert torch.equal(g, g_off[name]), name


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b",
                                  "qwen2-vl-72b"])
def test_loss_chunk_below_and_at_seq_give_the_same_loss(arch):
    rcfg = ref_configs.get_smoke_config(arch)
    tree = ref_tree(arch)
    cfg, model = port_model(arch, tree)
    batch = batch_for(cfg, seed=2)
    whole, _, g_whole = port_grads(model, cfg, batch, loss_chunk=S)
    chunked, _, g_chunked = port_grads(model, cfg, batch, loss_chunk=S // 4)
    # the chunks sum in another order
    np.testing.assert_allclose(float(chunked), float(whole), rtol=LOSS_RTOL)
    assert_leaves_close(named_to_tree({n: g.numpy()
                                       for n, g in g_chunked.items()}),
                        named_to_tree({n: g.numpy()
                                       for n, g in g_whole.items()}),
                        f"{arch} chunked gradient")
    want, _ = ref_nn.lm_loss(tree, rcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                             loss_chunk=S // 4)
    np.testing.assert_allclose(float(chunked), float(want), rtol=LOSS_RTOL)


def test_forward_hidden_is_forward_logits_before_the_unembedding():
    cfg, model = port_model("hymba-1.5b", ref_tree("hymba-1.5b"))
    tokens = batch_for(cfg)["tokens"]
    x, aux = forward_hidden(model, cfg, tokens, device="cpu")
    want = ref_nn.forward_logits(ref_tree("hymba-1.5b"),
                                 ref_configs.get_smoke_config("hymba-1.5b"),
                                 jnp.asarray(tokens))[0]
    logits = (x @ model.embed.T if cfg.tie_embeddings else x @ model.lm_head)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


# -- AdamW -------------------------------------------------------------------
def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element of ``a`` (float32 holding bf16
    values)."""
    exp = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (exp - 7)


@pytest.mark.parametrize("clip", [0.5, 1e9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_and_schedule_match_reference_on_carried_state(dtype, clip):
    # clip 1e9 leaves the clip scale at 1 exactly: every element takes the
    # reference's operations in its order, so the moments are bit-equal.
    # Clip 0.5 scales the gradients by grad_clip / |g|, whose norm sums
    # the leaves in another order (within NORM_RTOL): the moments within
    # twice that (v is quadratic in the scale), with an atol of as much of
    # the leaf's largest entry for elements that cancel towards 0.
    exact = clip > 1e8
    arch = "hymba-1.5b"
    rcfg = ref_configs.get_smoke_config(arch)
    r_params = ref_nn.init_params(rcfg, 0)
    if dtype == "float32":
        r_params = jax.tree.map(lambda a: a.astype(jnp.float32), r_params)
    cfg = configs.get_smoke_config(arch)
    model = params_from_numpy(np_tree(r_params), cfg, device="cpu",
                              dtype=torch.float32 if dtype == "float32"
                              else None)
    names = [n for n, _ in model.named_parameters()]
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                       grad_clip=clip)
    r_cfg = ref_optim.AdamWConfig(**dataclasses.asdict(ocfg))
    r_state = ref_optim.init_opt_state(r_params)
    state = init_opt_state(model)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), np_tree(r_params))
        r_grads = jax.tree.map(lambda g, p: jnp.asarray(g).astype(p.dtype),
                               g_np, r_params)
        r_params, r_state, r_met = ref_optim.adamw_update(
            r_params, r_grads, r_state, r_cfg)
        grads = {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(
                     p.dtype)
                 for (n, p), a in zip(model.named_parameters(),
                                      named_from_tree(np_tree(r_grads),
                                                      names).values())}
        model, state, met = adamw_update(model, grads, state, ocfg)
        np.testing.assert_allclose(float(met["lr"]), float(r_met["lr"]),
                                   rtol=MOMENT_RTOL)
        # the norm's sum runs over other leaves in another order
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(r_met["grad_norm"]), rtol=NORM_RTOL)
        np.testing.assert_allclose(
            float(schedule(ocfg, state["step"])),
            float(ref_optim.schedule(r_cfg, r_state["step"])),
            rtol=MOMENT_RTOL)
    assert int(state["step"]) == int(r_state["step"]) == 3
    got = opt_state_to_numpy(state)
    for which in ("m", "v"):
        want = dict(leaves(np_tree(r_state[which])))
        for k, a in leaves(got[which]):
            rtol = 0.0 if exact else CLIPPED_MOMENT_RTOL
            np.testing.assert_allclose(a, want[k], rtol=rtol,
                                       atol=rtol * np.abs(want[k]).max(),
                                       err_msg=f"{which} {k}")
    want = dict(leaves(np_tree(r_params)))
    for k, a in leaves(params_to_numpy(model)):
        w = want[k]
        if dtype == "bfloat16" and param_dtype(tuple(k.split("/"))) \
                == torch.bfloat16:
            assert np.all(np.abs(a - w) <= bf16_ulp(w)), k
        else:
            # XLA's division and square root round a few float32 ulps
            # apart from torch's now and then, even on equal moments
            np.testing.assert_allclose(a, w, rtol=MOMENT_RTOL, atol=1e-7,
                                       err_msg=k)


def test_opt_state_round_trips_the_reference_tree():
    arch = "deepseek-moe-16b"
    r_params = ref_nn.init_params(ref_configs.get_smoke_config(arch), 0)
    rng = np.random.default_rng(4)
    r_state = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape)
                                 .astype(np.float32), np_tree(r_params)),
               "v": jax.tree.map(lambda a: rng.random(a.shape)
                                 .astype(np.float32), np_tree(r_params)),
               "step": np.asarray(7, np.int32)}
    cfg, model = port_model(arch, r_params)
    state = opt_state_from_numpy(r_state, model, device="cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    for name, p in model.named_parameters():
        assert state["m"][name].shape == p.shape
        assert state["m"][name].dtype == torch.float32
    back = opt_state_to_numpy(state)
    for which in ("m", "v"):
        assert dict(leaves(back[which])).keys() == \
            dict(leaves(r_state[which])).keys()
        for k, a in leaves(back[which]):
            np.testing.assert_array_equal(a, dict(leaves(
                r_state[which]))[k])
    assert back["step"].dtype == np.int32 and int(back["step"]) == 7


# -- the train step ----------------------------------------------------------
@pytest.mark.parametrize("arch,microbatches", [
    ("tinyllama-1.1b", 1), ("tinyllama-1.1b", 2), ("qwen3-moe-30b-a3b", 2),
    ("hymba-1.5b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    rcfg = ref_configs.get_smoke_config(arch)
    tree = ref_tree(arch)
    batch = batch_for(rcfg, seed=5, S=16)
    ocfg = AdamWConfig(warmup_steps=1, total_steps=10)
    r_step = jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.AdamWConfig(**dataclasses.asdict(ocfg)),
        microbatches=microbatches))
    r_params, r_state, r_met = r_step(
        tree, ref_optim.init_opt_state(tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, model = port_model(arch, tree)
    step = make_train_step(cfg, ocfg, microbatches=microbatches,
                           device="cpu")
    model, state, met = step(model, init_opt_state(model), batch)
    assert set(met) == {"loss", "nll", "aux", "grad_norm", "lr"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(r_met[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    lr = float(r_met["lr"])
    for (k, a), (_, b) in zip(sorted(leaves(params_to_numpy(model))),
                              sorted(leaves(np_tree(r_params)))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * lr,
                                   err_msg=k)
    assert_leaves_close(opt_state_to_numpy(state)["m"],
                        np_tree(r_state["m"]), f"{arch} first moment")
    assert int(state["step"]) == 1


def test_train_step_puts_a_numpy_batch_on_the_device_and_updates_in_place():
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    model = init_params(cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_opt_state(model)
    m_before = state["m"]["embed"]
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1), device="cpu")
    out, state, met = step(model, state, batch_for(cfg, S=8))
    assert out is model and state["m"]["embed"] is m_before
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert all(p.requires_grad for p in model.parameters())
    assert all(t.dim() == 0 for t in met.values())


# -- K4's and K5's Functions --------------------------------------------------
def rel_max(a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    err = float((a.float() - b.float()).abs().max())
    return err / float(b.float().abs().max()) if err else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_matches_autograd_of_plain(causal, rep,
                                                            dtype):
    rng = np.random.default_rng(rep + 10 * causal)
    Bq, Sq, KH, D = 2, 37, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((Bq, Sq, h, D)).astype(
        np.float32)).to(dtype).requires_grad_() for h in (KH * rep, KH, KH))
    dout = torch.from_numpy(rng.standard_normal(
        (Bq, Sq, KH * rep, D)).astype(np.float32)).to(dtype)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=causal),
                              (q, k, v), dout)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, causal),
                               (q, k, v), dout)
    bound = K4_BF16_RTOL if dtype == torch.bfloat16 else KERNEL_RTOL
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == dtype and g.shape == w.shape
        assert rel_max(g, w) <= bound, (name, rel_max(g, w))


def test_flash_attention_backward_blocks_the_queries(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (1, 50, h, 16)).astype(np.float32)) for h in (4, 2, 2, 4))
    out = fa.flash_attention_plain(q, k, v)
    whole = fa.flash_attention_backward_plain(q, k, v, out, dout)
    # 4 heads x 50 keys x 3 queries: blocks of 3 rows, the last ragged
    monkeypatch.setattr(fa, "BACKWARD_BLOCK_ELEMS", 4 * 50 * 3)
    assert fa.backward_rows(1, 4, 50) == 3
    for g, w in zip(fa.flash_attention_backward_plain(q, k, v, out, dout),
                    whole):
        assert rel_max(g, w) <= KERNEL_RTOL


@pytest.mark.parametrize("q_len,n,p,form", [
    (16, 8, 16, "expanded"), (24, 16, 18, "expanded"), (7, 4, 5, "flat"),
    (1, 3, 4, "expanded"), (100, 16, 64, "flat")])
def test_ssd_backward_matches_autograd_of_plain(q_len, n, p, form):
    rng = np.random.default_rng(q_len)
    G1, h = 3, 5

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()

    dtx0, b0, c0 = t(G1, q_len, h, p), t(G1, 1, q_len, n), t(G1, 1, q_len, n)
    a0 = torch.from_numpy((-0.1 * rng.random((G1, q_len, h))).astype(
        np.float32)).requires_grad_()
    gy = torch.from_numpy(rng.standard_normal((G1 * h, q_len, p)).astype(
        np.float32))
    gs = torch.from_numpy(rng.standard_normal((G1 * h, n, p)).astype(
        np.float32))
    leaves_ = (dtx0, b0, c0, a0)

    def run(fn):
        cumA = a0.cumsum(1).permute(0, 2, 1)[..., None]
        args = (dtx0.permute(0, 2, 1, 3), b0.expand(G1, h, q_len, n),
                c0.expand(G1, h, q_len, n), cumA)
        if form == "flat":          # [G, q, x], as the reference's kernel
            args = tuple(a.reshape(G1 * h, q_len, -1) for a in args)
        y, s = fn(*args)
        return torch.autograd.grad((y * gy).sum() + (s * gs).sum(), leaves_)

    for g, w, name in zip(run(ops.ssd_intra_chunk),
                          run(ssd.ssd_intra_chunk_plain),
                          ("dtx", "Bm", "Cm", "cumA")):
        assert g.shape == w.shape
        assert rel_max(g, w) <= KERNEL_RTOL, (name, rel_max(g, w))


def test_ssd_backward_returns_the_expanded_shape_and_writes_no_input():
    G1, h, q_len, n, p = 2, 3, 8, 4, 5
    dtx = torch.randn(G1, h, q_len, p)
    Bm = torch.randn(G1, 1, q_len, n).expand(G1, h, q_len, n)
    Cm = torch.randn(G1, 1, q_len, n).expand(G1, h, q_len, n)
    cumA = (-torch.rand(G1, h, q_len, 1)).cumsum(2)
    before = [t.clone() for t in (dtx, Bm, Cm, cumA)]
    grads = ssd.ssd_intra_chunk_backward(dtx, Bm, Cm, cumA,
                                         torch.randn(G1 * h, q_len, p),
                                         torch.randn(G1 * h, n, p))
    for g, t, b in zip(grads, (dtx, Bm, Cm, cumA), before):
        assert g.shape == t.shape
        assert torch.equal(t, b)
    # a gradient a head for the stride-0 inputs, which the expand sums
    assert grads[1].stride()[1] != 0 and grads[2].stride()[1] != 0
    assert not torch.equal(grads[1][:, 0], grads[1][:, 1])


def test_functions_launch_once_under_no_grad(monkeypatch):
    # under no_grad the Function is the wrapper's one call
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a: calls.append(a) or real(*a))
    q = torch.randn(1, 8, 2, 16)
    with torch.no_grad():
        out = ops.flash_attention(q, q, q)
    assert len(calls) == 1 and not out.requires_grad
    assert torch.equal(out, fa.flash_attention_plain(q, q, q))


# -- no fallback ---------------------------------------------------------------
@pytest.mark.parametrize("which", ["flash_attention", "ssd_intra_chunk"])
def test_functions_never_run_the_plain_version_off_the_cpu(monkeypatch,
                                                           which):
    # told its tensors lie on the card, a Function goes to the kernel, and
    # a kernel that cannot be built raises instead of falling back
    mod = fa if which == "flash_attention" else ssd
    real_check = mod._check

    def on_card(*args):
        out = real_check(*args)
        dev = torch.device("cuda")
        return (dev,) + out[1:] if isinstance(out, tuple) else dev

    def no_kernel(*_):
        raise RuntimeError("nvcc not found")

    def plain(*_, **__):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(mod, "_check", on_card)
    monkeypatch.setattr(mod, "kernel", no_kernel)
    monkeypatch.setattr(mod, f"{which}_plain", plain)
    if which == "flash_attention":
        args = [torch.zeros(1, 8, 2, 16, requires_grad=True)] * 3
    else:
        args = [torch.zeros(2, 8, 4, requires_grad=True),
                torch.zeros(2, 8, 3), torch.zeros(2, 8, 3),
                torch.zeros(2, 8, 1)]
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(ops, which)(*args)
    assert mod.LAUNCHES == before


def test_training_entry_points_refuse_to_fall_back_to_cpu(monkeypatch,
                                                          tmp_path):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    cfg = configs.get_smoke_config("tinyllama-1.1b")
    model = init_params(cfg, device="cpu")
    batch = batch_for(cfg, S=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lm_loss(model, cfg, batch),
                 lambda: forward_hidden(model, cfg, batch["tokens"]),
                 lambda: make_train_step(cfg)(model, init_opt_state(model),
                                              batch),
                 lambda: Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path))),
                 lambda: opt_state_from_numpy(
                     opt_state_to_numpy(init_opt_state(model)), model),
                 lambda: train_cli.main(["--smoke", "--ckpt-dir",
                                         str(tmp_path)]),
                 lambda: serve_cli.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert np.isfinite(float(lm_loss(model, cfg, batch, device="cpu")[0]))


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_functions_backward_match_autograd_of_plain(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = fa.LAUNCHES["flash_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            q, k, v = (torch.randn(2, 200, h, 64, generator=gen, device=cuda)
                       .to(dtype).requires_grad_() for h in (10, 2, 2))
            dout = torch.randn(2, 200, 10, 64, generator=gen,
                               device=cuda).to(dtype)
            got = torch.autograd.grad(ops.flash_attention(q, k, v, causal),
                                      (q, k, v), dout)
            want = torch.autograd.grad(
                fa.flash_attention_plain(q, k, v, causal), (q, k, v), dout)
            bound = K4_BF16_RTOL if dtype == torch.bfloat16 else 1e-4
            for g, w in zip(got, want):
                assert rel_max(g, w) <= bound
    assert fa.LAUNCHES["flash_attention"] == before + 4
    G1, h, q_len, n, p = 4, 5, 100, 16, 64
    dtx = torch.randn(G1, q_len, h, p, device=cuda, requires_grad=True)
    bb = torch.randn(G1, 1, q_len, n, device=cuda, requires_grad=True)
    cc = torch.randn(G1, 1, q_len, n, device=cuda, requires_grad=True)
    a = (-0.1 * torch.rand(G1, q_len, h, device=cuda)).requires_grad_()

    def run(fn):
        y, s = fn(dtx.permute(0, 2, 1, 3), bb.expand(G1, h, q_len, n),
                  cc.expand(G1, h, q_len, n),
                  a.cumsum(1).permute(0, 2, 1)[..., None])
        return torch.autograd.grad(y.square().sum() + s.sum(),
                                   (dtx, bb, cc, a))

    before = ssd.LAUNCHES["ssd_intra_chunk"]
    for g, w in zip(run(ops.ssd_intra_chunk),
                    run(ssd.ssd_intra_chunk_plain)):
        assert rel_max(g, w) <= 1e-4
    assert ssd.LAUNCHES["ssd_intra_chunk"] == before + 1


@pytest.mark.gpu
def test_cuda_training_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("hymba-1.5b", "deepseek-moe-16b", "whisper-small"):
        cfg = configs.get_smoke_config(arch)
        tree = params_to_numpy(init_params(cfg, device="cpu"))
        batch = batch_for(cfg, S=64)
        got = {}
        for dev in ("cuda", "cpu"):
            model = params_from_numpy(tree, cfg, device=dev,
                                      dtype=torch.float32).trainable()
            loss, _ = lm_loss(model, cfg, batch, device=dev)
            named = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            got[dev] = (float(loss.detach()), named_to_tree({
                n: (torch.zeros_like(p) if g is None else g).cpu().numpy()
                for (n, p), g in zip(named.items(), grads)}))
        np.testing.assert_allclose(got["cuda"][0], got["cpu"][0],
                                   rtol=LOSS_RTOL)
        assert_leaves_close(got["cuda"][1], got["cpu"][1], arch)
