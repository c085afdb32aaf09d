"""The language model of the PyTorch port against the JAX package: configs,
the parameter tree, prefill, greedy decode and the serving engine.

The reference's parameters (``repro.nn.init_params``) are carried into the
port with ``params_from_numpy``, so both run on the same weights.  Smoke
configs of every family (hymba: hybrid, mamba2: ssm, llama3.2 and
tinyllama: dense attention, starcoder2: gelu MLP and layernorm, qwen3-32b:
qk-norm, deepseek-moe-16b: MoE with a leading dense layer and shared
experts, qwen3-moe-30b-a3b: MoE with qk-norm, whisper-small: encoder and
cross-attention on frame embeddings, qwen2-vl-72b: patch embeddings through
the frontend with M-RoPE): in float32 the prefill logits and cache and 8
decode steps agree at rtol/atol 1e-4 and pick the same greedy tokens; in
bfloat16 they agree at rtol/atol 0.1, the bound the reference holds its own
prefill to its full forward (``tests/test_nn_models.py``).  The
reference's prefill leaves deepseek's leading dense layer out of the cache
(ROADMAP §3), so its cache is completed by its own functions
(:func:`complete_dense_cache`) before it decodes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import nn as ref_nn  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.nn import (cache_shapes, decode_step,  # noqa: E402
                            forward_logits, init_cache, init_params,
                            param_shapes, params_from_numpy,
                            params_to_numpy, prefill)
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCHS = ["hymba-1.5b", "mamba2-130m", "llama3.2-3b", "tinyllama-1.1b",
         "starcoder2-3b", "qwen3-32b", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b", "whisper-small", "qwen2-vl-72b"]
#: The port's ArchConfig fields the reference's lacks, at their defaults.
PORT_ONLY_FIELDS = {"layer_types": (), "embedding_multiplier": 1.0,
                    "residual_multiplier": 1.0, "logits_scaling": 1.0,
                    "attention_multiplier": 0.0, "router_experts": 0,
                    "expert_first": 0}
F32_TOL = 1e-4
BF16_TOL = 0.1
N_DECODE = 8


def _ref_params(arch, f32: bool):
    params = ref_nn.init_params(ref_configs.get_smoke_config(arch), 0)
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().cpu().numpy(), _np(want),
                               rtol=tol, atol=tol, err_msg=what)


def model_inputs(cfg, B, S, seed):
    """The prompt of a family as numpy arrays, keyed as the port's
    ``prefill`` takes them: tokens, or patch embeddings [B, S, d] for a
    frontend with M-RoPE (qwen2-vl); frame embeddings [B, encoder_seq, d]
    for an encoder (whisper)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch_embed":
        out = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_layers:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def ref_inputs(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def complete_dense_cache(ref_p, rcfg, tokens, r_cache, max_seq):
    """The reference's prefill cache with the leading dense layers' k/v it
    leaves out, made by its own ``block_forward(..., collect_cache=True)``
    on ``_dense_view`` and padded to ``max_seq`` as its prefill pads."""
    from repro.nn.blocks import block_forward
    from repro.nn.model import _dense_view, _embed, _index_layer

    tokens = jnp.asarray(tokens)
    B, S = tokens.shape
    x = _embed(ref_p, rcfg, tokens)
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    kv = {"k": [], "v": []}
    for i in range(rcfg.first_dense_layers):
        x, _, el = block_forward(x, _index_layer(ref_p["dense_layers"], i),
                                 _dense_view(rcfg), positions,
                                 collect_cache=True)
        for name in kv:
            kv[name].append(el[name])
    pad = ((0, 0), (0, 0), (0, max_seq - S), (0, 0), (0, 0))
    return dict(r_cache, dense_layers={
        name: jnp.pad(jnp.stack(ts), pad) for name, ts in kv.items()})


def snap(cache):
    """A copy of a port cache (decode writes it in place)."""
    return {g: {k: t.clone() for k, t in d.items()} for g, d in cache.items()}


# -- configs -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_equal_repro(arch, smoke):
    # field for field on the reference's fields; the fields only the port
    # has (granite's stack and scalars, an expert share) at the defaults
    # that change nothing
    get = "get_smoke_config" if smoke else "get_config"
    cfg, ref = getattr(configs, get)(arch), getattr(ref_configs, get)(arch)
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
    assert {k: mine[k] for k in theirs} == theirs
    assert {k: mine[k] for k in set(mine) - set(theirs)} == PORT_ONLY_FIELDS
    for prop in ("head_dim", "is_moe", "has_attention", "has_ssm",
                 "ssm_d_inner", "ssm_heads", "supports_long_context",
                 "block_kind"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()


def test_hymba_full_width_parameter_count():
    cfg = configs.get_config("hymba-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ssm_heads, cfg.ssm_chunk) == \
        (32, 1600, 25, 5, 64, 50, 128)
    assert cfg.n_params() == 1_640_144_000


def test_registry_ids_and_shapes_equal_repro():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert set(ARCHS) == set(configs.ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            assert configs.cell_applicable(configs.get_config(arch), shape) \
                == ref_configs.cell_applicable(ref_configs.get_config(arch),
                                               ref_configs.SHAPES[name])
    # the port's registry also holds its own ids, after the reference's
    assert configs.ALL_IDS == configs.ARCH_IDS + configs.PORT_ONLY_IDS
    assert configs.PORT_ONLY_IDS == ("granite-4.0-h-small",)
    cells = configs.all_cells(configs.all_configs())
    assert len(cells) == 4 * len(configs.ALL_IDS) == 44
    assert cells[:40] == ref_configs.all_cells(ref_configs.all_configs())


def test_unknown_arch_raises_key_error():
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch 'gpt-2'"):
            get("gpt-2")


# -- layers --------------------------------------------------------------------
@pytest.mark.parametrize("layer", ["rmsnorm", "layernorm", "rope", "swiglu",
                                   "gelu"])
def test_layers_match_repro(layer):
    from repro.nn import layers as ref_layers
    from repro_torch.nn import layers
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    w = {n: (rng.standard_normal(sh) / 4).astype(np.float32) for n, sh in
         (("w1", (16, 24)), ("w3", (16, 24)), ("w2", (24, 16)),
          ("scale", (16,)), ("bias", (16,)))}
    pos = np.broadcast_to(np.arange(12), (2, 12))
    if layer == "rope":
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(
            pos.copy()), 1e4)
    elif layer in ("rmsnorm", "layernorm"):
        p = {k: w[k] for k in ("scale", "bias")}
        want = ref_layers.norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                in p.items()}, layer, 1e-6)
        got = layers.norm(torch.from_numpy(x), {k: torch.from_numpy(v) for
                                                k, v in p.items()}, layer,
                          1e-6)
    else:
        want = ref_layers.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                               in w.items()}, layer)
        got = layers.mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for
                                               k, v in w.items()}, layer)
    assert got.shape == want.shape
    _close(got, want, F32_TOL, layer)


# -- parameters and cache ------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_shapes_equal_repro(arch):
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    assert param_shapes(cfg) == ref_nn.param_shapes(rcfg)
    assert cache_shapes(cfg, 3, 40) == ref_nn.cache_shapes(rcfg, 3, 40)
    ref_cache = ref_nn.init_cache(rcfg, 3, 40)
    cache = init_cache(cfg, 3, 40, device="cpu")
    assert set(cache) == set(ref_cache)
    for group, leaves in cache.items():
        assert set(leaves) == set(ref_cache[group])
        for name, t in leaves.items():
            want = ref_cache[group][name]
            assert tuple(t.shape) == want.shape
            assert str(t.dtype).split(".")[-1] == str(want.dtype)
            assert not t.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_every_leaf(arch):
    cfg = configs.get_smoke_config(arch)
    ref = jax.tree.map(np.asarray, _ref_params(arch, f32=False))
    model = params_from_numpy(ref, cfg, device="cpu")
    back = params_to_numpy(model)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], _np(leaf),
                                      err_msg=str(path))
    # each leaf keeps the reference's dtype: bf16 weights, f32 scalars
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0]["ln1"]["scale"].dtype == torch.float32
    f32 = params_from_numpy(ref, cfg, device="cpu", dtype=torch.float32)
    assert {p.dtype for p in f32.parameters()} == {torch.float32}
    assert not any(p.requires_grad for p in f32.parameters())


@pytest.mark.parametrize("bad", ["missing", "extra", "shape"])
def test_params_from_numpy_rejects_a_foreign_tree(bad):
    cfg = configs.get_smoke_config("llama3.2-3b")
    tree = jax.tree.map(np.asarray, _ref_params("llama3.2-3b", f32=True))
    if bad == "missing":
        del tree["layers"]["mlp"]["w3"]
    elif bad == "extra":
        tree["lm_head"] = np.zeros((cfg.d_model, cfg.vocab_size))
    else:
        tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError):
        params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_reference_recipe(arch):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    tree = params_to_numpy(model)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        np.shape, jax.tree.map(np.asarray, _ref_params(arch, True)))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    lp = model.layers[0]
    assert torch.all(lp["ln1"]["scale"] == 1)
    if "ssm" in lp:
        assert torch.all(lp["ssm"]["conv_b"] == 0)
        np.testing.assert_allclose(
            lp["ssm"]["A_log"].numpy(),
            np.log(np.linspace(1, 16, cfg.ssm_heads)), rtol=1e-6)
    w = tree["embed"]
    assert abs(w.std() * np.sqrt(cfg.vocab_size) - 1) < 0.1


# -- prefill and decode against repro ------------------------------------------
def _run_both(arch, f32: bool, B=2, S=32, max_seq=48):
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    ref_p = _ref_params(arch, f32)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                              device="cpu",
                              dtype=torch.float32 if f32 else None)
    inputs = model_inputs(cfg, B, S, seed=1)
    r_logits, r_cache = ref_nn.prefill(ref_p, rcfg, max_seq=max_seq,
                                       **ref_inputs(inputs))
    if rcfg.first_dense_layers:
        r_cache = complete_dense_cache(ref_p, rcfg, inputs["tokens"],
                                       r_cache, max_seq)
    prefill_step = make_prefill_step(cfg, max_seq=max_seq, device="cpu")
    batch = {"frames" if k == "enc_frames" else k: v
             for k, v in inputs.items()}
    logits, cache = prefill_step(model, batch)
    # the port's decode updates the cache in place: keep copies to compare
    out = [("prefill", logits, r_logits, snap(cache), r_cache)]
    serve_step = make_serve_step(cfg, device="cpu")
    r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
    tok = logits.argmax(-1)
    for i in range(N_DECODE):
        r_logits, r_cache = ref_nn.decode_step(ref_p, rcfg, r_cache, r_tok,
                                               S + i)
        logits, cache = serve_step(model, cache, tok, S + i)
        out.append((f"decode {i}", logits, r_logits, snap(cache), r_cache))
        r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        tok = logits.argmax(-1)
        out[-1] += (np.asarray(r_tok), tok.numpy())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_repro_f32(arch):
    for step in _run_both(arch, f32=True):
        what, logits, r_logits = step[:3]
        _close(logits, r_logits, F32_TOL, f"{arch} {what} logits")
        if what == "prefill" or what == f"decode {N_DECODE - 1}":
            cache, r_cache = step[3:5]
            assert set(cache) == set(r_cache)
            for group, leaves in cache.items():
                assert set(leaves) == set(r_cache[group])
                for name, t in leaves.items():
                    _close(t, r_cache[group][name], F32_TOL,
                           f"{arch} {what} cache {group}/{name}")
        if len(step) > 5:
            np.testing.assert_array_equal(step[6], step[5],
                                          err_msg=f"{arch} {what} tokens")


def _t(a):
    """A reference array (bf16 too) as a torch tensor with its dtype."""
    from repro_torch.nn.model import _tensor_from_numpy
    return _tensor_from_numpy(np.asarray(a))


def _blockwise_bf16(cfg, rcfg, ref_p, model, tokens, r_cache, max_seq):
    """The MoE configs in bf16, held block by block: every block (the
    leading dense layers, then the MoE layers) of the prefill and of
    N_DECODE decode steps runs the reference's own input and cache, its
    output (and its k/v, its aux loss) held to the reference block's.  Run
    end to end, bf16 rounding upstream (the reference's jnp attention
    rounds its scores to bf16, K4's plain version keeps them in float32)
    moves router probabilities that lie 0.002 apart across the top-k
    boundary, and a token takes other experts; on one input the routing is
    equal, or the block's output is off by far more than BF16_TOL."""
    from repro.nn import blocks as rb
    from repro.nn.layers import norm as r_norm
    from repro.nn.model import _dense_view as r_dense_view
    from repro.nn.model import _index_layer, _unembed
    from repro_torch.nn import blocks as pb
    from repro_torch.nn.layers import norm
    from repro_torch.nn.model import _dense_view

    stacks = [("layers", rcfg, cfg)]
    if cfg.first_dense_layers:
        stacks.insert(0, ("dense_layers", r_dense_view(rcfg),
                          _dense_view(cfg)))

    def logits_of(x, what):
        want = _unembed(ref_p, rcfg, r_norm(x, ref_p["final_norm"],
                                            rcfg.norm_type, rcfg.norm_eps))
        got = model.embed.T if cfg.tie_embeddings else model.lm_head
        got = norm(_t(x), model.final_norm, cfg.norm_type, cfg.norm_eps) \
            @ got
        _close(got, want, BF16_TOL, f"{cfg.name} {what} logits")
        return want[:, -1]

    B, S = tokens.shape
    x = jnp.take(ref_p["embed"], jnp.asarray(tokens), axis=0)
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    for name, rc, pc in stacks:
        for i, lp in enumerate(getattr(model, name)):
            want, r_aux, r_el = rb.block_forward(
                x, _index_layer(ref_p[name], i), rc, positions,
                collect_cache=True)
            got, aux, el = pb.block_forward(_t(x), lp, pc, _t(positions),
                                            collect_cache=True)
            what = f"{cfg.name} prefill {name} {i}"
            _close(got, want, BF16_TOL, what)
            np.testing.assert_allclose(float(aux), float(r_aux),
                                       rtol=BF16_TOL, atol=BF16_TOL,
                                       err_msg=what)
            for k in ("k", "v"):
                _close(el[k], r_el[k], BF16_TOL, f"{what} {k}")
            x = want
    r_logits = logits_of(x, "prefill")
    layer_caches = {name: [jax.tree.map(lambda a: a[i], r_cache[name])
                           for i in range(len(getattr(model, name)))]
                    for name, _, _ in stacks}
    for step in range(N_DECODE):
        pos = S + step
        tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        x = jnp.take(ref_p["embed"], tok[:, None], axis=0)
        for name, rc, pc in stacks:
            for i, lp in enumerate(getattr(model, name)):
                cl = layer_caches[name][i]
                want, layer_caches[name][i] = rb.block_decode(
                    x, _index_layer(ref_p[name], i), rc, cl, pos)
                got, _ = pb.block_decode(_t(x), lp, pc,
                                         {k: _t(v) for k, v in cl.items()},
                                         pos)
                _close(got, want, BF16_TOL,
                       f"{cfg.name} decode {step} {name} {i}")
                x = want
        r_logits = logits_of(x, f"decode {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_repro_bf16(arch):
    # greedy picks may split between near-tied logits in bf16, so both run
    # the reference's tokens: each step is held to the same input
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    ref_p = _ref_params(arch, f32=False)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                              device="cpu")
    inputs = model_inputs(cfg, 2, 32, seed=2)
    r_logits, r_cache = ref_nn.prefill(ref_p, rcfg, max_seq=48,
                                       **ref_inputs(inputs))
    if rcfg.first_dense_layers:
        r_cache = complete_dense_cache(ref_p, rcfg, inputs["tokens"],
                                       r_cache, 48)
    if cfg.is_moe:
        _blockwise_bf16(cfg, rcfg, ref_p, model, inputs["tokens"], r_cache,
                        48)
        return
    logits, cache = prefill(model, cfg, max_seq=48, device="cpu", **inputs)
    assert logits.dtype == torch.bfloat16
    _close(logits, r_logits, BF16_TOL, f"{arch} prefill logits")
    assert set(cache) == set(r_cache)
    for group, leaves in cache.items():
        for name, t in leaves.items():
            want = r_cache[group][name]
            assert str(t.dtype).split(".")[-1] == str(want.dtype)
            _close(t, want, BF16_TOL, f"{arch} cache {group}/{name}")
    for i in range(N_DECODE):
        r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        r_logits, r_cache = ref_nn.decode_step(ref_p, rcfg, r_cache, r_tok,
                                               32 + i)
        logits, cache = decode_step(model, cfg, cache, np.asarray(r_tok),
                                    32 + i, device="cpu")
        _close(logits, r_logits, BF16_TOL, f"{arch} decode {i} logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_last_position_equals_prefill(arch):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, seed=1, device="cpu").float()
    inputs = model_inputs(cfg, 2, 32, seed=3)
    full, aux = forward_logits(model, cfg, device="cpu", **inputs)
    last, cache = prefill(model, cfg, max_seq=40, device="cpu", **inputs)
    assert full.shape == (2, 32, cfg.vocab_size)
    # the MoE layers' load-balance loss: at least 1 a layer (E sum f P is
    # smallest for uniform routing), 0 without experts
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0
    assert float(aux) >= n_moe * (1 - 1e-5) and (n_moe or float(aux) == 0.0)
    torch.testing.assert_close(full[:, -1], last)
    if set(inputs) == {"tokens"}:
        torch.testing.assert_close(model(inputs["tokens"], device="cpu"),
                                   full)
    for group in cache.values():      # zero past the prompt: the padding
        for name in ("k", "v"):
            if name in group:
                assert not group[name][:, :, 32:].any()


def test_prefill_rejects_a_short_cache_and_a_model_elsewhere():
    cfg = configs.get_smoke_config("llama3.2-3b")
    model = init_params(cfg, device="cpu")
    tokens = np.zeros((1, 8), dtype=np.int64)
    with pytest.raises(ValueError, match="shorter than the prompt"):
        prefill(model, cfg, tokens, max_seq=4, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        prefill(model.to("meta"), cfg, tokens, device="cpu")


# -- the serving engine against repro.serve -------------------------------------
def _requests(cls, vocab, n=6, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(1, vocab,
                                             int(rng.integers(2, 8))).tolist(),
                max_new_tokens=max_new) for uid in range(n)]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama3.2-3b"])
def test_serve_engine_matches_repro(arch):
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    ref_p = _ref_params(arch, f32=True)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                              device="cpu", dtype=torch.float32)
    ref_eng = RefEngine(rcfg, ref_p, batch_slots=4, max_seq=64)
    eng = ServeEngine(cfg, model, batch_slots=4, max_seq=64, device="cpu")
    for e, cls in ((ref_eng, RefRequest), (eng, Request)):
        for r in _requests(cls, cfg.vocab_size):
            e.submit(r)
    want = ref_eng.run_until_done(max_ticks=200)
    got = eng.run_until_done(max_ticks=200)
    assert len(got) == 6 and all(r.done for r in got)
    assert [(r.uid, r.prompt, r.output) for r in got] == \
        [(r.uid, r.prompt, r.output) for r in want]
    assert all(len(r.output) == 8 for r in got)


@pytest.mark.parametrize("bad", [{"prompt": []}, {"max_new_tokens": 0},
                                 {"prompt": list(range(1, 17))}])
def test_serve_engine_submit_rejects_malformed_requests(bad):
    cfg = configs.get_smoke_config("mamba2-130m")
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), batch_slots=2,
                      max_seq=16, device="cpu")
    req = dict(uid=0, prompt=[1, 2], max_new_tokens=4)
    req.update(bad)
    with pytest.raises(ValueError):
        eng.submit(Request(**req))


def test_serve_engine_resets_a_reused_slot():
    cfg = configs.get_smoke_config("mamba2-130m")
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), batch_slots=1,
                      max_seq=16, device="cpu")
    for r in _requests(Request, cfg.vocab_size, n=2, max_new=3, seed=4):
        eng.submit(r)
    eng.step()
    assert eng.cache["layers"]["ssd"].abs().sum() > 0
    eng._reset_slot(0)
    assert not eng.cache["layers"]["ssd"].any()
    assert not eng.cache["layers"]["conv"].any()
    done = eng.run_until_done()
    assert [len(r.output) for r in done] == [3, 3]
