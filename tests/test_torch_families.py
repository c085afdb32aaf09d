"""The rest of the port's ``nn/`` against the JAX package: M-RoPE, whisper's
cross-attention and blocks, the int8 KV cache, decode after prefill where
the reference's own prefill leaves the cache short, and the serving engine
on the MoE and int8 configs.

Same weights on both sides (``params_from_numpy`` of the reference's
``init_params``), float32 unless named: rtol/atol 1e-4 on activations and
logits.  The int8 cache: values within 1 unit (a float32 rounding
difference can move a value across a rounding boundary), scales within
``SCALE_TOL``.

Two faults of the reference, mended in the port (ROADMAP §3):
``repro.nn.prefill`` leaves the leading dense layers' k/v out of the cache
(decode then raises ``KeyError: 'dense_layers'``), and under ``kv_quant``
returns float k/v with no scales (decode raises ``TypeError``).  Each test
shows the reference raising, then holds the port's decode after its own
prefill to ``repro.nn.decode_step`` on a cache completed by the
reference's own functions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import nn as ref_nn  # noqa: E402
from repro.nn import attention as ref_attn  # noqa: E402
from repro.nn import blocks as ref_blocks  # noqa: E402
from repro.nn import layers as ref_layers  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.nn import (cache_shapes, decode_step,  # noqa: E402
                            forward_logits, init_cache, params_from_numpy,
                            prefill)
from repro_torch.nn import attention, blocks, layers  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from test_torch_model import (complete_dense_cache, model_inputs,  # noqa: E402
                              ref_inputs)

TOL = 1e-4
BF16_TOL = 0.1
SCALE_TOL = 1e-6
N_DECODE = 8


def _cfgs(arch, **change):
    return (dataclasses.replace(configs.get_smoke_config(arch), **change),
            dataclasses.replace(ref_configs.get_smoke_config(arch), **change))


def _models(cfg, rcfg, f32=True):
    ref_p = ref_nn.init_params(rcfg, 0)
    if f32:
        ref_p = jax.tree.map(lambda a: a.astype(jnp.float32), ref_p)
    model = params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                              device="cpu",
                              dtype=torch.float32 if f32 else None)
    return ref_p, model


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    from repro_torch.nn.model import _tensor_from_numpy
    return _tensor_from_numpy(np.asarray(a))


def _quantize_np(a):
    """A numpy copy of the reference decode's quantisation
    (``repro/nn/attention.py:119-124``): a scale of max|a| / 127 over the
    head dim, at least 1e-8; values rounded half to even, clipped."""
    a = np.asarray(a, np.float32)
    s = np.maximum(np.abs(a).max(axis=-1) / np.float32(127.0),
                   np.float32(1e-8))
    q = np.clip(np.round(a / s[..., None]), -127, 127).astype(np.int8)
    return q, s


def _complete_quant_cache(r_cache, S):
    """The reference's prefill cache under kv_quant completed: its float
    k/v over the prompt quantised as its decode quantises, zero past the
    prompt (values and scales), as the port's prefill and ``init_cache``
    leave them."""
    layers = dict(r_cache["layers"])
    for name in ("k", "v"):
        full = np.asarray(layers[name], np.float32)
        q, s = _quantize_np(full[:, :, :S])
        qs = np.zeros(full.shape, np.int8)
        ss = np.zeros(full.shape[:-1], np.float32)
        qs[:, :, :S], ss[:, :, :S] = q, s
        layers[name], layers[f"{name}_scale"] = jnp.asarray(qs), \
            jnp.asarray(ss)
    return dict(r_cache, layers=layers)


def _int8_close(got, want, what):
    diff = np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, f"{what}: int8 entries off by {diff.max()}"


def _hold_cache(cache, r_cache, what):
    assert set(cache) == set(r_cache)
    for group, leaves in cache.items():
        assert set(leaves) == set(r_cache[group]), group
        for name, t in leaves.items():
            want = r_cache[group][name]
            if t.dtype == torch.int8:
                assert str(want.dtype) == "int8"
                _int8_close(t, want, f"{what} {group}/{name}")
            elif name.endswith("_scale"):
                np.testing.assert_allclose(t.numpy(), np.asarray(want),
                                           rtol=SCALE_TOL, atol=0,
                                           err_msg=f"{what} {name}")
            else:
                _close(t, want, TOL, f"{what} {group}/{name}")


def _decode_both(model, cfg, cache, ref_p, rcfg, r_cache, tok, start):
    """N_DECODE greedy steps on both sides from ``tok`` at ``start``: each
    step's logits within TOL and the same greedy token; returns the last
    caches."""
    r_tok = jnp.asarray(tok, jnp.int32)
    tok = torch.from_numpy(np.array(tok))
    for i in range(N_DECODE):
        r_logits, r_cache = ref_nn.decode_step(ref_p, rcfg, r_cache, r_tok,
                                               start + i)
        logits, cache = decode_step(model, cfg, cache, tok, start + i,
                                    device="cpu")
        _close(logits, r_logits, TOL, f"{cfg.name} decode {i}")
        r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        tok = logits.argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
    return cache, r_cache


# -- M-RoPE --------------------------------------------------------------------
@pytest.mark.parametrize("D", [16, 128])
def test_m_rope_matches_repro(D):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 24, 3, D)).astype(np.float32)
    # an image grid's ids: t, h and w differ token by token
    pos = np.stack([rng.integers(0, 50, (2, 24)), rng.integers(0, 9, (2, 24)),
                    rng.integers(0, 13, (2, 24))], axis=-1)
    want = ref_layers.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, want, TOL, f"m_rope D {D}")
    # text tokens (t, t, t): plain RoPE
    text = np.broadcast_to(pos[..., :1], pos.shape).copy()
    torch.testing.assert_close(
        layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(text), 1e6),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(text[..., 0]),
                          1e6))


def test_m_rope_sections_follow_the_2_1_1_split():
    # D 16: 8 slots -> floor(8 * [2, 1, 1] / 4) = [4, 2, 2]; D 20: 10 slots
    # -> [5, 2, 2], the remainder to t: [6, 2, 2]
    for d, want in ((16, [4, 2, 2]), (20, [6, 2, 2]), (128, [32, 16, 16])):
        slot = layers._m_rope_sections_on(d // 2, (2, 1, 1),
                                          torch.device("cpu"))
        assert np.bincount(slot.numpy()).tolist() == want


def test_forward_logits_takes_3d_positions_like_repro():
    cfg, rcfg = _cfgs("qwen2-vl-72b")
    ref_p, model = _models(cfg, rcfg)
    inputs = model_inputs(cfg, 2, 24, seed=4)
    rng = np.random.default_rng(4)
    pos = np.stack([np.repeat(np.arange(6), 4)[None].repeat(2, 0),
                    rng.integers(0, 4, (2, 24)), rng.integers(0, 4, (2, 24))],
                   axis=-1)
    want, r_aux = ref_nn.forward_logits(ref_p, rcfg,
                                        positions=jnp.asarray(pos),
                                        **ref_inputs(inputs))
    got, aux = forward_logits(model, cfg, positions=pos, device="cpu",
                              **inputs)
    _close(got, want, TOL, "qwen2-vl forward_logits, 3-D positions")
    # the (t, t, t) positions it takes by default are not these
    default, _ = forward_logits(model, cfg, device="cpu", **inputs)
    assert not torch.allclose(default, got)


# -- whisper's cross-attention and blocks -------------------------------------
def _whisper_layer(f32=True):
    cfg, rcfg = _cfgs("whisper-small")
    ref_p, model = _models(cfg, rcfg, f32)
    lp = jax.tree.map(lambda a: a[0], ref_p["layers"])
    rng = np.random.default_rng(9)
    dt = jnp.float32 if f32 else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((2, 12, cfg.d_model)), dt)
    enc = jnp.asarray(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)),
                      dt)
    return cfg, rcfg, ref_p, model, lp, x, enc


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_cross_attention_matches_repro(f32):
    cfg, rcfg, _, model, lp, x, enc = _whisper_layer(f32)
    want = ref_attn.cross_attention(x, lp["xattn"], rcfg, enc)
    got = attention.cross_attention(_t(x), model.layers[0]["xattn"], cfg,
                                    _t(enc))
    assert got.dtype == _t(x).dtype
    _close(got, want, TOL if f32 else BF16_TOL, "cross_attention")


def test_encoder_and_cross_blocks_match_repro():
    cfg, rcfg, ref_p, model, lp, x, enc = _whisper_layer()
    pos = jnp.broadcast_to(jnp.arange(12), (2, 12))
    elp = jax.tree.map(lambda a: a[1], ref_p["encoder"])
    want = ref_blocks.encoder_block(x, elp, rcfg, pos)
    got = blocks.encoder_block(_t(x), model.encoder[1], cfg, _t(pos))
    _close(got, want, TOL, "encoder_block")
    want, (rk, rv) = ref_blocks.cross_block(x, lp, rcfg, pos, enc)
    got, (k, v) = blocks.cross_block(_t(x), model.layers[0], cfg, _t(pos),
                                     _t(enc))
    _close(got, want, TOL, "cross_block")
    _close(k, rk, TOL, "cross_block k")
    _close(v, rv, TOL, "cross_block v")


def test_whisper_decode_keeps_enc_out():
    cfg, rcfg = _cfgs("whisper-small")
    _, model = _models(cfg, rcfg)
    inputs = model_inputs(cfg, 2, 16, seed=5)
    _, cache = prefill(model, cfg, max_seq=24, device="cpu", **inputs)
    enc = cache["layers"]["enc_out"].clone()
    assert enc.shape == (cfg.n_layers, 2, cfg.encoder_seq, cfg.d_model)
    decode_step(model, cfg, cache, np.array([1, 2]), 16, device="cpu")
    assert torch.equal(cache["layers"]["enc_out"], enc)


# -- the int8 KV cache ---------------------------------------------------------
def test_quantize_kv_matches_the_references_formula():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    a[0, 0, 0] = 0.0                          # an all-zero row: scale 1e-8
    a[1, 2, 1, :4] = [127.5, -127.5, 0.5, 1.5]  # halves round to even
    q, s = attention.quantize_kv(torch.from_numpy(a))
    wq, ws = _quantize_np(a)
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(s.numpy(), ws)
    assert q.dtype == torch.int8 and float(s[0, 0, 0]) == np.float32(1e-8)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "tinyllama-1.1b"])
def test_kv_quant_decode_from_init_cache_matches_repro(arch):
    cfg, rcfg = _cfgs(arch, kv_quant=True)
    ref_p, model = _models(cfg, rcfg)
    assert cache_shapes(cfg, 2, 24) == ref_nn.cache_shapes(rcfg, 2, 24)
    r_cache = ref_nn.init_cache(rcfg, 2, 24)
    cache = init_cache(cfg, 2, 24, device="cpu")
    assert cache["layers"]["k"].dtype == torch.int8
    assert cache["layers"]["k_scale"].dtype == torch.float32
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    for i in range(12):                        # the prompt, token by token
        r_logits, r_cache = ref_nn.decode_step(ref_p, rcfg, r_cache,
                                               jnp.asarray(tokens[:, i]), i)
        logits, cache = decode_step(model, cfg, cache, tokens[:, i], i,
                                    device="cpu")
        _close(logits, r_logits, TOL, f"{arch} kv_quant step {i}")
    _hold_cache(cache, r_cache, f"{arch} kv_quant")
    cache, r_cache = _decode_both(model, cfg, cache, ref_p, rcfg, r_cache,
                                  np.asarray(jnp.argmax(r_logits, -1)), 12)
    _hold_cache(cache, r_cache, f"{arch} kv_quant after decode")


def test_kv_quant_cache_is_half_the_bf16_cache():
    cfg, _ = _cfgs("llama3.2-3b", kv_quant=True)
    q = init_cache(cfg, 2, 64, device="cpu")["layers"]
    b = init_cache(dataclasses.replace(cfg, kv_quant=False), 2, 64,
                   device="cpu")["layers"]

    def nbytes(c, names):
        return sum(c[n].numel() * c[n].element_size() for n in names)

    assert 2 * nbytes(q, ("k", "v")) == nbytes(b, ("k", "v"))
    # the float32 scales add 4 bytes a (position, kv head) to 1 a value
    assert nbytes(q, q) / nbytes(b, b) == pytest.approx(
        0.5 + 4 / (2 * cfg.head_dim))


# -- decode after prefill: the two faults of the reference, mended -------------
def test_decode_after_prefill_with_leading_dense_layers():
    cfg, rcfg = _cfgs("deepseek-moe-16b")
    ref_p, model = _models(cfg, rcfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    r_logits, r_cache = ref_nn.prefill(ref_p, rcfg, tokens=jnp.asarray(tokens),
                                       max_seq=32)
    assert "dense_layers" not in r_cache
    tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
    with pytest.raises(KeyError, match="dense_layers"):
        ref_nn.decode_step(ref_p, rcfg, r_cache, tok, 16)
    logits, cache = prefill(model, cfg, tokens, max_seq=32, device="cpu")
    _close(logits, r_logits, TOL, "deepseek prefill")
    r_cache = complete_dense_cache(ref_p, rcfg, tokens, r_cache, 32)
    _hold_cache(cache, r_cache, "deepseek prefill")
    assert set(cache["dense_layers"]) == {"k", "v"}
    assert cache["dense_layers"]["k"].shape == \
        ref_nn.cache_shapes(rcfg, 2, 32)["dense_layers"]["k"]
    cache, r_cache = _decode_both(model, cfg, cache, ref_p, rcfg, r_cache,
                                  np.asarray(tok), 16)
    _hold_cache(cache, r_cache, "deepseek decode")


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_after_prefill_with_the_int8_cache(f32):
    cfg, rcfg = _cfgs("llama3.2-3b", kv_quant=True)
    ref_p, model = _models(cfg, rcfg, f32)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16))
    r_logits, r_cache = ref_nn.prefill(ref_p, rcfg, tokens=jnp.asarray(tokens),
                                       max_seq=32)
    assert "k_scale" not in r_cache["layers"]
    tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
    with pytest.raises(TypeError, match="same dtypes"):
        ref_nn.decode_step(ref_p, rcfg, r_cache, tok, 16)
    logits, cache = prefill(model, cfg, tokens, max_seq=32, device="cpu")
    assert cache["layers"]["k"].dtype == torch.int8
    assert set(cache["layers"]) == {"k", "v", "k_scale", "v_scale"}
    for name, t in init_cache(cfg, 2, 32, device="cpu")["layers"].items():
        assert t.shape == cache["layers"][name].shape
        assert t.dtype == cache["layers"][name].dtype
    r_cache = _complete_quant_cache(r_cache, 16)
    if not f32:
        # bf16 k/v rounded differently upstream can cross a rounding
        # boundary of the quantisation: hold the whole cache at bf16's bound
        _close(logits, r_logits, BF16_TOL, "kv_quant prefill bf16")
        for name in ("k", "v"):
            deq = cache["layers"][name].float() \
                * cache["layers"][f"{name}_scale"][..., None]
            want = np.asarray(r_cache["layers"][name], np.float32) \
                * np.asarray(r_cache["layers"][f"{name}_scale"])[..., None]
            _close(deq, want, BF16_TOL, f"kv_quant prefill bf16 {name}")
        return
    _close(logits, r_logits, TOL, "kv_quant prefill")
    _hold_cache(cache, r_cache, "kv_quant prefill")
    cache, r_cache = _decode_both(model, cfg, cache, ref_p, rcfg, r_cache,
                                  np.asarray(tok), 16)
    _hold_cache(cache, r_cache, "kv_quant decode")


def test_kv_quant_decode_tracks_the_full_precision_forward():
    # the reference's own bound (tests/test_nn_models.py): decode on the
    # int8 cache within 0.08 of the full forward, relative to its max
    cfg, rcfg = _cfgs("tinyllama-1.1b", kv_quant=True)
    _, model = _models(cfg, rcfg, f32=False)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8))
    full, _ = forward_logits(model, dataclasses.replace(cfg, kv_quant=False),
                             tokens, device="cpu")
    cache = init_cache(cfg, 1, 8, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = decode_step(model, cfg, cache, tokens[:, i], i,
                                device="cpu")
        outs.append(lg)
    dec = torch.stack(outs, 1).float()
    rel = float((dec - full.float()).abs().max() / full.float().abs().max())
    assert rel < 0.08, rel


# -- the serving engine ---------------------------------------------------------
def _requests(cls, vocab, n=6, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(1, vocab,
                                             int(rng.integers(2, 8))).tolist(),
                max_new_tokens=max_new) for uid in range(n)]


@pytest.mark.parametrize("arch,change", [("deepseek-moe-16b", {}),
                                         ("llama3.2-3b", {"kv_quant": True})])
def test_serve_engine_matches_repro(arch, change):
    cfg, rcfg = _cfgs(arch, **change)
    ref_p, model = _models(cfg, rcfg)
    ref_eng = RefEngine(rcfg, ref_p, batch_slots=4, max_seq=64)
    eng = ServeEngine(cfg, model, batch_slots=4, max_seq=64, device="cpu")
    assert set(eng.cache) == set(ref_eng.cache)
    for e, cls in ((ref_eng, RefRequest), (eng, Request)):
        for r in _requests(cls, cfg.vocab_size):
            e.submit(r)
    want = ref_eng.run_until_done(max_ticks=200)
    got = eng.run_until_done(max_ticks=200)
    assert len(got) == 6 and all(r.done for r in got)
    assert [(r.uid, r.prompt, r.output) for r in got] == \
        [(r.uid, r.prompt, r.output) for r in want]


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b",
                                  "whisper-small", "qwen2-vl-72b"])
def test_prefill_launches_k4_per_self_attention_on_cuda(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rcfg = _cfgs(arch)
    ref_p, model = _models(cfg, rcfg)
    gpu = params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                            device="cuda", dtype=torch.float32)
    inputs = model_inputs(cfg, 2, 32, seed=1)
    fa.reset_launches()
    got, g_cache = prefill(gpu, cfg, max_seq=40, **inputs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers + cfg.encoder_layers
    want, c_cache = prefill(model, cfg, max_seq=40, device="cpu", **inputs)
    _close(got, want.numpy(), TOL, f"{arch} prefill on cuda")
    before = dict(fa.LAUNCHES)
    decode_step(gpu, cfg, g_cache, got.argmax(-1), 32)
    assert fa.LAUNCHES == before               # decode launches no K4
