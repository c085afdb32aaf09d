"""K4 (flash attention) and the attention layers of the PyTorch port against
the JAX package.

On the CPU the K4 wrapper takes its plain PyTorch version; it is held to the
Pallas kernel run in interpret mode and to ``flash_attention_ref`` on the
same seeded inputs: rtol/atol 2e-5 in float32 (the reference's own kernel
bound) and 1e-2 in bfloat16 (the two round the float32 result to bf16 at
different sums).  K4's bfloat16 kernel runs on the tensor cores and rounds
the softmax weights to bf16 before ``P V``; an emulation of that arithmetic
in torch justifies the bound the card is held to.  The port's ``attention`` and ``decode_attention`` are held
to ``repro.nn.attention`` on float32 parameters at rtol/atol 1e-4.  The CUDA
kernel itself is held to the plain version by the ``gpu`` test, which skips
without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.comm.health import get_health  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as ref_flash  # noqa: E402
from repro.nn import attention as ref_attn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 1e-2
LAYER_TOL = 1e-4
# K4's bfloat16 kernel against the plain version: one bf16 ulp of the
# output (2^-7 relative covers two roundings) plus rounding p to bf16, at
# most 2^-9 max_j |v_j| on a row; 2^-8 leaves a factor 2 (chip_smoke.py's
# k4_err holds the card to K4_TOL + this)
BF16_P_TOL = 2.0 ** -8
BF16_OUT_TOL = F32_TOL + 2.0 ** -7


def _qkv(seed, B, S, H, KH, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# -- K4's plain version against the Pallas kernel and the oracle ----------------
@pytest.mark.parametrize("S,H,KH,D", [
    (128, 4, 4, 16),     # MHA
    (128, 4, 2, 32),     # GQA 2x
    (128, 5, 1, 64),     # MQA, odd head count
    (64, 2, 2, 128),     # the largest head dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref_f32(S, H, KH, D, causal):
    q, k, v = _qkv(S + H + D, 2, S, H, KH, D)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64, interpret=True))
    assert get_health().n_events == 0
    oracle = np.asarray(ref_oracles.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref_bf16(causal):
    q, k, v = _qkv(7, 1, 128, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_flash(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True), np.float32)
    assert get_health().n_events == 0
    oracle = np.asarray(ref_oracles.flash_attention_ref(jq, jk, jv,
                                                        causal=causal),
                        np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32), torch.bfloat16)
                  for a in (jq, jk, jv))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), oracle, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("S", [1, 7, 200])
def test_flash_plain_takes_any_sequence_length(S):
    # the Pallas kernel needs S to be a multiple of its blocks; the oracle
    # and K4 do not
    q, k, v = _qkv(S, 2, S, 4, 2, 16)
    oracle = np.asarray(ref_oracles.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = ops.mha_flash(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_plain_does_not_count_launches():
    q, k, v = (_t(a) for a in _qkv(0, 1, 16, 2, 1, 16))
    before = fa.LAUNCHES["flash_attention"]
    fa.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("bad", ["head_dim", "groups", "dtype_mix",
                                 "strided", "kv_shape", "rank", "meta"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (_t(a) for a in _qkv(0, 1, 16, 4, 2, 16))
    if bad == "head_dim":
        q, k, v = (_t(a) for a in _qkv(0, 1, 16, 4, 2, 24))
    elif bad == "groups":
        q = q[:, :, :3].contiguous()
    elif bad == "dtype_mix":
        k = k.bfloat16()
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "kv_shape":
        v = v[:, :8].contiguous()
    elif bad == "rank":
        q = q[0]
    else:
        # meta inputs are the dry run's shape-only path (tested in
        # test_torch_parallel.py); q on meta beside k and v on the host is
        # refused
        q = q.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ops.mha_flash(q, k, v)


# -- K4's tensor-core arithmetic, emulated ----------------------------------
def _tc_emulation(q, k, v, causal, tile=64):
    """K4's bfloat16 kernel's arithmetic: float32 scores of bf16 q and k,
    an online softmax over tiles of 64 keys, ``l`` summed from the float32
    ``p`` and ``p`` rounded to bf16 before ``P V``; bf16 output."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = q.float().reshape(B, S, KH, H // KH, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) / D ** 0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~mask, fa.NEG_INF)
    m = torch.full(s.shape[:-1], fa.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], D)
    for k0 in range(0, S, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrqk,bkhd->bhrqd", p.bfloat16().float(),
            v[:, k0:k0 + tile].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).bfloat16()


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S", [63, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 5])
def test_tensor_core_arithmetic_within_the_bf16_bound(D, S, causal, rep):
    q, k, v = (_t(a, torch.bfloat16)
               for a in _qkv(D + S + rep, 2, S, 2 * rep, 2, D))
    got = _tc_emulation(q, k, v, causal).float()
    want = fa.flash_attention_plain(q, k, v, causal).float()
    vmax = v.float().abs().amax(dim=(1, 3)).repeat_interleave(rep, 1)
    bound = BF16_OUT_TOL * want.abs() + BF16_P_TOL * vmax[:, None, :, None]
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())
    # the rounding of p is visible: the emulation is not the plain version
    assert bool((err > 0).any())


# -- which kernel K4 launches -------------------------------------------------
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "tc"),
                                         (torch.float32, "fma")])
def test_route_by_dtype(D, dtype, entry):
    assert fa._entry_for(dtype, D) == entry


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float16, 64, TypeError), (torch.bfloat16, 24, ValueError),
    (torch.float32, 256, ValueError)])
def test_route_refuses_what_no_kernel_takes(dtype, D, err):
    with pytest.raises(err):
        fa._entry_for(dtype, D)


# -- the attention layers against repro.nn.attention ---------------------------
def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
            for n, sh in shapes.items()}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama3.2-3b"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_repro(arch, causal):
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    p = _attn_params(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    want, (wk, wv) = ref_attn.attention(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, rcfg,
        jnp.asarray(pos), causal=causal)
    got, (gk, gv) = attn.attention(_t(x), {n: _t(a) for n, a in p.items()},
                                   cfg, torch.from_numpy(pos.copy()),
                                   causal=causal)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_repro(cache_dtype):
    cfg, rcfg = get_smoke_config("hymba-1.5b"), ref_smoke("hymba-1.5b")
    p = _attn_params(cfg, 3)
    rng = np.random.default_rng(4)
    B, S_max, pos = 2, 24, 9
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, S_max, cfg.n_kv_heads, cfg.head_dim))
    cv = rng.standard_normal((B, S_max, cfg.n_kv_heads, cfg.head_dim))
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    jck, jcv = jnp.asarray(ck, jdt), jnp.asarray(cv, jdt)
    want, wk, wv = ref_attn.decode_attention(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, rcfg,
        jck, jcv, pos)
    tck = _t(np.asarray(jck, np.float32), cache_dtype)
    tcv = _t(np.asarray(jcv, np.float32), cache_dtype)
    got, gk, gv = attn.decode_attention(
        _t(x), {n: _t(a) for n, a in p.items()}, cfg, tck, tcv, pos)
    assert gk is tck and gv is tcv          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(gk.float().numpy(),
                               np.asarray(wk, np.float32), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(gv.float().numpy(),
                               np.asarray(wv, np.float32), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("change", [{"kv_quant": True}, {"m_rope": True},
                                    {"kv_quant": True, "m_rope": True}])
def test_decode_attention_on_the_int8_cache_and_m_rope_matches_repro(change):
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen2-vl-72b"), **change)
    rcfg = dataclasses.replace(ref_smoke("qwen2-vl-72b"), **change)
    p = _attn_params(cfg, 5)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    rng = np.random.default_rng(5)
    B, S_max, pos = 2, 20, 7
    KH, D = cfg.n_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, B, S_max, KH, D)).astype(np.float32)
    if cfg.kv_quant:
        scales = (np.abs(kv).max(-1) / 127).astype(np.float32)
        kv = np.clip(np.round(kv / scales[..., None]), -127, 127)
        jc = [jnp.asarray(a, jnp.int8) for a in kv] \
            + [jnp.asarray(a) for a in scales]
        tc = [torch.from_numpy(a.astype(np.int8)) for a in kv] \
            + [torch.from_numpy(a) for a in scales]
    else:
        jc = [jnp.asarray(a) for a in kv]
        tc = [_t(a) for a in kv]
    want = ref_attn.decode_attention(jnp.asarray(x), jp, rcfg, *jc[:2], pos,
                                     *jc[2:])
    got = attn.decode_attention(_t(x), {n: _t(a) for n, a in p.items()}, cfg,
                                *tc[:2], pos, *tc[2:])
    assert len(got) == len(want) == 3 + 2 * cfg.kv_quant
    assert all(g is t for g, t in zip(got[1:], tc))    # written in place
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    for g, w in zip(got[1:], want[1:]):
        if g.dtype == torch.int8:
            diff = g.numpy().astype(int) - np.asarray(w).astype(int)
            assert np.abs(diff).max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=LAYER_TOL, atol=1e-6)


def test_m_rope_attention_matches_repro():
    cfg, rcfg = get_smoke_config("qwen2-vl-72b"), ref_smoke("qwen2-vl-72b")
    p = _attn_params(cfg, 6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 30, (2, 20, 3))
    want, (wk, wv) = ref_attn.attention(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, rcfg,
        jnp.asarray(pos))
    got, (gk, gv) = attn.attention(_t(x), {n: _t(a) for n, a in p.items()},
                                   cfg, torch.from_numpy(pos))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)


# -- the CUDA kernel -----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_flash_matches_plain_version(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    before = dict(fa.LAUNCHES)
    n = n_bf16 = 0
    for S in (63, 200, 2048):
        for D in fa.HEAD_DIMS:
            for rep in (1, 5):
                for causal in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v = (_t(a, dtype).to(cuda) for a in
                                   _qkv(D + rep + S, 2, S, 2 * rep, 2, D))
                        got = fa.flash_attention(q, k, v, causal)
                        want = fa.flash_attention_plain(q, k, v, causal)
                        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                        torch.testing.assert_close(got.float(), want.float(),
                                                   rtol=tol, atol=tol)
                        n += 1
                        n_bf16 += dtype == torch.bfloat16
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + n
    assert fa.LAUNCHES["flash_attention_tc"] == \
        before["flash_attention_tc"] + n_bf16
