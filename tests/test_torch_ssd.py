"""K5 (the SSD intra-chunk step) and the Mamba2 mixer of the PyTorch port
against the JAX package.

On the CPU the K5 wrapper takes its plain PyTorch version; it is held to the
Pallas kernel in interpret mode and to ``ssd_intra_chunk_ref`` at rtol/atol
2e-4, the reference's own kernel bound.  ``ssd_chunked``, ``ssm_mixer``
and ``ssm_decode`` are held to ``repro.nn.ssm`` at 3e-4, the bound the
reference holds its kernel to its chunked model.  K5's own arithmetic (every
product as three TF32 products) is emulated in torch and held to float64 at
the same 2e-4.  The CUDA kernel itself is held to the plain version by the
``gpu`` test, which skips without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.comm.health import get_health  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.ssd import ssd_intra_chunk as ref_ssd  # noqa: E402
from repro.nn import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402

KERNEL_TOL = 2e-4
MIXER_TOL = 3e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _chunk_inputs(seed, G, q, n, p):
    rng = np.random.default_rng(seed)
    dtx = rng.standard_normal((G, q, p)).astype(np.float32)
    Bm = rng.standard_normal((G, q, n)).astype(np.float32)
    Cm = rng.standard_normal((G, q, n)).astype(np.float32)
    # a realistic decaying cumA (negative, decreasing)
    cumA = np.cumsum(-rng.uniform(0.001, 0.1, (G, q, 1)), axis=1)
    return dtx, Bm, Cm, cumA.astype(np.float32)


# -- K5's plain version against the Pallas kernel and the oracle ----------------
@pytest.mark.parametrize("q,n,p", [(16, 8, 16), (32, 8, 8), (64, 32, 16),
                                   (128, 16, 64)])
def test_ssd_plain_matches_pallas_and_ref(q, n, p):
    inputs = _chunk_inputs(q + n + p, 6, q, n, p)
    want = ref_ssd(*(jnp.asarray(a) for a in inputs), interpret=True)
    assert get_health().n_events == 0
    oracle = ref_oracles.ssd_intra_chunk_ref(*(jnp.asarray(a)
                                               for a in inputs))
    got = ssd.ssd_intra_chunk(*(_t(a) for a in inputs))
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


def test_ssd_strided_views_equal_materialised_inputs():
    # B and C of a (batch, chunk) expanded over its heads with stride 0,
    # dtx and cumA transposed: the form ssd_chunked passes
    G1, h, q, n, p = 3, 4, 16, 8, 16
    rng = np.random.default_rng(5)
    dtx = _t(rng.standard_normal((G1, q, h, p))).permute(0, 2, 1, 3)
    Bm = _t(rng.standard_normal((G1, 1, q, n))).expand(G1, h, q, n)
    Cm = _t(rng.standard_normal((G1, 1, q, n))).expand(G1, h, q, n)
    cumA = _t(np.cumsum(-rng.uniform(0.001, 0.1, (G1, q, h)), axis=1)
              ).permute(0, 2, 1)[..., None]
    y, s = ops.ssd_intra_chunk(dtx, Bm, Cm, cumA)
    flat = [t.reshape(G1 * h, q, -1).contiguous()
            for t in (dtx, Bm, Cm, cumA)]
    y3, s3 = ops.ssd_intra_chunk(*flat)
    torch.testing.assert_close(y, y3, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s, s3, rtol=1e-6, atol=1e-6)
    y_ref, s_ref = ref_oracles.ssd_intra_chunk_ref(
        *(jnp.asarray(t.numpy()) for t in flat))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


def test_ssd_plain_does_not_count_launches():
    before = ssd.LAUNCHES["ssd_intra_chunk"]
    ssd.ssd_intra_chunk(*(_t(a) for a in _chunk_inputs(0, 2, 8, 4, 4)))
    assert ssd.LAUNCHES["ssd_intra_chunk"] == before


@pytest.mark.parametrize("bad", ["dtype", "q_mismatch", "cumA_shape",
                                 "smem", "size", "rank", "meta"])
def test_ssd_rejects_what_the_kernel_does_not_take(bad):
    dtx, Bm, Cm, cumA = (_t(a) for a in _chunk_inputs(0, 2, 16, 8, 16))
    if bad == "dtype":
        Bm = Bm.bfloat16()
    elif bad == "q_mismatch":
        Cm = Cm[:, :8]
    elif bad == "cumA_shape":
        cumA = cumA[..., 0]
    elif bad == "smem":           # 234,496 bytes a block (smem_bytes)
        dtx, Bm, Cm, cumA = (_t(a) for a in
                             _chunk_inputs(0, 1, 128, 128, 128))
    elif bad == "size":           # n past 128
        dtx, Bm, Cm, cumA = (_t(a) for a in
                             _chunk_inputs(0, 1, 128, 256, 128))
    elif bad == "rank":
        dtx = dtx[0]
    else:
        # meta inputs are the dry run's shape-only path (tested in
        # test_torch_parallel.py); dtx on meta beside the rest on the host
        # is refused
        dtx = dtx.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA)


# -- the kernel's arithmetic: three TF32 products per float32 product ----------
def _tf32(x):
    """x with its low 13 mantissa bits cleared: a TF32 value, as K5 forms
    it (and as the tensor cores read a float32 register)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_split(a, b, passes=3):
    """a @ b as K5's tensor cores form it: a = hi + lo, both TF32, and lo b_hi
    + hi b_lo + hi b_hi summed in float32 (products of TF32 values are exact
    in float32); ``passes=1`` is one TF32 product, hi b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _tc_emulation(dtx, Bm, Cm, cum, passes=3):
    """K5's arithmetic on [G, q, x] float32 tensors (cum [G, q]): C B^T, the
    decayed and masked scores, y and S_c, each product split."""
    q = dtx.shape[1]
    keep = torch.ones(q, q, dtype=torch.bool).tril()
    decay = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
        ~keep, -float("inf")))
    scores = _mm_split(Cm, Bm.transpose(1, 2), passes) * decay
    seg = torch.exp(cum[:, -1:] - cum)
    return (_mm_split(scores, dtx, passes),
            _mm_split((Bm * seg[..., None]).transpose(1, 2), dtx, passes))


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("dt", ["mamba2", "init"])
def test_tensor_core_arithmetic_within_the_float32_bound(n, dt):
    """K5's split-TF32 products at hymba-1.5b's chunk shape (q 128, n 16,
    p 64) and mamba2-130m's (n 128), a decay per step of -A dt with A from 1
    to 16 over the heads and dt from Mamba2's range (0.001-0.1) or from
    this port's initial weights (softplus of N(0, 1); cumA then reaches
    about -1700), stay within KERNEL_TOL of the float64 result on the same
    float32 inputs: measured at up to 0.17 of the bound, about what float32
    sums alone give.  One TF32 pass (hi b_hi) lands 37 to 147 times past the
    bound at these shapes (y off by 0.10-0.27, S_c by ~0.01), which is why
    K5 takes three."""
    rng = np.random.default_rng(n)
    G, q, p = 4, 128, 64
    A = np.linspace(1.0, 16.0, G)[:, None]
    step = (rng.uniform(0.001, 0.1, (G, q)) if dt == "mamba2"
            else np.log1p(np.exp(rng.standard_normal((G, q)))))
    inputs = [a.astype(np.float32) for a in (
        rng.standard_normal((G, q, p)), rng.standard_normal((G, q, n)),
        rng.standard_normal((G, q, n)), np.cumsum(-A * step, axis=1))]
    dtx, Bm, Cm, cum = (a.astype(np.float64) for a in inputs)
    keep = np.tril(np.ones((q, q), bool))
    scores = (Cm @ Bm.transpose(0, 2, 1)) * np.exp(
        np.where(keep, cum[:, :, None] - cum[:, None, :], -np.inf))
    seg = np.exp(cum[:, -1:] - cum)
    want = (scores @ dtx, (Bm * seg[..., None]).transpose(0, 2, 1) @ dtx)
    got = _tc_emulation(*(torch.from_numpy(a) for a in inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


# -- the mixer against repro.nn.ssm --------------------------------------------
def _scan_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.standard_normal((b, l, n)).astype(np.float32),
            rng.uniform(0.01, 0.3, (b, l, h)).astype(np.float32),
            rng.uniform(-1, 0.5, (h,)).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32))


@pytest.mark.parametrize("l,chunk", [(64, 16), (64, 32), (24, 32)])
def test_ssd_chunked_matches_repro(l, chunk):
    args = _scan_inputs(l + chunk, 2, l, 3, 16, 8)
    want_y, want_s = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in args),
                                         chunk, return_final_state=True)
    got_y, got_s = ssm.ssd_chunked(*(_t(a) for a in args), chunk,
                                   return_final_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=MIXER_TOL, atol=MIXER_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=MIXER_TOL, atol=MIXER_TOL)
    y_only = ssm.ssd_chunked(*(_t(a) for a in args), chunk)
    torch.testing.assert_close(y_only, got_y)


def test_ssd_chunked_rejects_a_ragged_sequence():
    args = _scan_inputs(0, 1, 40, 2, 8, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.ssd_chunked(*(_t(a) for a in args), 16)


def _ssm_params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, sh in ssm.ssm_param_shapes(cfg).items():
        if name == "A_log":
            out[name] = np.log(np.linspace(1.0, 16.0, sh[0]))
        elif name in ("D", "norm"):
            out[name] = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            out[name] = 0.1 * rng.standard_normal(sh)
        else:
            out[name] = rng.standard_normal(sh) / np.sqrt(sh[0])
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_ssm_mixer_matches_repro(arch):
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    p = _ssm_params(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 2 * cfg.ssm_chunk, cfg.d_model)).astype(np.float32)
    want, (wc, ws) = ref_ssm.ssm_mixer(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg,
        return_state=True)
    got, (gc, gs) = ssm.ssm_mixer(_t(x), {k: _t(v) for k, v in p.items()},
                                  cfg, return_state=True)
    for g, w in ((got, want), (gc, wc), (gs, ws)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MIXER_TOL,
                                   atol=MIXER_TOL)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_ssm_decode_matches_repro(arch):
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    p = _ssm_params(cfg, 3)
    rng = np.random.default_rng(4)
    shapes = ssm.ssm_decode_state_shapes(cfg, 2)
    conv = rng.standard_normal(shapes["conv"]).astype(np.float32)
    state = rng.standard_normal(shapes["ssd"]).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    want_c, want_s, got_c, got_s = (jnp.asarray(conv), jnp.asarray(state),
                                    _t(conv), _t(state))
    for step in range(3):                  # a few steps, states carried
        want, want_c, want_s = ref_ssm.ssm_decode(jnp.asarray(x), jp, rcfg,
                                                  want_c, want_s)
        got, got_c, got_s = ssm.ssm_decode(_t(x), tp, cfg, got_c, got_s)
        for g, w in ((got, want), (got_c, want_c), (got_s, want_s)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=MIXER_TOL, atol=MIXER_TOL)
        x = x[::-1].copy()


# -- the CUDA kernel -----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ssd_matches_plain_version(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    before = ssd.LAUNCHES["ssd_intra_chunk"]
    before_tc = ssd.LAUNCHES["ssd_intra_chunk_tc"]
    n_calls = 0
    for q in (1, 16, 24, 64, 100, 128):
        for n in (8, 16, 128):
            for p in (16, 64):
                G1, h = 3, 5
                dtx, Bm, Cm, cumA = (_t(a).to(cuda) for a in
                                     _chunk_inputs(q + n + p, G1, q, n, p))
                args = (dtx[:, None].expand(G1, h, q, p).contiguous(),
                        Bm[:, None].expand(G1, h, q, n),
                        Cm[:, None].expand(G1, h, q, n),
                        cumA[:, None].expand(G1, h, q, 1))
                got = ssd.ssd_intra_chunk(*args)
                want = ssd.ssd_intra_chunk_plain(*args)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=KERNEL_TOL,
                                               atol=KERNEL_TOL)
                n_calls += 1
    # dtx copied four bytes at a time: p 18, and columns q apart
    for q, n, p, strided in ((100, 16, 18, False), (128, 16, 64, True)):
        dtx, Bm, Cm, cumA = (_t(a).to(cuda) for a in
                             _chunk_inputs(q + p, 6, q, n, p))
        if strided:
            dtx = dtx.mT.contiguous().mT
        for g, w in zip(ssd.ssd_intra_chunk(dtx, Bm, Cm, cumA),
                        ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cumA)):
            torch.testing.assert_close(g, w, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        n_calls += 1
    assert ssd.LAUNCHES["ssd_intra_chunk"] == before + n_calls
    assert ssd.LAUNCHES["ssd_intra_chunk_tc"] == before_tc + n_calls
