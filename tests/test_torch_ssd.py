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
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels import ssm_mixer as fused  # noqa: E402
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


# -- the mixer's prologue and epilogue: the plain versions --------------------
def _mixer_inputs(cfg, seed, b=2, chunks=2, dtype=torch.float32):
    p = {k: _t(v) for k, v in _ssm_params(cfg, seed).items()}
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, chunks * cfg.ssm_chunk, cfg.d_model)).astype(np.float32))
    if dtype != torch.float32:
        p = {k: v.to(dtype) if k in ("in_proj", "out_proj", "conv_w",
                                      "conv_b") else v
             for k, v in p.items()}
        x = x.to(dtype)
    return x, p


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-4.0-h-small"])
def test_fused_path_pieces_give_the_mixer(arch, return_state):
    # the fused path's steps on their plain versions: prologue_plain, K5's
    # plain version and the recurrence (ssm._scan), epilogue_plain; the
    # same float32 ops as the mixer's plain path, in layouts of their own
    cfg = get_smoke_config(arch)
    x, p = _mixer_inputs(cfg, 5)
    want = ssm.ssm_mixer(x, p, cfg, return_state=return_state)
    zxbcdt = x @ p["in_proj"]
    b, l, di, h, q, n = (x.shape[0], x.shape[1], cfg.ssm_d_inner,
                         cfg.ssm_heads, cfg.ssm_chunk, cfg.ssm_state)
    dtx, Bm, Cm, cumA, xs = fused.prologue_plain(
        zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:],
        p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], n, q)
    assert dtx.shape == (b * l // q, h, q, di // h)
    assert Bm.shape == Cm.shape == (b * l // q, q, cfg.ssm_state)
    assert cumA.shape == (b * l // q, h, q, 1) and xs.shape == (b, l, di)
    y_intra, CS, s = ssm._scan(dtx, Bm, Cm, cumA, b)
    y = fused.epilogue_plain(y_intra, CS, cumA, xs, zxbcdt[..., :di],
                             p["D"], p["norm"], cfg.norm_eps)
    got = y @ p["out_proj"]
    if return_state:
        want, (want_conv, want_s) = want
        K = cfg.ssm_conv_kernel
        torch.testing.assert_close(s, want_s, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            zxbcdt[:, -(K - 1):, di:2 * di + 2 * cfg.ssm_state], want_conv)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-4.0-h-small"])
def test_fused_path_on_cpu_tensors_equals_the_plain_path(arch, return_state):
    # bf16 CPU tensors: the wrappers take their plain versions, whose ops
    # are the plain path's, so the fused path's output is the same bits
    cfg = get_smoke_config(arch)
    x, p = _mixer_inputs(cfg, 7, dtype=torch.bfloat16)
    with torch.no_grad():
        want = ssm.ssm_mixer(x, p, cfg, return_state=return_state)
        y, s = ssm._mixer_fused(x @ p["in_proj"], p, cfg)
    assert y.dtype == torch.bfloat16
    if return_state:
        want, (_, want_s) = want
        assert torch.equal(s, want_s)
    assert torch.equal(y @ p["out_proj"], want)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-4.0-h-small"])
def test_fused_path_gradients_are_the_plain_paths(arch):
    # under autograd the prologue's and epilogue's backward run their plain
    # versions again on the saved inputs: on CPU tensors (whose forward is
    # the plain version too) every gradient is the plain path's
    cfg = get_smoke_config(arch)
    x, p = _mixer_inputs(cfg, 13)
    dy = torch.from_numpy(np.random.default_rng(14).standard_normal(
        x.shape).astype(np.float32))
    grads = []
    for path in ("plain", "fused"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xa = x.clone().requires_grad_(True)
        if path == "plain":
            out = ssm.ssm_mixer(xa, leaves, cfg)
        else:
            y, _ = ssm._mixer_fused(xa @ leaves["in_proj"], leaves, cfg)
            out = y @ leaves["out_proj"]
        (out * dy).sum().backward()
        grads.append({"x": xa.grad, **{k: v.grad for k, v in leaves.items()}})
    for k, want in grads[0].items():
        torch.testing.assert_close(grads[1][k], want, rtol=1e-5, atol=1e-6,
                                   msg=k)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-4.0-h-small"])
def test_fused_path_under_remat_gives_the_plain_loss_and_gradients(
        arch, monkeypatch):
    # the training loss with every decoder layer checkpointed, the fused
    # path forced onto CPU tensors (its Functions saved, recomputed and
    # differentiated as on the card): the plain path's loss and gradients
    from repro_torch.nn import init_params, lm_loss
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(17)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(
        np.int32)}
    got = []
    for fused_path in (False, True):
        monkeypatch.setattr(ssm, "_fused", lambda z: fused_path)
        model = init_params(cfg, seed=3, device="cpu").trainable()
        before = dict(fused.LAUNCHES)
        with obs.recording():
            obs.reset()
            loss, _ = lm_loss(model, cfg, batch, device="cpu", remat=True)
            named = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            counters = obs.snapshot().counters
            obs.reset()
        assert fused.LAUNCHES == before
        mamba = sum(k in ("ssm", "hybrid") for k in cfg.layer_kinds)
        # the forward and each checkpointed layer's recompute
        assert counters.get("ssm.fused", 0) == 2 * mamba * fused_path
        got.append((loss.detach(), {n: g for n, g in zip(named, grads)}))
    torch.testing.assert_close(got[1][0], got[0][0], rtol=1e-6, atol=1e-6)
    for name, want in got[0][1].items():
        g = got[1][1][name]
        if want is None:
            assert g is None, name
        else:
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6,
                                       msg=name)


def test_fused_path_on_a_one_rank_layout_is_bit_equal():
    # the fused path under a 1 x 1 layout runs the same pieces on whole
    # shards (head_local): the same bits as on plain tensors
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_mesh, one_rank_world
    from repro_torch.parallel import context as pctx
    cfg = get_smoke_config("hymba-1.5b")
    x, p = _mixer_inputs(cfg, 15, dtype=torch.bfloat16)
    with torch.no_grad():
        want = ssm._mixer_fused(x @ p["in_proj"], p, cfg)
    with one_rank_world("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        laid = {k: distribute_tensor(v, mesh, (Replicate(),) * 2)
                for k, v in p.items()}
        xd = distribute_tensor(x, mesh, (Replicate(),) * 2)
        with torch.no_grad(), pctx.use(
                pctx.ShardingContext(mesh=mesh, dp_axes=("data",))):
            got = ssm._mixer_fused(xd @ laid["in_proj"], laid, cfg)
        for g, w in zip(got, want):
            assert torch.equal(g.full_tensor(), w)


# The fused path on a (1, R) gloo mesh in forked processes against one
# device, forward and every gradient, float32: R = 2 splits the smoke
# hymba's 8 heads (each rank its heads, the norm's sum of squares added
# over the ranks), R = 3 does not (each rank whole rows of the 3).
_RANKS_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import ssm
from repro_torch.parallel import context as pctx

RANKS, PORT = int(sys.argv[1]), int(sys.argv[2])


def worker(rank):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            rank=rank, world_size=RANKS)
    try:
        cfg = get_smoke_config("hymba-1.5b")
        gen = torch.Generator().manual_seed(0)
        p = {k: 0.3 * torch.randn(*s, generator=gen)
             for k, s in ssm.ssm_param_shapes(cfg).items()}
        p["A_log"] = torch.log(torch.linspace(1, 4, cfg.ssm_heads))
        p["norm"] = 1 + 0.1 * torch.randn(cfg.ssm_d_inner, generator=gen)
        x = torch.randn(3, 2 * cfg.ssm_chunk, cfg.d_model, generator=gen)
        dy = torch.randn(x.shape, generator=gen)

        def run(x, p):
            y, s = ssm._mixer_fused(x @ p["in_proj"], p, cfg)
            return y @ p["out_proj"], s

        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xa = x.clone().requires_grad_(True)
        want, want_s = run(xa, leaves)
        (want * dy).sum().backward()
        mesh = make_mesh((1, RANKS), ("data", "model"), "cpu")
        laid = {k: distribute_tensor(v.clone(), mesh, (Replicate(),) * 2)
                .requires_grad_(True) for k, v in p.items()}
        xd = distribute_tensor(x.clone(), mesh, (Replicate(),) * 2) \
            .requires_grad_(True)
        with pctx.use(pctx.ShardingContext(mesh=mesh, dp_axes=("data",))):
            got, got_s = run(xd, laid)
            (got * distribute_tensor(dy, mesh, (Replicate(),) * 2)) \
                .sum().backward()

        def rel(a, b):
            return float((a.detach() - b.detach()).abs().max()
                         / b.detach().abs().max())
        err = {"out": rel(got.full_tensor(), want),
               "state": rel(got_s.full_tensor(), want_s),
               "x": rel(xd.grad.full_tensor(), xa.grad)}
        err.update({k: rel(laid[k].grad.full_tensor(), leaves[k].grad)
                    for k in p})
        if rank == 0:
            print(json.dumps(err))
    finally:
        dist.destroy_process_group()


mp.start_processes(worker, nprocs=RANKS, start_method="fork")
"""


@pytest.mark.parametrize("ranks", [2, 3])
def test_fused_path_across_gloo_ranks_equals_one_device(ranks):
    import json
    import os
    import subprocess
    import sys

    from repro_torch.launch.mesh import _free_port
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _RANKS_SCRIPT, str(ranks),
                          str(_free_port())], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    err = json.loads(out.stdout.strip().splitlines()[-1])
    # float32 sums split over the ranks (the norm's, the row-parallel
    # out_proj's, the partial gradients') add in another order
    assert max(err.values()) < 1e-5, err


@pytest.mark.parametrize("where", ["autograd", "cpu", "layout"])
def test_the_mixer_takes_the_plain_path_off_the_fused_conditions(where):
    # CPU tensors take the plain path under autograd, without it and on a
    # layout's DTensors alike: the mixer counts its call, no fused call and
    # no launch of the fused kernels
    cfg = get_smoke_config("hymba-1.5b")
    x, p = _mixer_inputs(cfg, 9, dtype=torch.bfloat16)
    before = dict(fused.LAUNCHES)
    with obs.recording():
        obs.reset()
        if where == "autograd":
            x.requires_grad_(True)
            ssm.ssm_mixer(x, p, cfg).float().sum().backward()
            assert x.grad is not None
        elif where == "cpu":
            with torch.no_grad():
                ssm.ssm_mixer(x, p, cfg)
        else:
            from torch.distributed.tensor import Replicate, distribute_tensor

            from repro_torch.launch.mesh import make_mesh, one_rank_world
            from repro_torch.parallel import context as pctx
            with one_rank_world("gloo"):
                mesh = make_mesh((1, 1), ("data", "model"), "cpu")
                laid = {k: distribute_tensor(v, mesh, (Replicate(),) * 2)
                        for k, v in p.items()}
                xd = distribute_tensor(x, mesh, (Replicate(),) * 2)
                with torch.no_grad(), pctx.use(
                        pctx.ShardingContext(mesh=mesh, dp_axes=("data",))):
                    out = ssm.ssm_mixer(xd, laid, cfg)
                assert out.shape == x.shape
        counters = obs.snapshot().counters
        obs.reset()
    assert counters.get("ssm.calls") == 1
    assert counters.get("ssm.fused", 0) == 0
    assert fused.LAUNCHES == before


def _fused_inputs(b=2, l=32, h=4, p=8, n=4, K=4, chunk=16):
    di = h * p
    zx = torch.randn(b, l, 2 * di + 2 * n + h).bfloat16()
    w = torch.randn(K, di + 2 * n).bfloat16()
    pro = [zx[..., di:2 * di + 2 * n], zx[..., 2 * di + 2 * n:], w,
           torch.randn(di + 2 * n).bfloat16(), torch.randn(h),
           torch.randn(h), n, chunk]
    nc, q = l // min(chunk, l), min(chunk, l)
    epi = [torch.randn(b * nc * h, q, p), torch.randn(b, nc, q, h, p),
           torch.randn(b * nc, h, q, 1), torch.randn(b, l, di).bfloat16(),
           zx[..., :di], torch.randn(h), torch.randn(di)]
    return pro, epi


@pytest.mark.parametrize("bad", [
    "prologue_dtype", "prologue_conv_dtype", "prologue_widths",
    "prologue_taps", "prologue_ragged", "prologue_chunk", "prologue_state",
    "prologue_bias", "prologue_devices", "prologue_dtensor",
    "prologue_dt_dtype", "prologue_dt_rows", "epilogue_dtype",
    "epilogue_x_dtype", "epilogue_y_intra", "epilogue_cs", "epilogue_cumA",
    "epilogue_norm", "epilogue_wide", "epilogue_z_dtype"])
def test_fused_kernels_refuse_what_they_do_not_take(bad):
    pro, epi = _fused_inputs()
    if bad == "prologue_dtype":             # no bf16, fp16 or float32
        pro[0], pro[1] = pro[0].double(), pro[1].double()
    elif bad == "prologue_conv_dtype":      # integer taps
        pro[2] = pro[2].long()
    elif bad == "prologue_widths":          # conv_w no [K, di + 2 n]
        pro[2] = pro[2][:, :-1]
    elif bad == "prologue_taps":            # K past 4
        pro[2] = torch.randn(5, pro[2].shape[1]).bfloat16()
    elif bad == "prologue_ragged":          # the chunk does not divide l
        pro[0], pro[1] = pro[0][:, :24], pro[1][:, :24]
    elif bad == "prologue_chunk":           # q past K5's 128
        pro, _ = _fused_inputs(b=1, l=256, chunk=256)
    elif bad == "prologue_state":           # n past K5's 128
        pro, _ = _fused_inputs(b=1, l=16, h=1, p=8, n=130)
    elif bad == "prologue_bias":
        pro[3] = pro[3][:-1]
    elif bad == "prologue_devices":
        pro[4] = pro[4].to("meta")
    elif bad == "prologue_dt_dtype":        # dt of another dtype than xBC
        pro[1] = pro[1].float()
    elif bad == "prologue_dt_rows":         # dt of other rows than xBC
        pro[1] = pro[1][:1]
    elif bad == "prologue_dtensor":
        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.launch.mesh import make_mesh, one_rank_world
        with one_rank_world("gloo"):
            mesh = make_mesh((1,), ("data",), "cpu")
            pro[0] = distribute_tensor(pro[0], mesh, (Replicate(),))
            with pytest.raises(TypeError, match="DTensor"):
                fused.prologue(*pro)
        return
    elif bad == "epilogue_dtype":
        epi[2] = epi[2].double()
    elif bad == "epilogue_x_dtype":         # x of another dtype than z
        epi[3] = epi[3].float()
    elif bad == "epilogue_z_dtype":         # no bf16, fp16 or float32
        epi[3], epi[4] = epi[3].double(), epi[4].double()
    elif bad == "epilogue_y_intra":
        epi[0] = epi[0][:, :-1]
    elif bad == "epilogue_cs":
        epi[1] = epi[1].transpose(3, 4)
    elif bad == "epilogue_cumA":
        epi[2] = epi[2][..., 0]
    elif bad == "epilogue_norm":
        epi[6] = epi[6][:-1]
    else:                                   # di past MAX_DI
        h = fused.MAX_DI // 64 + 1
        epi = [torch.zeros(h, 1, 64), torch.zeros(1, 1, 1, h, 64),
               torch.zeros(1, h, 1, 1), torch.zeros(1, 1, 64 * h).bfloat16(),
               torch.zeros(1, 1, 64 * h).bfloat16(), torch.zeros(h),
               torch.zeros(64 * h)]
    with pytest.raises((ValueError, TypeError)):
        if bad.startswith("prologue"):
            fused.prologue(*pro)
        else:
            fused.epilogue(*epi, 1e-5)


def test_fused_wrappers_take_their_plain_versions_on_cpu_tensors():
    # CPU tensors: the plain version, no launch counted; meta tensors the
    # plain version's shapes
    pro, epi = _fused_inputs()
    before = dict(fused.LAUNCHES)
    for got, want in zip(fused.prologue(*pro), fused.prologue_plain(*pro)):
        assert torch.equal(got, want)
    assert torch.equal(fused.epilogue(*epi, 1e-5),
                       fused.epilogue_plain(*epi, 1e-5))
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in pro]
    assert [t.shape for t in fused.prologue(*meta)] == \
        [t.shape for t in fused.prologue_plain(*pro)]
    assert fused.LAUNCHES == before


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


# The fused mixer kernels against their plain versions run in float32 on the
# same inputs (bf16 inputs widened exactly): the kernels' arithmetic, in
# another order, and one bf16 rounding at each bf16 output (2^-9 of the
# value), held to 2^-8 of it plus float32 round-off; float32 outputs that
# come from a rounded conv output (dtx, B, C) the same; cumA, float32 from
# bf16 inputs throughout, to 1e-5.
BF16_OUT_REL = 2.0 ** -8
# (label, heads, head dim, state): hymba-1.5b's and granite-4.0-h-small's
MIXER_WIDTHS = (("hymba", 50, 64, 16), ("granite", 128, 64, 128))
# (rows, positions): one chunk, two chunks, a batch of rows whose conv must
# not reach across a row's start
MIXER_SPANS = ((1, 128), (1, 256), (3, 256))


def _near(got, want, what, rel=BF16_OUT_REL):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rel * want.abs() + 1e-5 * (1 + want.abs().max())
    assert bool(torch.isfinite(got).all()), what
    assert bool((err <= tol).all()), \
        f"{what} off by up to {float(err.max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("span", MIXER_SPANS)
@pytest.mark.parametrize("width", MIXER_WIDTHS, ids=[w[0] for w in
                                                     MIXER_WIDTHS])
def test_cuda_prologue_matches_plain_version(cuda, width, span):
    _, h, hd, n = width
    b, l = span
    di, K = h * hd, 4
    gen = torch.Generator(device=cuda).manual_seed(l + h)
    zx = torch.randn(b, l, 2 * di + 2 * n + h, generator=gen,
                     device=cuda).bfloat16()
    if b > 1:   # a row's last positions far from the next row's first
        zx[:-1, -(K - 1):] = 100.0
    w = (0.5 * torch.randn(K, di + 2 * n, generator=gen, device=cuda)) \
        .bfloat16()
    cb = (0.1 * torch.randn(di + 2 * n, generator=gen, device=cuda)) \
        .bfloat16()
    dt_bias = torch.randn(h, generator=gen, device=cuda)
    A_log = torch.log(torch.linspace(1.0, 16.0, h, device=cuda))
    before = fused.LAUNCHES["ssm_prologue"]
    xbc, dt = zx[..., di:2 * di + 2 * n], zx[..., 2 * di + 2 * n:]
    got = fused.prologue(xbc, dt, w, cb, dt_bias, A_log, n, 128)
    want = fused.prologue_plain(xbc.float(), dt.float(), w.float(),
                                cb.float(), dt_bias, A_log, n, 128)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ssm_prologue"] == before + 1
    assert got[4].dtype == torch.bfloat16
    for g, wt, what in zip(got, want, ("dtx", "Bm", "Cm", "cumA", "x")):
        assert g.shape == wt.shape and g.is_contiguous(), what
        if what == "cumA":
            torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-5)
        else:
            _near(g, wt, what)


@pytest.mark.gpu
@pytest.mark.parametrize("span", MIXER_SPANS)
@pytest.mark.parametrize("width", MIXER_WIDTHS, ids=[w[0] for w in
                                                     MIXER_WIDTHS])
def test_cuda_epilogue_matches_plain_version(cuda, width, span):
    _, h, hd, _ = width
    b, l = span
    di, q = h * hd, 128
    nc = l // q
    gen = torch.Generator(device=cuda).manual_seed(l + h + 1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)
    zx = rnd(b, l, 2 * di + 64).bfloat16()
    a = -0.1 * torch.rand(b * nc, h, q, generator=gen, device=cuda)
    args = [rnd(b * nc * h, q, hd),
            rnd(b, nc, h, q, hd).transpose(2, 3),   # C S_in, strided
            a.cumsum(2)[..., None], rnd(b, l, di).bfloat16(), zx[..., :di],
            rnd(h), 1 + 0.1 * rnd(di)]
    before = fused.LAUNCHES["ssm_epilogue"]
    got = fused.epilogue(*args, 1e-5)
    wide = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    want = fused.epilogue_plain(*wide, 1e-5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ssm_epilogue"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, di)
    _near(got, want, "out")


@pytest.mark.gpu
def test_cuda_kernels_take_float32_activations(cuda):
    # the kernels on float32 activations (float32 weights, as the float32
    # models train) against their plain versions: float32 round-off
    dtype = torch.float32
    h, hd, n, b, l, K = 8, 64, 16, 2, 256, 4
    di = h * hd
    gen = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=cuda)
    zx = rnd(b, l, 2 * di + 2 * n + h).to(dtype)
    xbc, dt = zx[..., di:2 * di + 2 * n], zx[..., 2 * di + 2 * n:]
    w, cb = rnd(K, di + 2 * n, scale=0.5), rnd(di + 2 * n, scale=0.1)
    dt_bias, A_log = rnd(h), torch.log(torch.linspace(1.0, 16.0, h,
                                                      device=cuda))
    got = fused.prologue(xbc, dt, w, cb, dt_bias, A_log, n, 128)
    want = fused.prologue_plain(xbc.float(), dt.float(), w, cb, dt_bias,
                                A_log, n, 128)
    rel = 1e-5
    assert got[4].dtype == dtype
    for g, wt, what in zip(got, want, ("dtx", "Bm", "Cm", "cumA", "x")):
        _near(g, wt, what, rel)
    y_intra, CS = rnd(b * 2 * h, 128, hd), rnd(b, 2, 128, h, hd)
    args = (y_intra, CS, got[3], got[4], zx[..., :di], rnd(h),
            1 + rnd(di, scale=0.1))
    out = fused.epilogue(*args, 1e-5)
    assert out.dtype == dtype
    _near(out, fused.epilogue_plain(*(t.float() for t in args), 1e-5), "out",
          rel)


@pytest.mark.gpu
def test_cuda_epilogue_split_norm_equals_one_launch(cuda):
    # the two launches a tensor-parallel layout takes: the sum of squares
    # written (mode 1) and read back (mode 2) give the one launch's bits;
    # a total of twice the squares over twice the channels, the same
    h, hd, b, l, q = 8, 64, 2, 256, 128
    di = h * hd
    gen = torch.Generator(device=cuda).manual_seed(8)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)
    a = -0.1 * torch.rand(b * l // q, h, q, generator=gen, device=cuda)
    args = (rnd(b * l // q * h, q, hd), rnd(b, l // q, q, h, hd),
            a.cumsum(2)[..., None], rnd(b, l, di).bfloat16(), fused._rows(
                rnd(b, l, di).bfloat16()), rnd(h), 1 + 0.1 * rnd(di))
    one, two = (torch.empty(b, l, di, dtype=torch.bfloat16, device=cuda)
                for _ in range(2))
    ss = torch.empty(b * l, device=cuda)
    before = fused.LAUNCHES["ssm_epilogue"]
    fused._epilogue_cuda(*args, 1e-5, one)
    fused._epilogue_cuda(*args, 1e-5, two, ss=ss, mode=1)
    fused._epilogue_cuda(*args, 1e-5, two, ss=ss, mode=2)
    assert torch.equal(one, two)
    ss *= 2
    fused._epilogue_cuda(*args, 1e-5, two, ss=ss, mode=2, di_norm=2 * di)
    assert torch.equal(one, two)
    assert fused.LAUNCHES["ssm_epilogue"] == before + 4


@pytest.mark.gpu
def test_cuda_mixer_takes_the_fused_path_with_and_without_autograd(cuda):
    # bf16 on the card: the two kernels with and without autograd, the same
    # bits either way; the backward (the plain pieces run again) within a
    # few bf16 roundings of the plain path's on the CPU
    cfg = get_smoke_config("hymba-1.5b")
    x, p = _mixer_inputs(cfg, 11, dtype=torch.bfloat16)
    xc, pc = x.to(cuda), {k: v.to(cuda) for k, v in p.items()}
    before = dict(fused.LAUNCHES)
    with obs.recording():
        obs.reset()
        with torch.no_grad():
            got, (gc, gs) = ssm.ssm_mixer(xc, pc, cfg, return_state=True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in pc.items()}
        xa = xc.clone().requires_grad_(True)
        out = ssm.ssm_mixer(xa, leaves, cfg)
        out.float().square().sum().backward()
        counts = dict(obs.snapshot().counters)
        obs.reset()
    assert counts["ssm.calls"] == counts["ssm.fused"] == 2
    assert fused.LAUNCHES == {k: v + 2 for k, v in before.items()}
    assert torch.equal(out.detach(), got)
    want, (wc, ws) = ssm.ssm_mixer(x, p, cfg, return_state=True)
    assert torch.equal(gc.cpu(), wc)
    for g, w in ((got, want), (gs, ws)):
        w = w.detach().float()
        assert float((g.cpu().float() - w).norm() / w.norm()) < 0.03
    ref = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xr = x.clone().requires_grad_(True)
    ssm.ssm_mixer(xr, ref, cfg).float().square().sum().backward()
    for k, g in [("x", xa.grad)] + [(k, v.grad) for k, v in leaves.items()]:
        w = (xr.grad if k == "x" else ref[k].grad).float()
        assert float((g.cpu().float() - w).norm() / w.norm()) < 0.05, k
