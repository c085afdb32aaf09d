"""The port's MoE layer (``repro_torch.nn.moe``) against the JAX package's
(``repro.nn.moe``), on the same weights and tokens.

Both MoE smoke configs (deepseek-moe-16b: 8 experts top-2 with a shared
expert; qwen3-moe-30b-a3b: 8 experts top-2): the output within 1e-4 in
float32 and 0.1 in bfloat16, the aux loss within 1e-6, the routing indices
equal.  Routing is discrete, so each case first checks that no token's
k-th and (k+1)-th router probabilities lie within ``TIE_GAP`` of each other
(a near-tie would let float32 rounding pick another expert) and fails
loudly if one does.  A ``capacity_factor`` of 0.5 drops assignments: the
kept set equals the reference's (stable sort by expert, first ``C`` of
each).  The chunked path runs with ``MOE_CHUNK_TOKENS`` set small in both
modules.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.nn import moe as ref_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
F32_TOL = 1e-4
BF16_TOL = 0.1
AUX_TOL = 1e-6
#: The least gap between a token's k-th and (k+1)-th router probability for
#: which the two packages' float32 routers must agree.
TIE_GAP = 1e-5


def _setup(arch, T, f32, seed=0, **change):
    """(cfg, rcfg, torch params, jnp params, torch x, jnp x) of one MoE
    layer: the reference's recipe for the weights, x [2, T/2, d] normal."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **change)
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **change)
    rng = np.random.default_rng(seed)
    shapes = moe.moe_param_shapes(cfg)
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32)
         for k, sh in shapes.items()}
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if f32 else jnp.bfloat16
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    jx = jnp.asarray(x, jdt)
    # the torch side gets the reference's bits exactly
    tp = {k: _t(v) for k, v in jp.items()}
    return cfg, rcfg, tp, jp, _t(jx), jx


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ref_routing(jx, jp, rcfg):
    """The reference's top-k (its lines of ``_moe_groups``) on the same
    tokens: (probs [T, E], idx [T, K]) as numpy."""
    xf = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ jp["router"].astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, rcfg.n_experts_active)
    return np.asarray(probs), np.asarray(idx)


def _no_near_tie(probs, K, what):
    ranked = -np.sort(-probs, axis=-1)
    gap = ranked[:, K - 1] - ranked[:, K]
    if gap.min() < TIE_GAP:
        pytest.fail(f"{what}: a near-tie in the routing (k-th and k+1-th "
                    f"probabilities {gap.min():.3g} apart at token "
                    f"{int(gap.argmin())}); the test's input cannot hold "
                    f"the routing to the reference")


def _ref_keep(idx, C, E):
    """The reference's kept assignments in expert-sorted order, from its
    routing (``jnp.argsort`` is stable; each expert keeps its first C)."""
    eflat = idx.reshape(-1)
    order = np.argsort(eflat, kind="stable")
    e_sorted = eflat[order]
    counts = np.bincount(eflat, minlength=E)
    offsets = np.cumsum(counts) - counts
    rank = np.arange(eflat.size) - offsets[e_sorted]
    return order, rank < C


# -- shapes and capacity -------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_shapes_equal_repro(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, rcfg = getattr(configs, get)(arch), getattr(ref_configs, get)(arch)
    assert moe.moe_param_shapes(cfg) == ref_moe.moe_param_shapes(rcfg)


@pytest.mark.parametrize("T", [1, 2, 4, 7, 64, 100, 512, 8192, 16384])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_capacity_equals_repro(T, cf):
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  capacity_factor=cf)
        rcfg = dataclasses.replace(ref_configs.get_config(arch),
                                   capacity_factor=cf)
        assert moe.capacity(T, cfg) == ref_moe.capacity(T, rcfg)
        assert moe.capacity(T, cfg) % 8 == 0 and moe.capacity(T, cfg) >= 8


def test_capacity_at_deepseeks_prefill():
    # 4 x 2048 tokens, top-6 of 64 at 1.25: 8192 * 6 * 1.25 / 64 + 1 = 961
    assert moe.capacity(8192, configs.get_config("deepseek-moe-16b")) == 968
    assert moe.MOE_CHUNK_TOKENS == ref_moe.MOE_CHUNK_TOKENS == 16384


# -- the layer against repro ---------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [2, 64])
def test_moe_ffn_matches_repro(arch, f32, T):
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, T, f32)
    probs, r_idx = _ref_routing(jx, jp, rcfg)
    _no_near_tie(probs, cfg.n_experts_active, arch)
    want, r_aux = ref_moe.moe_ffn(jx, jp, rcfg)
    got, aux = moe.moe_ffn(tx, tp, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=AUX_TOL,
                               atol=AUX_TOL)
    gates, idx, prob_sum, hits = moe.route(tx.reshape(1, T, -1),
                                           tp["router"], cfg)
    np.testing.assert_array_equal(idx[0].numpy(), r_idx)
    assert float(moe.aux_loss(prob_sum, hits, T, cfg)) == float(aux)
    torch.testing.assert_close(gates[0].sum(-1), torch.ones(T))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropped_assignments_are_the_references(arch):
    # capacity factor 0.5: each expert keeps about half its assignments
    T = 64
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, T, True, seed=3,
                                       capacity_factor=0.5)
    probs, r_idx = _ref_routing(jx, jp, rcfg)
    _no_near_tie(probs, cfg.n_experts_active, arch)
    C = moe.capacity(T, cfg)
    r_order, r_keep = _ref_keep(r_idx, C, cfg.n_experts)
    assert 0 < r_keep.sum() < r_keep.size        # some dropped, some kept
    gates, idx, _, _ = moe.route(tx.reshape(1, T, -1), tp["router"], cfg)
    buf, plan = moe.dispatch(tx.reshape(1, T, -1), idx, gates, C,
                             cfg.n_experts)
    buf = buf[0]
    np.testing.assert_array_equal(plan.order[0].numpy(), r_order)
    np.testing.assert_array_equal(plan.keep[0].numpy(), r_keep)
    np.testing.assert_array_equal(plan.counts[0].numpy(),
                                  np.bincount(r_idx.reshape(-1),
                                              minlength=cfg.n_experts))
    # slot (e, c) holds the c-th kept token of expert e, zeros after
    xf = tx.reshape(T, -1)
    for e in range(cfg.n_experts):
        toks = [r_order[j] // cfg.n_experts_active
                for j in range(r_order.size)
                if r_idx.reshape(-1)[r_order[j]] == e][:C]
        torch.testing.assert_close(buf[e, :len(toks)], xf[toks])
        assert not buf[e, len(toks):].any()
    want, r_aux = ref_moe.moe_ffn(jx, jp, rcfg)
    got, aux = moe.moe_ffn(tx, tp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=AUX_TOL,
                               atol=AUX_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T", [64, 96])
def test_chunked_routing_matches_repro(arch, T, monkeypatch):
    # chunks of 16 tokens: 64 and 96 tokens route in 4 and 6 chunks, each
    # with its own capacity, aux their mean
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", 16)
    monkeypatch.setattr(ref_moe, "MOE_CHUNK_TOKENS", 16)
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, T, True, seed=5)
    probs, _ = _ref_routing(jx, jp, rcfg)
    _no_near_tie(probs, cfg.n_experts_active, arch)
    want, r_aux = ref_moe.moe_ffn(jx, jp, rcfg)
    got, aux = moe.moe_ffn(tx, tp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=AUX_TOL,
                               atol=AUX_TOL)
    # one routing call a chunk of 16 tokens
    calls = []
    real = moe._moe_groups
    monkeypatch.setattr(moe, "_moe_groups",
                        lambda xf, p, c, dp: calls.append(tuple(xf.shape[:2]))
                        or real(xf, p, c, dp))
    moe.moe_ffn(tx, tp, cfg)
    assert calls == [(1, 16)] * (T // 16)


def test_unchunked_when_not_a_multiple(monkeypatch):
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", 16)
    monkeypatch.setattr(ref_moe, "MOE_CHUNK_TOKENS", 16)
    cfg, rcfg, tp, jp, tx, jx = _setup("deepseek-moe-16b", 40, True, seed=6)
    probs, _ = _ref_routing(jx, jp, rcfg)
    _no_near_tie(probs, cfg.n_experts_active, "deepseek-moe-16b")
    want, _ = ref_moe.moe_ffn(jx, jp, rcfg)
    got, _ = moe.moe_ffn(tx, tp, cfg)
    whole, _ = moe._moe_groups(tx.reshape(1, 40, -1), tp, cfg, None)
    torch.testing.assert_close(got.reshape(40, -1), whole[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ties_go_to_the_lower_expert_as_top_k_breaks_them():
    # a zero router: every probability equal, so the k lowest ids win
    cfg, rcfg, tp, jp, tx, jx = _setup("qwen3-moe-30b-a3b", 8, True)
    tp["router"] = torch.zeros_like(tp["router"])
    jp["router"] = jnp.zeros_like(jp["router"])
    gates, idx, _, _ = moe.route(tx.reshape(1, 8, -1), tp["router"], cfg)
    _, r_idx = _ref_routing(jx, jp, rcfg)
    np.testing.assert_array_equal(idx[0].numpy(), r_idx)
    np.testing.assert_array_equal(idx[0].numpy(), np.tile(
        np.arange(cfg.n_experts_active), (8, 1)))
    torch.testing.assert_close(gates[0], torch.full((8, 2), 0.5))
    want, r_aux = ref_moe.moe_ffn(jx, jp, rcfg)
    got, aux = moe.moe_ffn(tx, tp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=AUX_TOL)


def test_combine_adds_in_the_activations_dtype():
    # bf16 activations: the combine's scatter-add is bf16, as the
    # reference's; so is the output
    cfg, rcfg, tp, jp, tx, jx = _setup("deepseek-moe-16b", 64, False)
    gates, idx, _, _ = moe.route(tx.reshape(1, 64, -1), tp["router"], cfg)
    buf, plan = moe.dispatch(tx.reshape(1, 64, -1), idx, gates,
                             moe.capacity(64, cfg), cfg.n_experts)
    out = moe.experts(buf, tp)
    assert buf.dtype == out.dtype == torch.bfloat16
    y = moe.combine(out, plan, 64)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 64, cfg.d_model)


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_on_cuda_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, 512, True, seed=7)
    _no_near_tie(_ref_routing(jx, jp, rcfg)[0], cfg.n_experts_active, arch)
    got, aux = moe.moe_ffn(tx.cuda(), {k: v.cuda() for k, v in tp.items()},
                           cfg)
    want, w_aux = moe.moe_ffn(tx, tp, cfg)
    _, idx_g, _, _ = moe.route(tx.reshape(1, 512, -1).cuda(),
                               tp["router"].cuda(), cfg)
    _, idx_c, _, _ = moe.route(tx.reshape(1, 512, -1), tp["router"], cfg)
    torch.testing.assert_close(idx_g.cpu(), idx_c, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), want, rtol=F32_TOL, atol=F32_TOL)
    assert abs(float(aux) - float(w_aux)) <= AUX_TOL
