"""Stacks whose layers differ in their mixer, Granite's scalars and an
expert layer that holds a share of the router's experts, in the PyTorch
port (granite-4.0-h-small, a port-only id of the registry).

The JAX package has no such model, so these tests hold the port to itself
and to hand counts: the registry and the published widths, the parameter
and cache trees by layer kind, prefill then decode against the full
forward for every token-driven id of the registry in float32, the expert
shares against the uncut layer, and the recorder's layer types and MoE
counters.  ``tests/test_bench_layer_types.py`` holds Granite to the
benchmark's plain reference.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, obs  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.nn import (cache_shapes, forward_logits,  # noqa: E402
                            init_cache, init_params, moe, param_shapes)
from repro_torch.nn.config import ArchConfig  # noqa: E402

GRANITE = "granite-4.0-h-small"
TOL = 1e-4
#: Ids of the registry whose prompts are tokens (not patch or frame
#: embeddings).
TOKEN_IDS = [a for a in configs.ALL_IDS
             if not configs.get_smoke_config(a).frontend
             and not configs.get_smoke_config(a).encoder_layers]


def _share(cfg, first, held):
    return dataclasses.replace(cfg, n_experts=held,
                               router_experts=cfg.n_experts,
                               expert_first=first)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# -- the registry and the published model --------------------------------------
def test_granite_is_a_port_only_id_with_the_published_widths():
    assert GRANITE in configs.PORT_ONLY_IDS and GRANITE not in configs.ARCH_IDS
    assert set(configs.all_configs()) == set(configs.ALL_IDS)
    cfg = configs.get_config(GRANITE)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.rope_theta) == \
        (40, 4096, 32, 8, 128, 100352, 0.0)
    assert (cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_inner,
            cfg.ssm_conv_kernel) == (128, 128, 64, 8192, 4)
    assert (cfg.n_experts, cfg.n_experts_active, cfg.moe_d_ff,
            cfg.n_shared_experts * cfg.moe_d_ff) == (72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_multiplier) == \
        (12.0, 0.22, 16.0, 1 / 128)
    assert cfg.tie_embeddings and cfg.norm_eps == 1e-5
    assert cfg.layer_kinds.count("ssm") == 36
    assert cfg.layer_kinds.count("moe") == 4
    # the whole model 32.2 B; 36 of 72 experts 18.6 B
    assert cfg.n_params() == 32_205_176_832
    assert _share(cfg, 0, 36).n_params() == 18_615_631_872


def test_layer_types_and_expert_shares_are_checked():
    cfg = configs.get_smoke_config(GRANITE)
    with pytest.raises(ValueError, match="unknown layer types"):
        dataclasses.replace(cfg, layer_types=("mamba",) * 5 + ("mlp",))
    with pytest.raises(ValueError, match="5 layer types for 6 layers"):
        dataclasses.replace(cfg, layer_types=("mamba",) * 5)
    with pytest.raises(ValueError, match="past the router"):
        _share(cfg, 6, 4)
    assert isinstance(dataclasses.replace(
        cfg, layer_types=list(cfg.layer_types)).layer_types, tuple)


@pytest.mark.parametrize("arch", configs.ALL_IDS)
def test_layer_kinds_cover_the_stack(arch):
    cfg = configs.get_smoke_config(arch)
    kinds = cfg.layer_kinds
    assert len(kinds) == cfg.n_layers - cfg.first_dense_layers
    if cfg.layer_types:
        assert cfg.block_kind == "mixed"
        assert set(kinds) == {"ssm", "moe"}
    else:
        assert set(kinds) == {cfg.block_kind}


# -- parameter and cache trees --------------------------------------------------
@pytest.mark.parametrize("arch", configs.ALL_IDS)
def test_stacked_leaves_count_the_layers_that_hold_them(arch):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, device="cpu")
    held = collections.Counter()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            held[(parts[2], parts[3])] += 1
    for group, leaves in param_shapes(cfg)["layers"].items():
        for leaf, shape in leaves.items():
            assert shape[0] == held[(group, leaf)], (group, leaf)
    cache = init_cache(cfg, 2, 24, device="cpu")
    assert {g: {k: tuple(t.shape) for k, t in d.items()}
            for g, d in cache.items()} == cache_shapes(cfg, 2, 24)


def test_granite_cache_stacks_each_state_over_its_own_layers():
    cfg = configs.get_smoke_config(GRANITE)
    shapes = cache_shapes(cfg, 3, 40)["layers"]
    assert shapes == {"conv": (5, 3, 3, 160), "ssd": (5, 3, 8, 16, 16),
                      "k": (1, 3, 40, 2, 16), "v": (1, 3, 40, 2, 16)}


# -- prefill then decode against the full forward -------------------------------
@pytest.mark.parametrize("arch", TOKEN_IDS)
def test_prefill_then_decode_equals_the_full_forward_in_float32(arch):
    # a generous capacity, so that no expert drops: a prefill's routing
    # group and a decode step's have capacities of their own
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              capacity_factor=8.0)
    model = init_params(cfg, seed=4, device="cpu").float()
    S, n = 13, 3
    toks = torch.randint(0, cfg.vocab_size, (2, S + n),
                         generator=torch.Generator().manual_seed(9))
    full, _ = forward_logits(model, cfg, toks, device="cpu")
    logits, cache = make_prefill_step(cfg, S + n, device="cpu")(
        model, {"tokens": toks[:, :S]})
    assert _rel(logits, full[:, S - 1]) < TOL
    serve = make_serve_step(cfg, device="cpu")
    for pos in range(S, S + n):
        logits, cache = serve(model, cache, toks[:, pos], pos)
        if pos + 1 < S + n:
            assert _rel(logits, full[:, pos]) < TOL, pos


# -- the expert share -----------------------------------------------------------
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_expert_shares_add_up_to_the_uncut_layer(capacity_factor):
    cfg = dataclasses.replace(configs.get_smoke_config(GRANITE),
                              capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(3)
    p = {k: torch.randn(sh, generator=g) / sh[-2] ** 0.5
         for k, sh in moe.moe_param_shapes(cfg).items()}
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    whole, _ = moe.moe_ffn(x, p, cfg)
    shared = moe._shared(x, p)
    parts = []
    for first in (0, 4):
        held = {k: v[first:first + 4] if k in ("w1", "w3", "w2") else v
                for k, v in p.items()}
        parts.append(moe.moe_ffn(x, held, _share(cfg, first, 4))[0])
    assert _rel(parts[0] + parts[1] - shared, whole) < 1e-5


def test_a_share_routes_over_the_whole_router():
    cfg = _share(configs.get_smoke_config(GRANITE), 4, 4)
    assert moe.moe_param_shapes(cfg)["router"] == (cfg.d_model, 8)
    assert moe.moe_param_shapes(cfg)["w1"] == (4, cfg.d_model, 32)
    # the capacity over the router's 8 experts: 64 x 2 x 1.25 / 8 + 1 -> 24
    assert moe.capacity(64, cfg) == 24
    idx = torch.tensor([[[0, 4], [5, 7], [4, 5], [3, 6]]])
    x = torch.arange(4.0)[None, :, None].expand(1, 4, 2)
    buf, plan = moe.dispatch(x, idx, torch.full((1, 4, 2), 0.5), 8, 4,
                             first=4)
    assert plan.counts.tolist() == [[2, 2, 1, 1]]
    assert int(plan.keep.sum()) == 6
    # expert 4 (local 0) holds tokens 0 and 2, expert 7 (local 3) token 1
    assert buf[0, 0, :2, 0].tolist() == [0.0, 2.0]
    assert buf[0, 3, :1, 0].tolist() == [1.0]


# -- the recorder ---------------------------------------------------------------
def test_layer_spans_carry_their_type_and_moe_local_counts_the_share():
    cfg = _share(configs.get_smoke_config(GRANITE), 0, 4)
    model = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    routed = []
    real_route = moe.route

    def spy(xf, router, c):
        out = real_route(xf, router, c)
        routed.append(out[1])
        return out

    obs.reset()
    try:
        moe.route = spy
        with obs.recording():
            make_prefill_step(cfg, device="cpu")(model, {"tokens": toks})
        snap = obs.snapshot()
    finally:
        moe.route = real_route
        obs.reset()
    types = [s.attrs["type"] for s in snap.named("repro_torch.layer")]
    assert types == ["mamba"] * 5 + ["attention"]
    C = moe.capacity(64, cfg)
    counts = [torch.bincount(idx.reshape(-1), minlength=8)[:4]
              for idx in routed]
    assert len(routed) == 6
    assert snap.counters["moe.assignments"] == 6 * 64 * 2
    assert snap.counters["moe.local"] == sum(int(c.sum()) for c in counts)
    assert snap.counters["moe.slots"] == 6 * 4 * C
    assert snap.counters["moe.kept"] == sum(int(c.clamp(max=C).sum())
                                            for c in counts)


@pytest.mark.parametrize("arch,want", [("hymba-1.5b", "hybrid"),
                                       ("mamba2-130m", "mamba"),
                                       ("deepseek-moe-16b", "attention")])
def test_layer_spans_name_each_family_s_mixer(arch, want):
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 16))
    obs.reset()
    try:
        with obs.recording():
            make_prefill_step(cfg, device="cpu")(model, {"tokens": toks})
        snap = obs.snapshot()
    finally:
        obs.reset()
    types = [s.attrs["type"] for s in snap.named("repro_torch.layer")]
    assert len(types) == cfg.n_layers
    # deepseek's leading dense layer attends too
    assert set(types) == {want}
    if cfg.is_moe:
        assert snap.counters["moe.local"] == snap.counters["moe.assignments"]


def test_arch_config_accepts_the_port_only_fields_at_their_defaults():
    cfg = configs.get_config("llama3.2-3b")
    assert cfg.layer_types == () and cfg.n_router_experts == 0
    assert cfg.expert_first == 0
    assert ArchConfig(name="x", family="moe", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=8,
                      n_experts=4).n_router_experts == 4
