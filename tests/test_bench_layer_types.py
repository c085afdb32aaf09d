"""The benchmark's granite-4.0-h-small cell on the CPU at a size of its
own: the port against the plain float32 reference of a stack whose layers
differ in their mixer (``bench/reference/layer_types.py``), the expert
shares against the uncut layer, the harness module that runs the cell, the
FLOP count and the MFU metric, and a whole run with and without a fault.

The smoke model keeps Granite's order (five Mamba2 layers, then
attention), its scalars and its MoE layer: 8 experts, 4 held, top-2, a
shared expert.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import checks, cli, manifest  # noqa: E402
from harness.prefill_closed import cache_row  # noqa: E402
from harness.prefill_layer_types import (Fed, Taken,  # noqa: E402
                                         program_config)
from harness.weights import (arch_config, build_model,  # noqa: E402
                             leaf_specs, make_weights)
from reference import layer_types as ref  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.nn import moe  # noqa: E402

CELL = "granite-4.0-h-small.prefill-long16k"
TOL = 1e-4
SCALARS = ("embedding_multiplier", "residual_multiplier", "logits_scaling",
           "attention_multiplier")
#: The cell's configuration cut to the CPU: Granite's first six layers.
SMALL = dict(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             vocab_size=256, n_experts=4, router_experts=8, expert_first=0,
             n_experts_active=2, n_shared_experts=1, moe_d_ff=32,
             ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
SMALL_TRAFFIC = dict(lengths=[32, 64], steps=[2, 1], tokens_per_step=128,
                     cache_extra=8, check={"steps_per_length": 1})


def small_config(**arch) -> dict:
    """The configuration file's object at the smoke size, ``arch``
    replacing fields of its ``arch_config``."""
    config = manifest.load_cell(CELL).config
    group = dict(config["arch_config"], **SMALL)
    group["layer_types"] = group["layer_types"][:group["n_layers"]]
    return dict(config, arch_config=dict(group, **arch),
                moe_chunk_tokens=128)


def small_cell(**arch):
    cell = manifest.load_cell(CELL)
    return dataclasses.replace(cell, config=small_config(**arch),
                               traffic=dict(cell.traffic, **SMALL_TRAFFIC))


def f32_model(flat: dict, seed: int = 3):
    """The port's model of ``flat`` on float32 weights drawn from
    ``seed``, and the weights."""
    cfg = arch_config(flat)
    w = {n: t.float() for n, t in make_weights(
        leaf_specs(cfg), seed, torch.device("cpu")).items()}
    return cfg, w, build_model(cfg, w)


def _tokens(B, S, seed=1):
    return torch.randint(0, SMALL["vocab_size"], (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# -- the port against the reference --------------------------------------------
def test_prefill_logits_and_cache_match_the_reference_in_float32():
    flat = program_config(small_config())
    cfg, w, model = f32_model(flat)
    toks = _tokens(2, 32)
    logits, cache = make_prefill_step(cfg, 40, device="cpu")(
        model, {"tokens": toks})
    (rlogits, rcache), = ref.forward(w, flat, [(toks, 1)])
    assert _rel(logits, rlogits) < TOL
    row = cache_row(cache, 1)
    assert set(row) == set(rcache) == {"k", "v", "conv", "ssd"}
    # k/v of the one attention layer, conv/ssd of the five Mamba2 layers
    assert rcache["k"].shape[0] == 1 and rcache["ssd"].shape[0] == 5
    for key, want in rcache.items():
        assert checks._rel(row[key], want) < TOL, key


def test_prefill_then_decode_matches_the_full_forward_in_float32():
    # no expert drops (a generous capacity): a prefill's routing group and
    # a decode step's have capacities of their own
    flat = program_config(small_config(capacity_factor=8.0))
    cfg, w, model = f32_model(flat, seed=5)
    S, n = 12, 4                  # a prompt of 12, then 4 decode steps
    toks = _tokens(2, S + n, seed=2)
    logits, cache = make_prefill_step(cfg, S + n, device="cpu")(
        model, {"tokens": toks[:, :S]})
    got = [logits]
    serve = make_serve_step(cfg, device="cpu")
    for pos in range(S, S + n):
        step_logits, cache = serve(model, cache, toks[:, pos], pos)
        got.append(step_logits)
    # the logits at positions S-1 .. S+n-1 of the whole sequence (the last
    # decode step's token is the one past it)
    want = ref.all_logits(w, flat, toks)
    for j, lg in enumerate(got[:-1]):
        assert _rel(lg, want[:, S - 1 + j]) < TOL, j
    assert _rel(got[-1], want[:, -1]) < TOL


@pytest.mark.parametrize("scalar", SCALARS)
def test_a_doubled_scalar_fails_the_prefill_comparison(scalar):
    good = program_config(small_config())
    bad = program_config(small_config(**{scalar: 2 * good[scalar]}))
    _, w, _ = f32_model(good)
    cfg = arch_config(bad)
    toks = _tokens(2, 32)
    logits, cache = make_prefill_step(cfg, 40, device="cpu")(
        build_model(cfg, w), {"tokens": toks})
    (rlogits, rcache), = ref.forward(w, good, [(toks, 1)])
    row = cache_row(cache, 1)
    worst = max([_rel(logits, rlogits)]
                + [checks._rel(row[k], v) for k, v in rcache.items()])
    assert worst > 10 * TOL, (scalar, worst)


# -- the expert shares ------------------------------------------------------------
def _layer_weights(flat, seed=7):
    """One expert layer's weights of the uncut layer (8 experts) in
    float32, keyed as the reference reads them."""
    cfg = arch_config(dict(flat, n_experts=8, router_experts=8))
    g = torch.Generator().manual_seed(seed)
    return {f"moe.{k}": torch.randn(sh, generator=g) / sh[-2] ** 0.5
            for k, sh in moe.moe_param_shapes(cfg).items()}


def _share(w, first, E):
    return {k: v[first:first + E] if k[4:] in ("w1", "w3", "w2") else v
            for k, v in w.items()}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_two_expert_shares_add_up_to_the_uncut_layer(capacity_factor):
    # experts 0-3 here, 4-7 on the peer: the two shares' results, with the
    # shared expert (which both compute) counted once, are the uncut
    # layer's, drops included (0.5 drops about half the assignments)
    flat = program_config(small_config(capacity_factor=capacity_factor))
    uncut = dict(flat, n_experts=8, router_experts=8, expert_first=0)
    halves = [dict(flat, expert_first=f) for f in (0, 4)]
    w = _layer_weights(flat)
    x = torch.randn(48, SMALL["d_model"],
                    generator=torch.Generator().manual_seed(8))
    with ref.strict_fp32():
        whole = ref.moe(x, w, uncut)
        shared = ref.swiglu(x, w["moe.shared_w1"], w["moe.shared_w3"],
                            w["moe.shared_w2"])
        ref_parts = [ref.moe(x, _share(w, c["expert_first"], 4), c)
                     for c in halves]
    assert _rel(sum(ref_parts) - shared, whole) < 1e-5
    port_parts = []
    for c in halves:
        p = {k[4:]: v for k, v in _share(w, c["expert_first"], 4).items()}
        y, _ = moe.moe_ffn(x[None], p, arch_config(c))
        port_parts.append(y[0])
    assert _rel(sum(port_parts) - shared, whole) < 1e-5
    for got, want in zip(port_parts, ref_parts):
        assert _rel(got, want) < 1e-5


def test_the_reference_given_its_own_choices_is_unchanged():
    flat = program_config(small_config())
    w = _share(_layer_weights(flat), 0, 4)
    x = torch.randn(48, SMALL["d_model"],
                    generator=torch.Generator().manual_seed(9))
    with ref.strict_fp32():
        want = ref.moe(x, w, flat)
        taken = Taken()
        assert torch.equal(ref.moe(x, w, flat, pick=taken), want)
        fed = Fed(taken.ids)
        assert torch.equal(ref.moe(x, w, flat, pick=fed), want)
        # its own choices lie 0 below its own top K
        assert float(fed.gaps[0].max()) == 0.0
        moved = Fed([(taken.ids[0] + 1) % 8])
        other = ref.moe(x, w, flat, pick=moved)
    assert _rel(other, want) > 1e-2
    assert float(moved.gaps[0].mean()) > 0.1


def test_ids_that_do_not_fit_read_nan():
    probs = torch.softmax(torch.randn(6, 8), -1)
    fed = Fed([torch.zeros(1, 3, 2, dtype=torch.long)])
    assert torch.equal(fed(probs, 2), ref.top_ids(probs, 2))
    assert fed.gaps[0].isnan().all()


# -- the harness module, the count and the metric ----------------------------------
def test_set_up_refuses_a_key_the_program_lacks():
    config = small_config(no_such_field=1)
    with pytest.raises(ValueError, match="no field no_such_field"):
        program_config(config)
    cell = dataclasses.replace(small_cell(), config=config)
    from harness.prefill_layer_types import Run
    with pytest.raises(ValueError, match="no field no_such_field"):
        Run(cell, 1, torch.device("cpu"))


def test_prefill_flops_by_hand():
    from counts import layer_types as count

    c = program_config(small_config())
    d, di, n, h, K = 64, 128, 16, 8, 4
    mamba = d * (2 * di + 2 * n + h) + K * (di + 2 * n) + di * d
    attn = d * 4 * 16 + 2 * d * 2 * 16 + 4 * 16 * d
    # router over 8, the shared expert (1 x 32), 2 x 4/8 routed experts
    experts = d * 8 + (1 + 2 * 4 / 8) * 3 * d * 32
    assert count.layer_matmul_params(c) == 5 * mamba + attn + 6 * experts
    B, S = 2, 32
    pairs = S * (S + 1) // 2
    assert count.attention_flops(c, B, S) == B * 4 * pairs * 4 * 16
    assert count.prefill_flops(c, B, S) == (
        2 * B * S * (5 * mamba + attn + 6 * experts)
        + B * 4 * pairs * 4 * 16 + 2 * B * d * 256)


def _mfu_reader():
    return manifest.metric_reader(manifest.load_cell(CELL),
                                  "mfu_layer_types.prefill")


def test_mfu_reads_none_without_a_window_of_this_traffic_kind():
    from counts import PEAKS
    from counts.layer_types import prefill_flops

    read = _mfu_reader()
    config = manifest.load_cell(CELL).config
    window = types.SimpleNamespace(steps=[(4, 4096), (1, 16384)],
                                   seconds=2.0)

    def run(kind, w):
        return types.SimpleNamespace(
            cell=types.SimpleNamespace(driver=kind), window=w,
            config=config)

    assert read(run("prefill_closed", window)) is None
    assert read(run("prefill_layer_types", None)) is None
    flops = sum(prefill_flops(config["arch_config"], B, L)
                for B, L in window.steps)
    assert read(run("prefill_layer_types", window)) == pytest.approx(
        100 * flops / 2.0 / PEAKS["bf16"])


def test_idle_share_reads_none_but_in_a_run_of_this_traffic_kind():
    read = manifest.metric_reader(manifest.load_cell(CELL),
                                  "device_idle_layer_types.prefill")
    window = types.SimpleNamespace(steps=[(4, 4096), (1, 16384)],
                                   step_s=[1.0, 3.0])
    trace = types.SimpleNamespace(steps=[(4, 4096), (1, 16384)],
                                  busy_s=3.6)

    def run(kind, t):
        return types.SimpleNamespace(
            cell=types.SimpleNamespace(driver=kind), trace=t, window=window)

    assert read(run("prefill_closed", trace)) is None
    assert read(run("prefill_layer_types", None)) is None
    # 3.6 s busy of the 4.0 s the two shapes take untraced
    assert read(run("prefill_layer_types", trace)) == pytest.approx(10.0)


_PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
import harness.prefill_layer_types, reference.layer_types
import counts.layer_types
from harness import manifest
c = manifest.load_cell({cell!r})
for m in c.per_layer:
    manifest.metric_reader(c, m.name)
import repro_torch.launch.steps
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_harness_module_and_reference_load_no_jax_and_no_repro():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(bench=str(BENCH),
                                             src=str(ROOT / "src"),
                                             cell=CELL)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


# -- a whole run ------------------------------------------------------------------
def _run(seed=2**35 + 17):
    return cli.run_cell(small_cell(), seed, 0.5, False, "cpu", time.time())


def test_a_sound_run_is_correct():
    out = _run()
    assert out.result["correct"], out.checks
    assert out.result["attempted"] > 0 and out.result["failed"] == 0


@pytest.mark.parametrize("fault", ["token", "unchanged_state", "routes",
                                   "half_batch"])
def test_a_broken_run_is_not_correct(fault):
    import prefill_faults

    with prefill_faults.planted(fault):
        out = _run()
    assert not out.result["correct"], out.checks
