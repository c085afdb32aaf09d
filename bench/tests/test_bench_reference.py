"""The plain references against the port's CPU path on the smoke configs,
both in float32: prefill's logits and cache, the loss and every gradient
leaf, and three AdamW steps."""
import pytest
import torch

from conftest import smoke_cell
from harness import checks
from harness.weights import arch_config, build_model, leaf_specs, make_weights
from reference import prefill as ref_prefill
from reference import train as ref_train

TOL = 1e-4


def _port_f32(cell, seed=3):
    cfg = arch_config(cell.config)
    w = make_weights(leaf_specs(cfg), seed, torch.device("cpu"))
    w32 = {n: t.float() for n, t in w.items()}
    return cfg, w32, build_model(cfg, w32)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("name", ["hymba-1.5b.prefill-long",
                                  "deepseek-moe-16b.prefill-chat"])
def test_prefill_reference_matches_the_port_in_float32(name):
    from harness.prefill_closed import cache_row
    from repro_torch.launch.steps import make_prefill_step

    cell = smoke_cell(name)
    cfg, w32, model = _port_f32(cell)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(cfg, 40, device="cpu")(
        model, {"tokens": toks})
    (rlogits, rcache), = ref_prefill.forward(w32, cell.config, [(toks, 1)])
    assert _rel(logits, rlogits) < TOL
    row = cache_row(cache, 1)
    assert set(row) == set(rcache)
    for key, want in rcache.items():
        assert checks._rel(row[key], want) < TOL, key


def test_loss_and_gradients_match_the_port_in_float32():
    from repro_torch.launch.steps import grads_of

    cell = smoke_cell("hymba-1.5b.train-4k")
    cfg, w32, model = _port_f32(cell)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(2))
    loss, _, grads = grads_of(model.trainable(), cfg, {"tokens": toks},
                              device="cpu")
    params = {n: t.clone().requires_grad_() for n, t in w32.items()}
    rloss = ref_train.lm_loss(params, cell.config, toks)
    names = sorted(params)
    rgrads = torch.autograd.grad(rloss, [params[n] for n in names])
    rloss = float(rloss.detach())
    assert abs(float(loss) - rloss) / rloss < 1e-5
    for n, g in zip(names, rgrads):
        assert _rel(grads[n], g) < TOL, n


def test_three_adamw_steps_match_the_port_in_float32():
    from harness.train_steps import leaf_norms
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optim import AdamWConfig, init_opt_state

    cell = smoke_cell("hymba-1.5b.train-4k")
    cfg, w32, model = _port_f32(cell)
    start = {n: t.clone() for n, t in w32.items()}
    opt = cell.traffic["optimizer"]
    step = make_train_step(cfg, AdamWConfig(**opt), device="cpu")
    state = init_opt_state(model)
    gen = torch.Generator().manual_seed(4)
    batches = [torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
               for _ in range(3)]
    loss, grad = [], None
    for i, toks in enumerate(batches):
        model, state, m = step(model, state, {"tokens": toks})
        loss.append(float(m["loss"]))
        if i == 0:
            grad = leaf_norms(state["m"], 1 / (1 - opt["beta1"]))
            full = {n: m.flatten() / (1 - opt["beta1"])
                    for n, m in state["m"].items()}
    change = leaf_norms({n: w32[n] - start[n] for n in w32})
    every = {n: torch.arange(t.numel()) for n, t in start.items()}
    ref = ref_train.first_steps(start, cell.config, batches, opt,
                                sample=every, against=full)
    nums = checks.train_numbers({"loss": loss, "grad": grad,
                                 "grad_diff": ref["grad_diff"],
                                 "change": change}, ref)
    assert nums["loss_rel"] < 1e-5
    assert nums["grad_gap"] < TOL
    assert nums["grad_rel"] < TOL
    assert nums["change_gap"] < 1e-3
