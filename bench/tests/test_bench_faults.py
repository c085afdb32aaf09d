"""A whole run on the CPU at smoke size, the chip's look skipped, with the
timed path broken underneath: ``correct`` comes out false for each fault
the cell can have, and true with none.  (No cell runs across chips, so
none can leave out an exchange between them.)"""
import time

import pytest
import torch

from conftest import smoke_cell
from harness import cli

PREFILL = ("hymba-1.5b.prefill-long", "deepseek-moe-16b.prefill-chat",
           "hymba-1.5b.prefill-short")


def _run(name, seed=2**35 + 17):
    return cli.run_cell(smoke_cell(name), seed, 0.5, False, "cpu",
                        time.time())


def _break_prefill(monkeypatch, fault):
    from repro_torch.launch import steps

    real = steps.make_prefill_step

    def make(cfg, max_seq=None, device=None):
        step = real(cfg, max_seq, device)

        def broken(params, batch):
            toks = batch["tokens"]
            if fault == "half_batch":
                half = toks.shape[0] // 2
                logits, cache = step(params, {"tokens": toks[:half]})
                logits = torch.cat([logits, logits])
                cache = {g: {k: torch.cat([v, v], dim=1)
                             for k, v in leaves.items()}
                         for g, leaves in cache.items()}
                return logits, cache
            logits, cache = step(params, batch)
            if fault == "token":
                logits = logits.roll(1, dims=-1)
            elif fault == "unchanged_state":
                cache = {g: {k: torch.zeros_like(v) for k, v in
                             leaves.items()} for g, leaves in cache.items()}
            return logits, cache

        return broken

    monkeypatch.setattr(steps, "make_prefill_step", make)


@pytest.mark.parametrize("name", PREFILL)
def test_sound_prefill_is_correct(name):
    out = _run(name)
    assert out.result["correct"], out.checks


@pytest.mark.parametrize("name", PREFILL)
@pytest.mark.parametrize("fault", ["token", "half_batch", "unchanged_state"])
def test_broken_prefill_is_not_correct(monkeypatch, name, fault):
    _break_prefill(monkeypatch, fault)
    out = _run(name)
    assert not out.result["correct"], out.checks


def test_sound_training_is_correct():
    out = _run("hymba-1.5b.train-4k")
    assert out.result["correct"], out.checks


def test_training_step_that_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.launch import steps

    def frozen(model, grads, state, cfg):
        zero = torch.zeros((), device=model.device)
        return model, state, {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(steps, "adamw_update", frozen)
    out = _run("hymba-1.5b.train-4k")
    assert not out.result["correct"], out.checks


def test_training_on_half_the_batch():
    from calibrate import half_batch

    with half_batch():
        out = _run("hymba-1.5b.train-4k")
    assert not out.result["correct"], out.checks


def test_training_with_the_ssd_backward_negated():
    from calibrate import ssd_bwd_negated

    with ssd_bwd_negated():
        out = _run("hymba-1.5b.train-4k")
    assert not out.result["correct"], out.checks


def test_training_update_applied_twice(monkeypatch):
    from repro_torch.launch import steps

    real = steps.adamw_update

    def twice(model, grads, state, cfg):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        model, state, metrics = real(model, grads, state, cfg)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.add_(p - before[n])
        return model, state, metrics

    monkeypatch.setattr(steps, "adamw_update", twice)
    out = _run("hymba-1.5b.train-4k")
    assert not out.result["correct"], out.checks
