"""Weights made from the seed: the same seed gives the same tensors, the
port's recipe for constants, and a scaled initialisation narrows only the
residual branches' last projections."""
import math

import torch

from conftest import smoke_cell
from harness.weights import (RESIDUAL_OUT, arch_config, build_model,
                             leaf_specs, make_weights)

CPU = torch.device("cpu")


def _specs():
    return leaf_specs(arch_config(smoke_cell("hymba-1.5b.train-4k").config))


def test_same_seed_same_weights_other_seed_other_weights():
    a = make_weights(_specs(), 2**40 + 1, CPU)
    b = make_weights(_specs(), 2**40 + 1, CPU)
    c = make_weights(_specs(), 2**40 + 2, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])


def test_constants_and_dtypes_follow_the_port():
    w = make_weights(_specs(), 5, CPU)
    assert torch.all(w["layers.0.ln1.scale"] == 1)
    assert torch.all(w["layers.1.ssm.D"] == 1)
    assert torch.all(w["layers.0.ssm.dt_bias"] == 0)
    assert torch.all(w["layers.0.ssm.conv_b"] == 0)
    h = w["layers.0.ssm.A_log"].shape[0]
    assert torch.allclose(w["layers.0.ssm.A_log"],
                          torch.log(torch.linspace(1.0, 16.0, h)))
    assert w["layers.0.attn.wq"].dtype == torch.bfloat16
    assert w["layers.0.ssm.A_log"].dtype == torch.float32


def test_residual_scale_narrows_the_last_projections_only():
    plain = make_weights(_specs(), 9, CPU)
    scaled = make_weights(_specs(), 9, CPU, residual_scale=0.25)
    for name, t in plain.items():
        if t.dtype != torch.bfloat16 or t.dim() < 2:
            continue
        ratio = float(scaled[name].float().std() / t.float().std())
        want = 0.25 if name.endswith(RESIDUAL_OUT) else 1.0
        assert math.isclose(ratio, want, rel_tol=0.3), (name, ratio)


def test_the_model_holds_the_weights_themselves():
    cell = smoke_cell("hymba-1.5b.train-4k")
    w = make_weights(_specs(), 3, CPU)
    model = build_model(arch_config(cell.config), w)
    p = dict(model.named_parameters())["layers.0.attn.wq"]
    assert p.data_ptr() == w["layers.0.attn.wq"].data_ptr()
