"""AdamW with float32 moments over bf16 parameters and a cosine learning
rate schedule (counterpart of ``repro.train.optim``).

The optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 tensor}``, the moments keyed by the :class:`Model`'s
parameter names and lying on its device.  :func:`adamw_update` updates the
parameters and moments in place, with the reference's operations in the
reference's order, so each element rounds as it does there; only the global
norm sums its leaves in another order (the port's leaves are per layer).
:func:`opt_state_to_numpy` and :func:`opt_state_from_numpy` carry the
reference's ``{"m", "v", "step"}`` tree (layers stacked on axis 0) across.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.model import Model, named_from_tree, named_to_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``, in
    float32 at ``step`` (a tensor)."""
    step = step.float()
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(model: Model) -> dict:
    """Zero float32 moments for every parameter, step 0, on the model's
    device."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in model.named_parameters()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def global_norm(grads: dict) -> torch.Tensor:
    """The float32 L2 norm over every gradient leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(model: Model, grads: dict, state: dict,
                 cfg: AdamWConfig) -> tuple[Model, dict, dict]:
    """One AdamW step with global-norm clipping on ``grads`` (keyed by
    parameter name), in place: each parameter becomes ``(p32 - lr *
    delta)`` rounded to its dtype, the moments and step are updated.
    Returns (model, state, {"grad_norm", "lr"}), the metrics 0-d float32
    tensors on the model's device."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = (cfg.grad_clip / (gn + 1e-12)).clamp(max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in model.named_parameters():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return model, state, {"grad_norm": gn, "lr": lr}


def opt_state_to_numpy(state: dict) -> dict:
    """The optimizer state as the reference's tree: ``{"m", "v"}`` numpy
    float32 trees with the layers stacked on axis 0, ``"step"`` an int32
    scalar."""
    def tree(moments):
        return named_to_tree({name: t.detach().cpu().numpy()
                              for name, t in moments.items()})
    return {"m": tree(state["m"]), "v": tree(state["v"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def opt_state_from_numpy(tree: dict, model: Model, device=None) -> dict:
    """The reference's optimizer tree (``{"m", "v", "step"}``, layers
    stacked on axis 0) as the port's state for ``model``, on ``device``."""
    dev = resolve_device(device)
    names = [name for name, _ in model.named_parameters()]

    def moments(t):
        return {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                for name, a in named_from_tree(t, names).items()}
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}
