"""The reference's first training steps: the loss, autograd gradients and
AdamW, in float32.

The loss is next-token cross-entropy over every position but each row's
last, averaged, through the layers of :mod:`reference.model` (each
recomputed in the backward pass, which changes no number).  The update is
AdamW with global-norm clipping, a linear warm-up and cosine decay, the
weight decay on every leaf; each leaf is then stored in its configured
dtype (bf16 matrices, float32 norms and SSM scalars), which is where the
next step reads it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .model import fake_fp8, layer, mm, rmsnorm, stack, strict_fp32

LOSS_CHUNK = 512


def _xent(x, head, scale, eps, targets, quant):
    logits = mm(rmsnorm(x, scale, eps), head, quant)
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(-1, targets[..., None])[..., 0]).sum()


def lm_loss(params: dict, c: dict, tokens, quant=None):
    """Mean next-token cross-entropy of ``tokens`` [B, S] (the last
    position of each row has no target)."""
    if c.get("n_experts"):
        raise NotImplementedError("the reference trains dense and hybrid "
                                  "layers only")
    eps = c.get("norm_eps", 1e-6)
    tokens = tokens.long()
    table = params["embed"]
    x = (fake_fp8(table) if quant == "fp8" else table)[tokens]
    for prefix, kind in stack(c):
        w = {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}
        x = checkpoint(lambda x, w, kind=kind: layer(x, w, c, kind, quant)[0],
                       x, w, use_reentrant=False)
    head = params["embed"].T if c.get("tie_embeddings") else params["lm_head"]
    scale = params["final_norm.scale"]
    B, S = tokens.shape
    total = x.new_zeros(())
    for s0 in range(0, S - 1, LOSS_CHUNK):
        s1 = min(S - 1, s0 + LOSS_CHUNK)
        total = total + checkpoint(_xent, x[:, s0:s1], head, scale, eps,
                                   tokens[:, s0 + 1:s1 + 1], quant,
                                   use_reentrant=False)
    return total / (B * (S - 1))


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = (step - opt["warmup_steps"]) / max(
        opt["total_steps"] - opt["warmup_steps"], 1)
    t = min(max(t, 0.0), 1.0)
    f = opt["min_lr_frac"]
    return opt["lr"] * warm * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * t)))


def first_steps(weights: dict, c: dict, batches, opt: dict, quant=None,
                sample: dict | None = None, against: dict | None = None):
    """The reference's steps on ``batches`` from ``weights`` (not
    written): {"loss": each step's, "grad": the first step's clipped
    gradient's norm by leaf, "change": each leaf's change over the
    steps}.  With ``sample`` (flat indices by leaf) also "grad_sample",
    that gradient's entries there, and with ``against`` (entries at the
    same places) "grad_diff", the norm of their difference from it,
    scaled to the whole leaf (times the square root of the leaf's size
    over the sample's).  Under ``quant="fp8"`` the bf16 leaves are held in
    float8 (rounded at the start and after each update) and the change is
    counted from that start."""
    names = sorted(weights)

    def store(n, p):
        if quant == "fp8" and weights[n].dtype == torch.bfloat16:
            return fake_fp8(p.float())
        return p.to(weights[n].dtype)

    start = {n: store(n, weights[n]) for n in names}
    stored = dict(start)
    m = {n: torch.zeros_like(w, dtype=torch.float32) for n, w in
         weights.items()}
    v = {n: torch.zeros_like(w, dtype=torch.float32) for n, w in
         weights.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    out = {"loss": []}
    with strict_fp32():
        for step, toks in enumerate(batches, 1):
            params = {n: stored[n].float().requires_grad_() for n in names}
            loss = lm_loss(params, c, toks, quant)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(opt["grad_clip"] / (gn + 1e-12), max=1.0)
                lr = lr_at(opt, step)
                if step == 1:
                    out["grad"] = dict(zip(names, (torch.stack(
                        [torch.linalg.vector_norm(g) for g in grads])
                        * scale).tolist()))
                    diff, kept = [], {}
                for n, g in zip(names, grads):
                    p = params[n].detach()
                    g = g * scale
                    if step == 1 and sample is not None:
                        idx = sample[n].to(g.device)
                        kept[n] = g.flatten()[idx]
                    if step == 1 and against is not None:
                        diff.append(torch.linalg.vector_norm(
                            kept[n] - against[n].to(g.device, torch.float32))
                            * math.sqrt(g.numel() / idx.numel()))
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    delta = (m[n] / (1 - b1 ** step)) / (
                        torch.sqrt(v[n] / (1 - b2 ** step)) + opt["eps"]) \
                        + opt["weight_decay"] * p
                    stored[n] = store(n, p - lr * delta)
                if step == 1 and against is not None:
                    out["grad_diff"] = dict(zip(names,
                                                torch.stack(diff).tolist()))
                if step == 1 and sample is not None:
                    out["grad_sample"] = kept
            del params, grads, loss
    with torch.no_grad():
        out["change"] = dict(zip(names, torch.stack(
            [torch.linalg.vector_norm(stored[n].float() - start[n].float())
             for n in names]).tolist()))
    return out
