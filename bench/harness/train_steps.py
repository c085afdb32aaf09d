"""Training steps through ``make_train_step``.

Set-up builds one training step with its model and optimizer state and
drives it from the seed through its first ``check_steps`` steps, which warm
every shape; the window then runs on with the same objects.  Every step
draws its rows on the device, uniformly over the vocabulary (the targets
are the next tokens), and reads its loss on the host.

What the check compares is read from those first steps: each step's loss,
the first clipped gradient as the optimizer got it (AdamW's first moment
after one step, ``m / (1 - beta1)``: each leaf's norm, and its entries at
:data:`GRAD_SAMPLE` places drawn from the seed), and each leaf's change
over the steps.  After the window, with the program's state freed, the
reference (:mod:`reference.train`) follows the same steps from the same
weights and rows.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from reference import train as ref_train

from . import checks, trace, traffic
from .weights import arch_config, build_model, leaf_specs, make_weights


@dataclasses.dataclass
class Window:
    seconds: float
    steps: list            # (rows, seq) of every step
    step_s: list           # each step's wall time
    attempted: int
    failed: int

    def end_to_end(self) -> dict:
        tokens = sum(B * S for B, S in self.steps)
        return {"train_tokens_per_s": tokens / self.seconds}


#: Entries of each leaf's first gradient that the check compares (every
#: entry of a smaller leaf).
GRAD_SAMPLE = 1 << 15


def grad_sample(specs, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """For each leaf of ``specs``, the flat indices (on the host) of the
    gradient entries the check compares: all of a leaf of at most
    :data:`GRAD_SAMPLE` entries, else that many drawn uniformly with
    replacement by ``gen``."""
    out = {}
    for name, shape, _ in specs:
        n = math.prod(shape)
        out[name] = torch.arange(n) if n <= GRAD_SAMPLE else torch.randint(
            n, (GRAD_SAMPLE,), generator=gen, device=gen.device).cpu()
    return out


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict[str, float]:
    """The float32 L2 norm of each tensor times ``scale``, read at once."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).cpu() * scale
    return dict(zip(names, norms.tolist()))


class Run:
    """The program's training step set up for one cell and seed, driven
    through its first steps."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        from repro_torch.launch.steps import make_train_step
        from repro_torch.train.optim import AdamWConfig, init_opt_state

        t = cell.traffic
        self.cfg = arch_config(cell.config)
        self.specs = leaf_specs(self.cfg)
        weights = self._weights()
        self.model = build_model(self.cfg, weights)
        self.opt_cfg = AdamWConfig(**t["optimizer"])
        self.step_fn = make_train_step(self.cfg, self.opt_cfg,
                                       remat=t["remat"],
                                       microbatches=t["microbatches"],
                                       device=self.dev)
        self.opt = init_opt_state(self.model)
        self.gen = self._generator("tokens")
        self.sample = grad_sample(self.specs, self._generator("grad"))
        self.first = self._first_steps(weights, t["check_steps"])
        self.ref = None
        self.detail: dict = {}

    def _weights(self) -> dict:
        """The initial weights from the seed, each residual branch's last
        projection narrowed by the mix's ``init_residual_scale``."""
        scale = self.cell.traffic.get("init_residual_scale", 1.0)
        return make_weights(self.specs, self.seed, self.dev, scale)

    def _generator(self, stream: str) -> torch.Generator:
        word = int(traffic.rng(self.seed, stream).integers(1 << 62))
        return torch.Generator(device=self.dev).manual_seed(word)

    def _step(self, gen):
        t = self.cell.traffic
        toks = torch.randint(0, self.cfg.vocab_size, (t["rows"], t["seq"]),
                             generator=gen, device=self.dev,
                             dtype=torch.int32)
        self.model, self.opt, metrics = self.step_fn(self.model, self.opt,
                                                     {"tokens": toks})
        return toks, float(metrics["loss"])

    def _first_steps(self, weights: dict, n: int) -> dict:
        start = {k: w.detach().clone() for k, w in weights.items()}
        first = {"tokens": [], "loss": []}
        for i in range(n):
            toks, loss = self._step(self.gen)
            first["tokens"].append(toks)
            first["loss"].append(loss)
            if i == 0:
                scale = 1.0 / (1.0 - self.opt_cfg.beta1)
                first["grad"] = leaf_norms(self.opt["m"], scale)
                first["grad_sample"] = {
                    k: (m.flatten()[self.sample[k].to(m.device)]
                        * scale).cpu() for k, m in self.opt["m"].items()}
        first["change"] = leaf_norms(
            {k: w.detach().float() - start[k].float()
             for k, w in weights.items()})
        return first

    def window(self, seconds: float) -> Window:
        t = self.cell.traffic
        steps, step_s, failed = [], [], 0
        start = last = time.perf_counter()
        end = start + seconds
        while True:
            _, loss = self._step(self.gen)
            done = time.perf_counter()
            steps.append((t["rows"], t["seq"]))
            step_s.append(done - last)
            last = done
            failed += not math.isfinite(loss)
            if done >= end:
                break
        return Window(done - start, steps, step_s, len(steps), failed)

    def trace(self, sync) -> trace.Trace:
        """``trace_steps`` more steps, profiled (after as many under the
        profiler's warm-up)."""
        t = self.cell.traffic
        gen = self._generator("trace")

        def run_steps():
            for _ in range(t["trace_steps"]):
                self._step(gen)
            return [(t["rows"], t["seq"])] * t["trace_steps"]

        return trace.profile_stretch(run_steps, sync)

    def free(self) -> None:
        self.model = self.opt = self.step_fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, quant=None) -> dict:
        """The check's numbers of the first steps, the program freed
        first: of the program's, or with ``quant`` of the reference
        computed in that precision put in the program's place (the
        control).  The weights are made again from the seed, and the
        float32 reference runs once.  ``detail`` gets the five worst
        leaves of each by-leaf number, and the losses."""
        self.free()
        t = self.cell.traffic
        if self.ref is None:
            self.ref = ref_train.first_steps(
                self._weights(), self.cell.config, self.first["tokens"],
                t["optimizer"], sample=self.sample,
                against=self.first["grad_sample"])
        ref = self.ref
        if quant is None:
            got = dict(self.first, grad_diff=ref["grad_diff"])
        else:
            got = ref_train.first_steps(
                self._weights(), self.cell.config, self.first["tokens"],
                t["optimizer"], quant, sample=self.sample,
                against=ref["grad_sample"])
        for key, gaps in checks.train_leaves(got, ref).items():
            self.detail[key] = sorted(((round(v, 5), n)
                                       for n, v in gaps.items()),
                                      reverse=True)[:5]
        self.detail["loss"] = (got["loss"], ref["loss"])
        return checks.train_numbers(got, ref)
