"""Training loop: the train step, checkpoint and resume, and the straggler
watchdog (counterpart of ``repro.train.trainer``).

* A checkpoint every ``ckpt_every`` steps, written asynchronously, and a
  last one when the run ends; on (re)start the trainer resumes from the
  latest complete checkpoint, and a crashed run replays identically
  because the data pipeline is a pure function of (seed, step).
* The straggler watchdog compares each step's wall time against an SLA,
  either a modeled step time (``sla_seconds``) or the median of the last
  20 steps once 5 have run, times ``sla_tolerance``, and records the
  offenders.

Each step ends with a device sync, so its wall time is the step's; the
loss and grad norm are read on the host only for the history's rows.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, latest_step
from repro_torch.device import resolve_device
from repro_torch.nn.config import ArchConfig
from repro_torch.nn.model import (init_params, named_from_tree,
                                  params_to_numpy)
from .optim import (AdamWConfig, init_opt_state, opt_state_from_numpy,
                    opt_state_to_numpy)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    sla_seconds: float | None = None   # modeled step time (perf model)
    sla_tolerance: float = 3.0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig,
                 opt_cfg: AdamWConfig | None = None,
                 step_hook: Callable[[int], None] | None = None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.step_hook = step_hook       # test hook (e.g. straggler injection)
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        # lazy import: launch.steps imports repro_torch.train.optim
        from repro_torch.launch.steps import make_train_step
        self._step_fn = make_train_step(cfg, self.opt_cfg,
                                        microbatches=tcfg.microbatches,
                                        device=self.device)
        self.stragglers: list[tuple[int, float]] = []
        self.history: list[dict[str, float]] = []

    # ------------------------------------------------------------------ run --
    def init_state(self):
        model = init_params(self.cfg, self.tcfg.seed, device=self.device)
        return model, init_opt_state(model)

    @staticmethod
    def _tree(model, opt_state) -> dict:
        """The checkpointed tree, in the reference's layout."""
        return {"params": params_to_numpy(model),
                "opt": opt_state_to_numpy(opt_state)}

    def _restore(self, model, opt_state):
        """(step, model, opt_state) from the latest checkpoint, the
        parameters copied into ``model`` in place (their dtypes kept), or
        (0, model, opt_state) when there is none."""
        self.ckpt.wait()
        if latest_step(self.tcfg.ckpt_dir) is None:
            return 0, model, opt_state
        step, tree = self.ckpt.restore_latest(self._tree(model, opt_state))
        names = [name for name, _ in model.named_parameters()]
        with torch.no_grad():
            for name, a in named_from_tree(tree["params"], names).items():
                model.get_parameter(name).copy_(torch.from_numpy(a))
        return step, model, opt_state_from_numpy(tree["opt"], model,
                                                 device=self.device)

    def run(self, data_iter, params=None, opt_state=None) -> dict[str, Any]:
        if params is None:
            params, opt_state = self.init_state()
        start, params, opt_state = self._restore(params, opt_state)

        times: list[float] = []
        it = None if hasattr(data_iter, "batch_at") else iter(data_iter)
        for step in range(start, self.tcfg.steps):
            batch = next(it) if it is not None else data_iter.batch_at(step)
            t0 = time.perf_counter()
            if self.step_hook:
                self.step_hook(step)
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            times.append(dt)
            self._watchdog(step, dt, times)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                self.history.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]), "sec": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self._tree(params, opt_state))
        self.ckpt.save(self.tcfg.steps, self._tree(params, opt_state),
                       wait=True)
        return {"params": params, "opt_state": opt_state,
                "history": self.history, "stragglers": self.stragglers}

    # ------------------------------------------------------------- watchdog --
    def _watchdog(self, step: int, dt: float, times: list[float]):
        sla = self.tcfg.sla_seconds
        if sla is None and len(times) >= 5:
            sla = float(np.median(times[-20:]))
        if sla is not None and dt > self.tcfg.sla_tolerance * sla:
            self.stragglers.append((step, dt))
