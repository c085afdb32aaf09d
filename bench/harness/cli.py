"""One run of one cell: set-up, window, optional trace, check, result line.

:func:`run_cell` drives any traffic kind through its module
(``harness.<driver>``), which gives a ``Run(cell, seed, device)`` with
``window(seconds)``, ``trace(sync)`` and ``check()``.  :func:`main` adds
what only a run on the card does: it refuses to run without enough CUDA
devices, refuses to print a result if ``jax`` or the JAX package was
loaded, and prints the result line.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time

import torch

from . import checks as judge
from . import manifest

#: Top-level module names a run of the port must not have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Outcome:
    result: dict
    checks: list
    numbers: dict


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's ``read(run)`` sees."""
    cell: manifest.Cell
    window: object
    trace: object

    @property
    def config(self) -> dict:
        return self.cell.config


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def _number(v: float):
    return v if math.isfinite(v) else str(v)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float) -> Outcome:
    device = torch.device(device)
    driver = importlib.import_module(f"harness.{cell.driver}")
    run = driver.Run(cell, seed, device)
    _sync(device)
    setup_s = time.time() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t = time.time()
    found = run.trace(lambda: _sync(device)) if traced else None
    t_trace = time.time() - t
    numbers = run.check()
    checks = judge.against(numbers, cell.limits)
    _sync(device)
    print(f"phases: set-up {setup_s:.3f} s, window {window.seconds:.3f} s "
          f"({len(window.steps)} steps), trace {t_trace:.3f} s, check "
          f"{time.time() - t - t_trace:.3f} s", file=sys.stderr)
    view = RunView(cell, window, found)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = manifest.metric_reader(cell, m.name)(view)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        values = dict(window.end_to_end(), setup_s=setup_s)
        metrics = {m.name: {"value": float(values[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks) and window.failed == 0,
              "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=found.busy_s, window_s=found.window_s)
        result["breakdown"] = {"device_ops": found.device_ops,
                               "idle_gaps": found.idle_gaps}
    return Outcome(result, checks, numbers)


def main(args, t0: float) -> int:
    cell = manifest.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    card = power_limit()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out.result["card"] = card
    out.result["checks"] = {c.name: {"value": _number(c.value),
                                     "limit": c.limit} for c in out.checks}
    print(f"card: {card}", file=sys.stderr)
    for name, v in out.numbers.items():
        if name not in cell.limits:
            print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0
