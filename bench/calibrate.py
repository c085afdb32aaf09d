"""Readings that the limits of a cell's output check are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--fault NAME] [--seconds 4] [--out FILE]

For each seed, in one process: the cell's program set up as a run sets it
up, a short window at the cell's own load (long enough for every length of
the mix; a training cell's checked steps are its set-up), then the check's
numbers of the program's outputs, the lower readings.  On the first
``--control-seeds`` seeds it also reads the control, the reference in
float8 put in the program's place, on the same inputs: the upper readings.
``--fault`` plants one fault in the program instead (:data:`FAULTS`) and
reads the program.  The readings go to standard output, one JSON line a
seed, and to ``--out``.

The benchmark's runs never call this; it needs a CUDA device, as they do.
"""
import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    """``module.attr`` replaced by ``make(real)`` for the duration."""
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def half_batch():
    """The training step's loss and gradients taken over the first half of
    the batch's rows (the mean over the rest)."""
    def make(real):
        def fault(model, cfg, batch, *a, **kw):
            n = next(iter(batch.values())).shape[0] // 2
            return real(model, cfg, {k: v[:n] for k, v in batch.items()},
                        *a, **kw)
        return fault
    return patched("repro_torch.launch.steps", "grads_of", make)


def attn_dq_doubled():
    """Attention's backward returns twice the queries' gradient."""
    def make(real):
        def fault(*a, **kw):
            dq, *rest = real(*a, **kw)
            return (2 * dq, *rest)
        return fault
    return patched("repro_torch.kernels.flash_attention",
                   "flash_attention_backward", make)


def ssd_bwd_negated():
    """The SSD intra-chunk step's backward returns its gradients negated."""
    def make(real):
        def fault(*a, **kw):
            return tuple(None if g is None else -g for g in real(*a, **kw))
        return fault
    return patched("repro_torch.kernels.ssd", "ssd_intra_chunk_backward",
                   make)


FAULTS = {"half_batch": half_batch, "attn_dq_doubled": attn_dq_doubled,
          "ssd_bwd_negated": ssd_bwd_negated}


def readings(cell, seed: int, seconds: float, control: bool, device):
    """One seed's readings: the program's numbers and, with ``control``,
    the control's, with the run's ``detail`` where it has one."""
    import torch

    driver = importlib.import_module(f"harness.{cell.driver}")
    t = time.time()
    run = driver.Run(cell, seed, device)
    run.window(seconds)
    out = {"seed": seed, "program": run.check()}
    if getattr(run, "detail", None):
        out["detail"] = dict(run.detail)
    if control:
        out["control"] = run.check(quant="fp8")
        if getattr(run, "detail", None):
            out["control_detail"] = dict(run.detail)
    out["seconds"] = round(time.time() - t, 3)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch
    from harness import manifest

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    planted = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
    rows = []
    with planted:
        for i, seed in enumerate(args.seeds):
            row = readings(cell, seed, args.seconds, i < args.control_seeds,
                           dev)
            row["fault"] = args.fault
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
