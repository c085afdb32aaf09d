"""Readings of a prefill cell with one fault planted in the program's
prefill step, the upper readings its limits are set against beside the
control's (``calibrate.py``):

- ``token``: the logits rolled by one along the vocabulary, so the token
  served is the next one;
- ``half_batch``: the second half of a step's prompts answered with the
  first half's logits and cache (a step of one prompt unchanged);
- ``unchanged_state``: a cache of zeros;
- ``routes``: each token sent to the experts after the ones the router
  chose (``nn.moe.route``'s ids plus one, modulo the router's experts).

    python3 bench/prefill_faults.py --workload <cell> --fault NAME \\
        --seeds 11 12 ... [--seconds 15]

One JSON line a seed on standard output, as ``calibrate.py`` prints them.
It needs a CUDA device; the benchmark's runs never call it.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import calibrate  # noqa: E402

FAULTS = ("token", "half_batch", "unchanged_state", "routes")


def planted(fault: str):
    """``make_prefill_step`` (or, for ``routes``, ``nn.moe.route``) broken
    by ``fault`` for the duration."""
    import torch

    if fault == "routes":
        def moved(real):
            def route(xf, router, cfg):
                gates, idx, prob_sum, hits = real(xf, router, cfg)
                return (gates, (idx + 1) % cfg.n_router_experts, prob_sum,
                        hits)
            return route
        return calibrate.patched("repro_torch.nn.moe", "route", moved)

    def make(real):
        def wrapped(cfg, max_seq=None, device=None):
            step = real(cfg, max_seq, device)

            def broken(params, batch):
                toks = batch["tokens"]
                if fault == "half_batch" and toks.shape[0] > 1:
                    half = toks.shape[0] // 2
                    logits, cache = step(params, {"tokens": toks[:half]})
                    return torch.cat([logits, logits]), {
                        g: {k: torch.cat([v, v], dim=1)
                            for k, v in leaves.items()}
                        for g, leaves in cache.items()}
                logits, cache = step(params, batch)
                if fault == "token":
                    logits = logits.roll(1, dims=-1)
                elif fault == "unchanged_state":
                    cache = {g: {k: torch.zeros_like(v)
                                 for k, v in leaves.items()}
                             for g, leaves in cache.items()}
                return logits, cache
            return broken
        return wrapped
    return calibrate.patched("repro_torch.launch.steps", "make_prefill_step",
                             make)


def main(argv=None) -> int:
    import torch
    from harness import manifest

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", choices=FAULTS, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    with planted(args.fault):
        for seed in args.seeds:
            row = calibrate.readings(cell, seed, args.seconds, False,
                                     torch.device("cuda", 0))
            row["fault"] = args.fault
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
