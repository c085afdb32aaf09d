"""Serving driver: batched requests through the slot engine (counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --requests 6 --max-new 8

Runs on the card unless ``--device cpu`` is given; without a CUDA device
and without ``--device cpu`` it exits with the device error.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.nn import init_params
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=args.max_seq, device=args.device)
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(2, 8))
        req = Request(uid=uid,
                      prompt=rng.integers(1, cfg.vocab_size, plen).tolist(),
                      max_new_tokens=args.max_new)
        reqs.append(req)
        eng.submit(req)
    t0 = time.perf_counter()
    eng.run_until_done(max_ticks=2000)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    for r in reqs:
        print(f"req {r.uid}: prompt={r.prompt} -> {r.output}")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s, {args.slots} slots)")


if __name__ == "__main__":
    main()
