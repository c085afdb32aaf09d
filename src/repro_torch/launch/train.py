"""End-to-end training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128

Runs on the card unless ``--device cpu`` is given; without a CUDA device
and without ``--device cpu`` it exits with the device error.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.train import AdamWConfig, TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = SyntheticTokens(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                           family=cfg.family, d_model=cfg.d_model,
                           encoder_seq=cfg.encoder_seq)
    trainer = Trainer(
        cfg,
        TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, log_every=5,
                    microbatches=args.microbatches),
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        device=args.device)
    out = trainer.run(data)
    for row in out["history"]:
        print(json.dumps(row))
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
