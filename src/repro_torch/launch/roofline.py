"""Generate the §Roofline table (markdown) from the port's dry-run artifacts
(counterpart of ``repro.launch.roofline``).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]

Per (arch x shape x mesh): the three roofline terms in seconds, the dominant
term, MODEL_FLOPS/traced FLOPs, and the collective term priced both naively
and with the paper's model.  The peak rate, the HBM bandwidth and the HBM
size are arguments; their defaults are the reference's TPU v5e figures
(``core.params``), for parity with the reference's table: the terms are
then the modeled pod's, not a measurement of any device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from repro_torch.core.params import (V5E_HBM_BW, V5E_HBM_PER_CHIP,
                                     V5E_PEAK_FLOPS_BF16)

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")

#: The reference's fit threshold: 15.5 GiB of a 16 GiB chip.
_FIT_SHARE = 15.5 / 16


def analyze(a: dict, peak_flops: float = V5E_PEAK_FLOPS_BF16,
            hbm_bw: float = V5E_HBM_BW,
            hbm_bytes: float = V5E_HBM_PER_CHIP) -> dict:
    flops = a["cost"]["flops_per_device"]
    byts = a["cost"]["bytes_per_device"]
    cm = a["comm_model"]
    compute = flops / peak_flops
    memory = byts / hbm_bw
    coll = cm["model_time"]
    dom = max((compute, "compute"), (memory, "memory"),
              (coll, "collective"))[1]
    tokens = (a["global_batch"] * a["seq_len"] if a["kind"] != "decode"
              else a["global_batch"])
    mult = 6 if a["kind"] == "train" else 2
    chips = (int(np.prod(a["mesh_shape"])) if "mesh_shape" in a
             else 512 if "2x16x16" in a["mesh"] else 256)
    model_flops = mult * a["n_active_params"] * tokens / chips
    total = compute + memory + coll
    return {
        "arch": a["arch"], "shape": a["shape"], "mesh": a["mesh"],
        "compute_s": compute, "memory_s": memory,
        "coll_naive_s": cm["naive_time"], "coll_bienz_s": coll,
        "queue_s": cm["queue"], "contention_s": cm["contention"],
        "dominant": dom,
        "model/hlo": model_flops / flops if flops else 0.0,
        "roofline_frac": max(compute, memory) / total if total else 0.0,
        "peak_gib": a["memory"]["peak_bytes"] / 2**30,
        "fits": a["memory"]["peak_bytes"] < _FIT_SHARE * hbm_bytes,
    }


def load(mesh_filter: str | None = None, art_dir: str | None = None,
         **machine):
    """(rows of :func:`analyze`, skipped cells) of every artifact in
    ``art_dir``; ``machine`` goes to :func:`analyze`."""
    rows, skips = [], []
    for f in sorted(glob.glob(os.path.join(art_dir or ART, "*.json"))):
        with open(f) as fh:
            a = json.load(fh)
        if mesh_filter and mesh_filter not in a.get("mesh", ""):
            continue
        if a.get("status") == "ok":
            rows.append(analyze(a, **machine))
        elif a.get("status") == "skipped":
            skips.append((a["arch"], a["shape"], a["mesh"], a["reason"]))
    return rows, skips


def to_markdown(rows, skips) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | coll_naive_s | "
           "coll_bienz_s | dominant | 6ND/traced | frac | peak GiB | fits |")
    sep = "|" + "---|" * 12
    lines = [hdr, sep]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['coll_naive_s']:.3e} | {r['coll_bienz_s']:.3e} "
            f"| {r['dominant']} | {r['model/hlo']:.2f} "
            f"| {r['roofline_frac']:.2f} | {r['peak_gib']:.1f} "
            f"| {'y' if r['fits'] else 'N'} |")
    if skips:
        lines.append("")
        lines.append("Skipped cells (documented in DESIGN.md "
                     "§Arch-applicability):")
        for (a, s, m, why) in skips:
            lines.append(f"* {a} x {s} x {m}: {why[:100]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--art-dir", default=None)
    ap.add_argument("--peak-flops", type=float, default=V5E_PEAK_FLOPS_BF16)
    ap.add_argument("--hbm-bw", type=float, default=V5E_HBM_BW)
    ap.add_argument("--hbm-bytes", type=float, default=V5E_HBM_PER_CHIP)
    args = ap.parse_args(argv)
    rows, skips = load(args.mesh, args.art_dir, peak_flops=args.peak_flops,
                       hbm_bw=args.hbm_bw, hbm_bytes=args.hbm_bytes)
    md = to_markdown(rows, skips)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
