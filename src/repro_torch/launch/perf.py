"""§Perf hillclimb driver: trace named layout variants for the three selected
cells and record artifacts tagged by variant (counterpart of
``repro.launch.perf``).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell moe|vl|decode [--variant NAME]

Each variant is one hypothesis -> change -> re-trace iteration; comparing
the tagged artifacts under ``artifacts/perf_torch/`` gives the before and
after of each layout's collectives.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.launch.dryrun import trace_cell

OUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "artifacts", "perf_torch"))

# variant name -> (arch, shape, kwargs for trace_cell)
CELLS = {
    # Cell A — paper-representative: MoE dispatch message patterns
    "moe": {
        "arch": "qwen3-moe-30b-a3b", "shape": "train_4k",
        "variants": {
            "base": {},
            "nosp": {"seq_shard": False},
            "cap10": {"cfg_overrides": {"capacity_factor": 1.0}},
            "tp32": {"mesh_shape": (8, 32)},
            "tp8": {"mesh_shape": (32, 8)},
        },
    },
    # Cell B — biggest model, collective-bound (FSDP + TP at d=8192)
    "vl": {
        "arch": "qwen2-vl-72b", "shape": "train_4k",
        "variants": {
            "base": {},
            "nosp": {"seq_shard": False},
            "tp32": {"mesh_shape": (8, 32)},
            "mb8": {"microbatch_override": 8},
            "mb32": {"microbatch_override": 32},
        },
    },
    # Cell C — memory-bound decode at 32k context
    "decode": {
        "arch": "qwen3-32b", "shape": "decode_32k",
        "variants": {
            "base": {},
            "int8kv": {"cfg_overrides": {"kv_quant": True}},
            "tp32": {"mesh_shape": (8, 32)},
            "int8kv_tp32": {"cfg_overrides": {"kv_quant": True},
                            "mesh_shape": (8, 32)},
        },
    },
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), required=True)
    ap.add_argument("--variant", default="all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="where K1 prices the collectives (default cuda)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    spec = CELLS[args.cell]
    names = (list(spec["variants"]) if args.variant == "all"
             else [args.variant])
    for name in names:
        path = os.path.join(args.out, f"{args.cell}__{name}.json")
        if os.path.exists(path) and not args.force:
            print(f"{args.cell}/{name}: cached")
            continue
        t0 = time.time()
        try:
            art = trace_cell(spec["arch"], spec["shape"], multi_pod=False,
                             device=args.device, **spec["variants"][name])
            art["variant"] = name
        except Exception as e:  # noqa: BLE001
            art = {"variant": name, "status": "failed", "error": str(e)[:500]}
        with open(path, "w") as f:
            json.dump(art, f, indent=1, default=float)
        st = art.get("status")
        extra = ""
        if st == "ok":
            cm = art["comm_model"]
            extra = (f"peak={art['memory']['peak_bytes']/2**30:.2f}GiB "
                     f"flops={art['cost']['flops_per_device']:.3e} "
                     f"bytes={art['cost']['bytes_per_device']:.3e} "
                     f"comm_model={cm['model_time']:.4f}s "
                     f"(q={cm['queue']:.5f} c={cm['contention']:.4f})")
        print(f"{args.cell}/{name}: {st} {extra} ({time.time()-t0:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
