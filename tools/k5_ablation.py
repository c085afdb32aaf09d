"""What bounds K5: time it whole and with one part taken out at a time, at
hymba-1.5b's and mamba2-130m's prefill shapes.

    python3 tools/k5_ablation.py      # from the repo root, on an H100 host

Each variant is ``csrc/ssd.cu`` with one text substitution, built by
``nvcc`` into ``src/repro_torch/kernels/_build/ablation_k5/`` (all at once)
and launched through its C entry ``ssd_intra_chunk_group`` on the same
seeded inputs (as ``tools/k5_check.py`` makes them):

- ``base``: the kernel as it is;
- ``warps16``: 16 warps a block instead of 8;
- ``noexp``: the decays added instead of exponentiated (no MUFU work);
- ``nomma``: no tensor-core product (the split operands XORed into the
  accumulators instead);
- ``onepass``: only the hi hi product of the three (two of three ``mma``
  instructions of scores dtx and S_c gone);
- ``nostore``: y and S_c not written;
- ``noload``: no dtx or cumA copied after the first head of a block;
- ``nosc``: no S_c items (y alone);
- ``clocks``: each warp's clock cycles a head in its items and at the
  head's barrier, printed for the first blocks.

``base`` and ``warps16`` compute the step and are held to the plain
version.  Times are CUDA events over 10 launches after a warm-up pass over
every variant, with the group the kernel picks (0) and with 5 and 25 heads a
block at hymba's shape, beside the card's name, power limit and SM clock.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import K5_TOL, cuda_ms, nvidia_smi  # noqa: E402
from k5_check import WIDE, inputs  # noqa: E402
from repro_torch.kernels import build, ssd  # noqa: E402

VARIANTS = {
    "base": [],
    "warps16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    "noexp": [("v.x * exp_approx(e0), v.y * exp_approx(e1),\n"
               "                         v.z * exp_approx(e2), v.w * exp_approx(e3)",
               "v.x + e0, v.y + e1, v.z + e2, v.w + e3")],
    "onepass": [(f"for (int nt = 0; nt < kTiles; ++nt) mma(acc[nt], {a}, "
                 f"{b}[nt][0], {b}[nt][1]);", "")
                for a, b in (("a.lo", "bh"), ("a.hi", "bl"))],
    "nomma": [(f"for (int nt = 0; nt < kTiles; ++nt) mma(acc[nt], {a}, "
               f"{b}[nt][0], {b}[nt][1]);",
               f"for (int nt = 0; nt < kTiles; ++nt) acc[nt][{i}] += "
               f"__uint_as_float({a}[{i}] ^ {b}[nt][0] ^ {b}[nt][1]);")
              for i, (a, b) in enumerate((("a.lo", "bh"), ("a.hi", "bl"),
                                          ("a.hi", "bh")))],
    "nostore": [("store_tiles(yg,", "if (acc[0][0] == 1.2345f) store_tiles(yg,"),
                ("store_tiles(sg,", "if (acc[0][0] == 1.2345f) store_tiles(sg,")],
    "noload": [("if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);", "")],
    "nosc": [("      } else {\n        // S_c rows",
              "      } else if (false) {\n        // S_c rows")],
    # per warp, clock cycles spent in the items and at the head barrier,
    # written over S_c (blocks x warps x 2 floats)
    "clocks": [("  for (int hh = 0; hh < nh; ++hh) {\n    const int buf = hh & 1;\n"
                "    cp_wait<0>();",
                "  long long busy = 0, waited = 0;\n"
                "  for (int hh = 0; hh < nh; ++hh) {\n    const int buf = hh & 1;\n"
                "    const long long t0 = clock64();\n    cp_wait<0>();"),
               ("    if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);",
                "    if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);\n"
                "    const long long t1 = clock64();\n    waited += t1 - t0;"),
               ("        store_tiles(sg, acc, 16 * tile, n, c0, p, lane);\n"
                "      }\n    }\n  }\n}",
                "        store_tiles(sg, acc, 16 * tile, n, c0, p, lane);\n"
                "      }\n    }\n    busy += clock64() - t1;\n  }\n"
                "  if (lane == 0) {\n"
                "    sc[2 * (blockIdx.x * kWarps + warp)] = (float)busy / nh;\n"
                "    sc[2 * (blockIdx.x * kWarps + warp) + 1] = (float)waited / nh;\n"
                "  }\n}")],
}
EXACT = ("base", "warps16")


def build_variants() -> dict:
    out = build.BUILD_DIR / "ablation_k5"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "ssd.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        for line in log.decode().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).ssd_intra_chunk_group
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    print(f"card: {nvidia_smi('name,power.limit')}", flush=True)
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    for label, G1, h, q, n, p in WIDE:
        args = inputs(gen, G1, h, q, n, p)
        y = torch.empty(G1 * h, q, p, device="cuda")
        s = torch.empty(G1 * h, n, p, device="cuda")
        want = ssd.ssd_intra_chunk_plain(*args)
        strides = (ctypes.c_longlong * 16)(
            *(st for t in args for st in t.stride()))
        ptrs = [t.data_ptr() for t in args] + [y.data_ptr(), s.data_ptr()]

        def call(name, grp):
            build.launch(fns[name], y.device, *ptrs, strides, G1 * h, h, q,
                         n, p, grp)

        groups = (0, 5, 25) if h == 50 else (0, 8, 24)
        for warm in (True, False):
            row = []
            for name in VARIANTS:
                if name in EXACT and warm:
                    y.zero_(), s.zero_()
                    call(name, 0)
                    torch.cuda.synchronize()
                    for got, w in zip((y, s), want):
                        bad = (got - w).abs() > K5_TOL + K5_TOL * w.abs()
                        if bool(bad.any()):
                            ok = False
                            print(f"  {name} at {label}: off by "
                                  f"{float((got - w).abs().max()):.3g}")
                times = [cuda_ms(lambda: call(name, g), 10) for g in groups]
                row.append(f"{name} " + "/".join(f"{t:.4f}" for t in times))
            if not warm:
                call("clocks", 0)
                torch.cuda.synchronize()
                clk = s.flatten()[:2 * 8 * 4].view(4, 8, 2).cpu()
                print(f"{label} clocks a head (busy / waiting at the "
                      f"barrier), warps of blocks 0-3: " + "; ".join(
                          " ".join(f"{int(b)}/{int(w)}" for b, w in blk)
                          for blk in clk.tolist()))
                print(f"{label} (G1 {G1}, h {h}, q {q}, n {n}, p {p}; ms a "
                      f"call at groups {groups}; SM clock "
                      f"{nvidia_smi('clocks.sm')}): " + ", ".join(row),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
