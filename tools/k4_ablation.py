"""What bounds K4's bfloat16 (tensor-core) kernel: time it whole and with one
part taken out at a time, beside SDPA, at hymba-1.5b's and llama3.2-3b's
attention shapes.

    python3 tools/k4_ablation.py      # from the repo root, on an H100 host

Each variant is ``csrc/flash_attention.cu`` with one text substitution,
built by ``nvcc`` into ``src/repro_torch/kernels/_build/ablation/`` (all at
once) and launched through its C entry ``flash_attention_fwd`` (bf16) on
the same seeded inputs:

- ``base``: the kernel as it is;
- ``noexp``: ``p = s - m`` instead of ``exp2(s - m)`` (no MUFU work);
- ``nopv``: no ``O += P V`` product (P still formed);
- ``noqk``: no ``S = Q K^T`` product;
- ``noload``: no copy of kv tiles after the first (stage 1 stays stale);
- ``one_barrier``: tile j + 1's copy issued only after tile j has landed
  and the block has met (one barrier a tile instead of two);
- ``exp2f``: the softmax as first written (scores scaled before the max,
  a chain of 16 maxima, ``exp2f`` with its range check).

``base``, ``one_barrier`` and ``exp2f`` compute attention and are held to
the plain version; the others time what is left.  Times
are CUDA events over 10 launches after one warm-up, with the card's name,
power limit and SM clock printed first; a whole warm-up pass over every
variant runs before the timed one, so the clock has ramped up.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

LOOP_HEAD = """    if (j + 1 < n_tiles) {  // tile j + 1 in flight while j is used
      const uint32_t st = sq + (1 + 2 * ((j + 1) & 1)) * T::kTile;
      wg::load_rows<D, kThreads>(st, kg, (j + 1) * 64, S, kv_stride,
                                 threadIdx.x);
      wg::load_rows<D, kThreads>(st + T::kTile, vg, (j + 1) * 64, S,
                                 kv_stride, threadIdx.x);
      wg::cp_commit();
      wg::cp_wait<1>();
    } else {
      wg::cp_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
"""
LOOP_TAIL = """    wg::fence_regs(acc);
    __syncthreads();  // the next iteration refills this stage
  }
"""
VARIANTS = {
    "base": [],
    "noexp": [("s[i] = ex2(fmaf(s[i], scale_log2, -m[r] * scale_log2));",
               "s[i] = fmaf(s[i], scale_log2, -m[r] * scale_log2);")],
    "nopv": [("wg::mma_rs(acc, p[kk], wg::desc(sv + kk * 2048, "
              "wg::kBlockBytes, 1024),\n                    1);",
              "acc[kk] += __uint_as_float(p[kk][0] ^ p[kk][1] ^ p[kk][2] ^ "
              "p[kk][3]);")],
    "noqk": [("wg::mma_ss_n64(s, wg::desc(sq + off, 16, 1024),\n"
              "                     wg::desc(sk + off, 16, 1024), kk > 0);",
              "s[kk] += 1.f;")],
    "noload": [("if (j + 1 < n_tiles) {  // tile", "if (false) {  // tile")],
    # tile j + 1 issued only after tile j has landed (one barrier a tile)
    "one_barrier": [(LOOP_HEAD, LOOP_HEAD.split("    if (j + 1")[0] + """\
    wg::cp_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const uint32_t st = sq + (1 + 2 * ((j + 1) & 1)) * T::kTile;
      wg::load_rows<D, kThreads>(st, kg, (j + 1) * 64, S, kv_stride,
                                 threadIdx.x);
      wg::load_rows<D, kThreads>(st + T::kTile, vg, (j + 1) * 64, S,
                                 kv_stride, threadIdx.x);
      wg::cp_commit();
    }
"""), (LOOP_TAIL, "    wg::fence_regs(acc);\n  }\n")],
    # the softmax as first written: scaled scores, exp2f, a chain of maxima
    "exp2f": [
        ("        s[i] = out ? kNegInf : s[i];\n      }\n    }",
         "        s[i] = out ? kNegInf : s[i] * scale_log2;\n      }\n"
         "    } else {\n#pragma unroll\n"
         "      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;\n    }"),
        ("alpha[r] = ex2((m[r] - mx) * scale_log2);",
         "alpha[r] = exp2f(m[r] - mx);"),
        ("s[i] = ex2(fmaf(s[i], scale_log2, -m[r] * scale_log2));",
         "s[i] = exp2f(s[i] - m[r]);"),
        ("float mx = fmaxf(m[r], t[0]);",
         "float mx = m[r];\n#pragma unroll\n      for (int i = 0; i < 16; "
         "++i) mx = fmaxf(mx, s[4 * (i / 2) + 2 * r + i % 2]);")],
}
#: the variants that still compute attention
EXACT = ("base", "one_barrier", "exp2f")
# (B, S, H, KH, D, causal)
SHAPES = ((4, 2048, 25, 5, 64, 1), (4, 2048, 25, 5, 64, 0),
          (4, 2048, 24, 8, 128, 1))


def build_variants() -> dict:
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: source line not found:"
                                   f" {old!r}")
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
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_ablation: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for timed in (False, True):
        if timed:
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
        for B, S, H, KH, D, causal in SHAPES:
            q, k, v = (torch.randn(B, S, h, D, device="cuda", generator=gen)
                       .bfloat16() for h in (H, KH, KH))
            o = torch.empty_like(q)
            outs = {}
            flops = B * H * (S * (S + 1) // 2 if causal else S * S) * 4 * D
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            t = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=bool(causal), enable_gqa=True))
            line = (f"q {[B, S, H, D]} kv heads {KH} causal {causal}: SDPA "
                    f"{t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)")
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), B, S, H, KH, D, causal, 1,
                             D ** -0.5, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                t = cuda_ms(call)
                line += f"; {name} {t:.4f} ms ({flops / t / 1e9:.0f})"
                if name in EXACT:
                    outs[name] = o.clone()
            if timed:
                want = fa.flash_attention_plain(q, k, v, bool(causal))
                errs = {n: float((outs[n].float() - want.float()).abs().max())
                        for n in EXACT}
                line += "; max abs err against the plain version: " + \
                    ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
