"""First on-card check of K4 and K5: build every kernel, print the compiler's
register and spill lines, hold K4 (D 16-128, rep 1 and 5, causal and full,
S 200, float32 and bfloat16) and K5 (q 16-128, n 8-128, p 16-64, B and C
expanded over 5 heads) to their plain versions, and time K4, SDPA and K5
once at hymba-1.5b's prefill shapes on random inputs.

    python3 tools/k45_check.py        # from the repo root, on a CUDA host
"""
import sys, time, torch
sys.path.insert(0, "src")
from repro_torch.kernels import build, flash_attention as fa, ssd
torch.backends.cuda.matmul.allow_tf32 = False
t = time.time(); logs = build.build_kernels(); print("build", time.time() - t)
for n, l in logs.items():
    for line in l.splitlines():
        if "registers" in line or "spill" in line or "error" in line: print(n, line.strip())
g = torch.Generator(device="cuda").manual_seed(0)
for D in (16, 32, 64, 128):
  for rep in (1, 5):
    for causal in (True, False):
      for dt in (torch.float32, torch.bfloat16):
        B, S, KH = 2, 200, 2
        q = torch.randn(B, S, KH * rep, D, device="cuda", generator=g).to(dt)
        k = torch.randn(B, S, KH, D, device="cuda", generator=g).to(dt)
        v = torch.randn(B, S, KH, D, device="cuda", generator=g).to(dt)
        o = fa.flash_attention(q, k, v, causal); w = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        print("K4", D, rep, causal, dt, (o.float() - w.float()).abs().max().item())
for q_, n, p in ((16, 8, 16), (64, 16, 64), (128, 16, 64), (128, 128, 64)):
    G1, h = 6, 5
    dtx = torch.randn(G1, h, q_, p, device="cuda", generator=g)
    Bm = torch.randn(G1, 1, q_, n, device="cuda", generator=g).expand(G1, h, q_, n)
    Cm = torch.randn(G1, 1, q_, n, device="cuda", generator=g).expand(G1, h, q_, n)
    a = -torch.rand(G1, h, q_, 1, device="cuda", generator=g) * 0.1
    cum = a.cumsum(2)
    y, s = ssd.ssd_intra_chunk(dtx, Bm, Cm, cum); yp, sp = ssd.ssd_intra_chunk_plain(dtx, Bm, Cm, cum)
    torch.cuda.synchronize()
    print("K5", q_, n, p, (y - yp).abs().max().item(), (s - sp).abs().max().item())
B, S, H, KH, D = 4, 2048, 25, 5, 64
q = torch.randn(B, S, H, D, device="cuda", dtype=torch.bfloat16); k = torch.randn(B, S, KH, D, device="cuda", dtype=torch.bfloat16); v = torch.randn_like(k)
for _ in range(2): fa.flash_attention(q, k, v)
torch.cuda.synchronize(); e0 = torch.cuda.Event(True); e1 = torch.cuda.Event(True)
e0.record(); [fa.flash_attention(q, k, v) for _ in range(5)]; e1.record(); torch.cuda.synchronize(); print("K4 full ms", e0.elapsed_time(e1) / 5)
import torch.nn.functional as F
qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True); torch.cuda.synchronize()
e0.record(); [F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True) for _ in range(5)]; e1.record(); torch.cuda.synchronize(); print("sdpa ms", e0.elapsed_time(e1) / 5)
dtx = torch.randn(64, 50, 128, 64, device="cuda"); Bm = torch.randn(64, 1, 128, 16, device="cuda").expand(64, 50, 128, 16); Cm = Bm.clone(); cum = (-torch.rand(64, 50, 128, 1, device="cuda") * .1).cumsum(2)
ssd.ssd_intra_chunk(dtx, Bm, Cm, cum); torch.cuda.synchronize()
e0.record(); [ssd.ssd_intra_chunk(dtx, Bm, Cm, cum) for _ in range(5)]; e1.record(); torch.cuda.synchronize(); print("K5 full ms", e0.elapsed_time(e1) / 5)
print(fa.LAUNCHES, ssd.LAUNCHES)
