"""K4's time at hymba-1.5b's prefill shapes on the inputs of a real prefill
layer and on random inputs of three scales, with the card's clock and power
beside each: does K4's time depend on its data?

    python3 tools/k4_probe.py         # from the repo root, on a CUDA host
"""
import subprocess, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import build, flash_attention as fa, ops
from repro_torch.configs import get_config
from repro_torch.nn import init_params
from repro_torch.launch.steps import make_prefill_step
import numpy as np
build.build_kernels()
def t(fn, reps=5):
    fn(); torch.cuda.synchronize(); a = torch.cuda.Event(True); b = torch.cuda.Event(True)
    a.record(); [fn() for _ in range(reps)]; b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / reps
smi = lambda: subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
cfg = get_config("hymba-1.5b"); model = init_params(cfg, seed=0)
tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 2048))).cuda()
cap = []; real = ops.flash_attention
ops.flash_attention = lambda *a, **k: (cap.append(a), real(*a, **k))[1]
make_prefill_step(cfg, max_seq=2080)(model, {"tokens": tokens}); ops.flash_attention = real
q, k, v = cap[5]
print(smi())
stats = lambda x: f"mean {x.float().mean().item():.3g} std {x.float().std().item():.3g} absmax {x.float().abs().max().item():.3g}"
print("model q", stats(q), "k", stats(k), "v", stats(v))
print("model data ms", t(lambda: fa.flash_attention(q, k, v)))
g = torch.Generator(device="cuda").manual_seed(0)
for scale in (0.1, 1.0, 3.0):
    rq, rk, rv = (scale * torch.randn(q.shape, generator=g, device="cuda")).to(torch.bfloat16), None, None
    rk = (scale * torch.randn(k.shape, generator=g, device="cuda")).to(torch.bfloat16)
    rv = torch.randn(v.shape, generator=g, device="cuda").to(torch.bfloat16)
    print("random scale", scale, "ms", t(lambda: fa.flash_attention(rq, rk, rv)), smi())
print("model q + random k", t(lambda: fa.flash_attention(q, rk, v)))
print("random q + model k", t(lambda: fa.flash_attention(rq, k, v)))
print("model data again ms", t(lambda: fa.flash_attention(q, k, v)), smi())
# scores spread: the row max minus typical score
s = torch.einsum("qhd,khd->hqk", q[0, :256, :5].float(), k[0, :256, :1].float().expand(256, 5, 64)) / 8
print("model scores", stats(s))
