"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without
sparsity, at the full 700 W): bf16 and TF32 tensor-core FLOP/s, float32
FLOP/s outside the tensor cores, HBM3 bytes/s.  A card set below 700 W
(``power.limit``) runs under them; each run prints the limit it found."""

PEAKS = {
    "bf16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,
    "hbm": 3.35e12,
}
