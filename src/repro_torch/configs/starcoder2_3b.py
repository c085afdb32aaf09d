"""starcoder2-3b — GQA + RoPE code model [arXiv:2402.19173; hf].

StarCoder2 uses a gelu MLP (not SwiGLU) and LayerNorm.
"""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "starcoder2-3b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab_size=49152,
        d_head=128, rope_theta=999999.4, mlp_type="gelu",
        norm_type="layernorm", norm_eps=1e-5,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256)
