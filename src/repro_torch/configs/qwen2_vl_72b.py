"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, S, d_model] and M-RoPE position ids.
"""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064,
        d_head=128, rope_theta=1000000.0, m_rope=True,
        frontend="patch_embed",
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256)
