"""whisper-small — enc-dec audio backbone [arXiv:2212.04356; unverified].

The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, encoder_seq, d_model].  Deviation from the original: RoPE
replaces learned/sinusoidal positions (noted in DESIGN.md).
"""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "whisper-small"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        d_head=64, rope_theta=10000.0, mlp_type="gelu",
        norm_type="layernorm", norm_eps=1e-5,
        encoder_layers=12, encoder_seq=1500, cross_attention=True,
        frontend="audio_conv", tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_head=16, d_ff=128,
                               vocab_size=256, encoder_layers=2,
                               encoder_seq=30)
