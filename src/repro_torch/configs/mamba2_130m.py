"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "mamba2-130m"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        rope_theta=0.0, tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64,
                               vocab_size=256, ssm_state=16, ssm_head_dim=16,
                               ssm_chunk=16)
