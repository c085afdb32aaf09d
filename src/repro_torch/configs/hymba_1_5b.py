"""hymba-1.5b — hybrid: parallel attention + mamba heads [arXiv:2411.13676; hf]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "hymba-1.5b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        d_head=64, rope_theta=10000.0,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256, ssm_state=8, ssm_head_dim=16,
                               ssm_chunk=16)
