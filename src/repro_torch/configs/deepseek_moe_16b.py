"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6, first
layer dense [arXiv:2401.06066; hf]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,                      # dense first layer FFN
        vocab_size=102400,
        d_head=128, rope_theta=10000.0,
        n_experts=64, n_experts_active=6, n_shared_experts=2,
        moe_d_ff=1408, first_dense_layers=1,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=4, d_head=16, d_ff=128,
                               vocab_size=256, n_experts=8,
                               n_experts_active=2, n_shared_experts=1,
                               moe_d_ff=32, first_dense_layers=1)
