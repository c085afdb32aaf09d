"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=0,                          # no dense MLP on MoE layers
        vocab_size=151936,
        d_head=128, rope_theta=1000000.0, qk_norm=True,
        n_experts=128, n_experts_active=8, moe_d_ff=768,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, vocab_size=256,
                               n_experts=8, n_experts_active=2, moe_d_ff=32)
