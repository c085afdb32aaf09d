"""qwen3-32b — dense, qk-norm + GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "qwen3-32b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab_size=151936,
        d_head=128, rope_theta=1000000.0, qk_norm=True,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256)
