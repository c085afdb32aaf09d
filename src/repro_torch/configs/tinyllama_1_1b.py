"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "tinyllama-1.1b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab_size=32000,
        d_head=64, rope_theta=10000.0,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256)
