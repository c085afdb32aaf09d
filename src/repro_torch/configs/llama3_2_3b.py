"""llama3.2-3b — dense llama3-family [hf:meta-llama/Llama-3.2-1B; unverified]."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "llama3.2-3b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        d_head=128, rope_theta=500000.0, tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=128,
                               vocab_size=256)
