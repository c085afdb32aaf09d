"""granite-4.0-h-small — 36 Mamba2 layers (state 128) interleaved with 4
NoPE attention layers, an MoE FFN (72 experts top-10 plus a shared SwiGLU)
after every mixer, Granite's embedding, residual, logit and attention
scalars [hf ibm-granite/granite-4.0-h-small, config.json].  A port-only id:
the JAX package has no such stack."""
import dataclasses
from repro_torch.nn.config import ArchConfig

ARCH_ID = "granite-4.0-h-small"
#: Attention at layers 5, 15, 25 and 35, Mamba2 everywhere else.
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=0, vocab_size=100352,
        rope_theta=0.0,                  # NoPE
        tie_embeddings=True, norm_eps=1e-5,
        n_experts=72, n_experts_active=10,
        n_shared_experts=2, moe_d_ff=768,    # the shared SwiGLU of 1536
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_kernel=4,
        ssm_chunk=128,                   # published 256; K5 takes <= 128
        layer_types=LAYER_TYPES,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, attention_multiplier=0.0078125,
    )


def smoke_config() -> ArchConfig:
    return dataclasses.replace(config(), n_layers=6, d_model=64, n_heads=4,
                               n_kv_heads=2, d_head=16, vocab_size=256,
                               n_experts=8, n_experts_active=2,
                               n_shared_experts=1, moe_d_ff=32,
                               ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                               layer_types=LAYER_TYPES[:6])
