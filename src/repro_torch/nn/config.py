"""Architecture configuration, a copy of ``repro.nn.config.ArchConfig``:
dense / MoE / SSM / hybrid decoder-only LMs, an encoder-decoder (whisper)
and modality-stub backbones (VLM, audio); it compares field for field with
the reference's.  The port adds fields the reference lacks, each at a
default that changes nothing: a stack whose layers differ in their mixer
(``layer_types``, granite-4.0-h), Granite's four scalars, and an expert
layer that holds a share of a wider router's experts (expert
parallelism's local half)."""
from __future__ import annotations

import dataclasses

#: Mixer of a decoder layer named in ``layer_types`` -> its block kind.
LAYER_TYPES = {"mamba": "ssm", "attention": "attn"}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 = attention-free)
    n_kv_heads: int
    d_ff: int                   # dense-MLP hidden size (0 = none)
    vocab_size: int

    d_head: int = 0             # default: d_model // n_heads
    mlp_type: str = "swiglu"    # swiglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 1e4
    qk_norm: bool = False
    m_rope: bool = False        # qwen2-vl multimodal rope
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0   # top-k
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden size
    first_dense_layers: int = 0  # deepseek: leading dense layers
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 128

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    # modality frontend stub: input_specs() provides precomputed embeddings
    frontend: str | None = None   # patch_embed | audio_conv | None

    # serving: store the decode KV cache as int8 with per-(position, head)
    # scales (halves cache HBM traffic vs bf16; decode is memory-bound)
    kv_quant: bool = False

    norm_eps: float = 1e-6

    # --------------------------------------------- port-only fields ----
    # the mixer of each decoder layer, "mamba" or "attention" (granite-4.0-h
    # interleaves them); empty: every layer of ``block_kind``
    layer_types: tuple = ()
    # granite's scalars: the embeddings times ``embedding_multiplier``, each
    # residual branch times ``residual_multiplier``, the logits over
    # ``logits_scaling``, attention's softmax scale ``attention_multiplier``
    # (0: 1 / sqrt(head_dim))
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0
    # an expert layer holding ``n_experts`` experts, ``expert_first`` on,
    # of a router over ``router_experts`` (0: ``n_experts``, all held)
    router_experts: int = 0
    expert_first: int = 0

    def __post_init__(self):
        if not isinstance(self.layer_types, tuple):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
        bad = set(self.layer_types) - set(LAYER_TYPES)
        if bad:
            raise ValueError(f"unknown layer types {sorted(bad)}; known: "
                             f"{sorted(LAYER_TYPES)}")
        if self.layer_types and len(self.layer_types) != self.n_layers:
            raise ValueError(f"{len(self.layer_types)} layer types for "
                             f"{self.n_layers} layers")
        if self.expert_first + self.n_experts > self.n_router_experts:
            raise ValueError(f"experts {self.expert_first}.."
                             f"{self.expert_first + self.n_experts - 1} lie "
                             f"past the router's {self.n_router_experts}")

    # ---------------------------------------------------------- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence scaling: SSM and hybrid-with-SSM families."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_router_experts(self) -> int:
        """Experts the router chooses among."""
        return self.router_experts or self.n_experts

    @property
    def layer_kinds(self) -> tuple:
        """The block kind of each layer after the leading dense ones:
        ``layer_types`` mapped by :data:`LAYER_TYPES` (an attention layer
        of an MoE config is ``"moe"``), else ``block_kind`` throughout."""
        if not self.layer_types:
            return (self.block_kind,) * (self.n_layers
                                         - self.first_dense_layers)
        kinds = tuple(LAYER_TYPES[t] for t in self.layer_types)
        return tuple("moe" if k == "attn" and self.is_moe else k
                     for k in kinds)[self.first_dense_layers:]

    @property
    def block_kind(self) -> str:
        if self.layer_types:
            return "mixed"
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "hybrid"
        if self.is_moe:
            return "moe"
        return "attn"

    def _layer_params(self, attn: bool, ssm: bool) -> int:
        """Parameters of one decoder layer with the mixers named."""
        d = self.d_model
        per_layer = 0
        if attn:
            hd = self.head_dim
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        if ssm:
            di = self.ssm_d_inner
            n = self.ssm_state
            per_layer += d * (2 * di + 2 * n + self.ssm_heads) + di * d
        if self.is_moe:
            per_layer += d * self.n_router_experts  # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
        elif self.d_ff:
            mult = 3 if self.mlp_type == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        return per_layer

    def n_params(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOP estimates);
        exact where ``layer_types`` gives each layer its mixer."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.layer_types:
            layers = sum(self._layer_params(t == "attention", t == "mamba")
                         for t in self.layer_types)
        else:
            layers = L * self._layer_params(
                self.has_attention and self.block_kind != "ssm",
                self.has_ssm)
        total = emb + layers
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
            cross = self.n_layers * 4 * d * d
            total += enc + cross
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts;
        of a share of the experts, its expected part of the top k)."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        active = self.n_experts_active * self.n_experts \
            // self.n_router_experts
        inactive = (self.n_experts - active) * 3 * d * self.moe_d_ff
        return int(self.n_params() - L * inactive)
