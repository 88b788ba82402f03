"""Model config dataclasses. Reference: ``src/repro/configs/base.py``.

Only the model description is ported in this slice: ``ModelConfig`` and
the dataclasses its fields use (``MoEConfig``, ``MLAConfig``,
``SSMConfig``). Field names, defaults and derived properties are the
reference's, so a config converts across by ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (shared + routed experts)."""

    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0       # always-on experts
    top_k: int = 2
    expert_d_ff: int = 0              # d_ff of each routed expert
    shared_d_ff: int = 0              # total d_ff of the shared expert block
    router_aux_weight: float = 0.001  # load-balance aux loss weight
    first_dense: int = 0              # leading dense (non-MoE) layers
    dense_d_ff: int = 0               # d_ff of those leading dense layers
    capacity_factor: float = 1.25
    partition_mode: str = "tp"

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 => full-rank q projection
    qk_rope_dim: int = 64             # per-head rope sub-dimension
    qk_nope_dim: int = 128            # per-head non-rope sub-dimension
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba/SSD-style state-space head config (used by hymba, rwkv6)."""

    state_dim: int = 16
    conv_dim: int = 4                 # depthwise conv width (mamba)
    expand: int = 2                   # inner dim multiplier
    num_heads: int = 0                # SSD heads (0 => derive)

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single unified model description (the reference's field set)."""

    name: str = "model"
    family: str = "dense"             # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0                 # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 8192

    # attention details
    attention_kind: str = "gqa"       # gqa | mla | none (attn-free)
    mla: MLAConfig = MLAConfig(kv_lora_rank=0)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # sliding_window=0 => all layers global. global_every=k => layer i is
    # global iff (i+1) % k == 0 (gemma3's 5 local : 1 global).
    sliding_window: int = 0
    global_every: int = 0
    attn_logit_softcap: float = 0.0

    # ffn
    hidden_act: str = "swiglu"        # swiglu | gelu | relu_sq
    moe: MoEConfig = MoEConfig()

    # alternative token mixers
    ssm: SSMConfig = SSMConfig()
    hybrid_parallel: bool = False
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    num_prefix_embeds: int = 0

    use_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: float = 1.0          # gemma multiplies embeds by sqrt(d)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"           # activation/param dtype
    vocab_pad_multiple: int = 128

    # remat policy of the reference's scanned blocks (training only)
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)
