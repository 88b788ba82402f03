"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].
Reference: ``src/repro/configs/deepseek_v2_lite_16b.py``.

27L d_model=2048 16H, MLA kv_lora=512 (rope 64 / nope 128 / v 128),
vocab=102400; MoE: 64 routed experts top-6 + 2 shared (d_ff 1408 each),
first layer dense (d_ff=10944). The port's tensor parallelism shards the
first layer's MLP and the vocabulary and leaves MLA and the experts whole
(``distributed.sharding.tp_plan``).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    attention_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128),
    hidden_act="swiglu",
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        expert_d_ff=1408,
        shared_d_ff=2816,
        first_dense=1,
        dense_d_ff=10944,
        partition_mode="ep",
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        attention_kind="mla",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_rope_dim=8,
                      qk_nope_dim=16, v_head_dim=16),
        # capacity_factor=8 => drop-free (see qwen2_moe smoke note)
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      expert_d_ff=32, shared_d_ff=64, first_dense=1,
                      dense_d_ff=128, partition_mode="ep",
                      capacity_factor=8.0),
    )
