"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].
Reference: ``src/repro/configs/qwen2_moe_a2_7b.py``.

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared d_ff = 4*1408 = 5632).
60 % 16 != 0 => expert-TP partitioning (shard every expert's d_ff).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,
    vocab_size=151936,
    hidden_act="swiglu",
    use_bias=False,
    moe=MoEConfig(
        num_experts=60,
        num_shared_experts=4,
        top_k=4,
        expert_d_ff=1408,
        shared_d_ff=5632,
        partition_mode="tp",
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=176,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        # capacity_factor=8 => cap = T*k: drop-free, so decode-vs-forward
        # equivalence is exact (capacity drops differ across batch shapes)
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      expert_d_ff=44, shared_d_ff=88, partition_mode="tp",
                      capacity_factor=8.0),
    )
