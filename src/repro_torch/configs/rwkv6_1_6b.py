"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892].
Reference: ``src/repro/configs/rwkv6_1_6b.py``.

24L d_model=2048 (attention-free, head_dim=64 => 32 wkv heads) d_ff=7168
vocab=65536, data-dependent decay. long_500k runs: O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    attention_kind="none",
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        attention_kind="none",
        d_ff=224,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        rwkv_head_dim=16,
    )
