"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family spec].
Reference: ``src/repro/configs/qwen3_0_6b.py``.

28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072 vocab=151936,
qk-norm, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    hidden_act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        qk_norm=True,
        tie_embeddings=True,
    )
