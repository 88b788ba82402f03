"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + SSM heads per block.
Reference: ``src/repro/configs/hymba_1_5b.py``.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16. Attention is sliding-window (1024) in every block (Hymba
keeps 3 global layers; the reference uses the window everywhere, so the
SSM path carries the long-range state). Decode: an O(window) attention
ring buffer + O(1) SSM state a layer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hidden_act="swiglu",
    sliding_window=1024,
    hybrid_parallel=True,
    ssm=SSMConfig(state_dim=16),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        num_layers=2,
        d_model=80,
        num_heads=5,
        num_kv_heads=1,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        sliding_window=8,
        hybrid_parallel=True,
        ssm=SSMConfig(state_dim=4),
    )
