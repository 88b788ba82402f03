"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679].
Reference: ``src/repro/configs/minitron_4b.py``.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, squared-ReLU FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    hidden_act="relu_sq",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=288,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        hidden_act="relu_sq",
    )
