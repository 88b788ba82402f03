"""InternVL2-2B [arXiv:2404.16821]: the InternLM2 language model behind a
stubbed InternViT frontend.
Reference: ``src/repro/configs/internvl2_2b.py``.

Backbone: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The vision
frontend is not modelled: a batch carries 256 precomputed patch embeddings
``prefix_embeds`` [B, 256, d_model] (448px / patch14 with pixel unshuffle),
spliced ahead of the text tokens; labels are masked there.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    hidden_act="swiglu",
    num_prefix_embeds=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        num_prefix_embeds=8,
    )
