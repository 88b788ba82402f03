"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus spec].
Reference: ``src/repro/configs/command_r_plus_104b.py``.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no biases, tied
embeddings. The scale case: TP=16 + ZeRO-1 sharded optimizer state are
required to fit; gradient all-reduce traffic dominates — this is the
paper-representative hillclimb target.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    hidden_act="swiglu",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=352,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        tie_embeddings=True,
    )
