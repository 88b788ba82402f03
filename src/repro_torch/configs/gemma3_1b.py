"""Gemma-3 1B [hf:google/gemma-3-1b-pt].
Reference: ``src/repro/configs/gemma3_1b.py``.

26L d_model=1152 4H (GQA kv=1, head_dim=256) d_ff=6912 vocab=262144;
5 local (sliding window 512) : 1 global interleave; qk-norm; tied
embeddings scaled by sqrt(d). long_500k runs for this arch (local layers
are sub-quadratic; the interleaved global layers are O(S) at decode).
"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    hidden_act="gelu",
    qk_norm=True,
    sliding_window=512,
    global_every=6,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=math.sqrt(1152.0),
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        qk_norm=True,
        sliding_window=8,
        global_every=3,
        tie_embeddings=True,
        embed_scale=8.0,
    )
