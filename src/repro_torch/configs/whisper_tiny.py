"""Whisper-tiny [arXiv:2212.04356]: 4L enc + 4L dec, d_model=384 6H
(kv=6) d_ff=1536 vocab=51865.
Reference: ``src/repro/configs/whisper_tiny.py``.

The conv frontend is a stub, as in the reference: the encoder takes 1500
precomputed frame embeddings. Decode exercises the decoder with self and
cross caches.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    hidden_act="gelu",
    use_bias=True,
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_seq_len=1500,
    max_seq_len=65536,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        vocab_pad_multiple=16,
        dtype="float32",
        remat="none",
        use_bias=True,
        is_encoder_decoder=True,
        num_encoder_layers=2,
        encoder_seq_len=16,
        max_seq_len=512,
        tie_embeddings=True,
    )
