"""Model zoo of the port: the dense, MoE and vlm transformer families (GQA
or MLA), RWKV-6, the Hymba hybrid and the Whisper encoder-decoder.
Reference: ``src/repro/models/``."""
from repro_torch.models.convert import (from_jax_tree, load_jax_params,
                                        to_jax_tree)
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.registry import get_model, param_count
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperModel

__all__ = ["HymbaLM", "RWKVLM", "TransformerLM", "WhisperModel",
           "from_jax_tree", "get_model", "load_jax_params", "param_count",
           "to_jax_tree"]
