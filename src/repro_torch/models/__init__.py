"""Model zoo of the port (the dense, MoE and vlm transformer families, GQA
or MLA, and RWKV-6 so far).
Reference: ``src/repro/models/``."""
from repro_torch.models.convert import (from_jax_tree, load_jax_params,
                                        to_jax_tree)
from repro_torch.models.registry import get_model, param_count
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.transformer import TransformerLM

__all__ = ["RWKVLM", "TransformerLM", "from_jax_tree", "get_model",
           "load_jax_params", "param_count", "to_jax_tree"]
