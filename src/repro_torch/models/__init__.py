"""Model zoo of the port (dense transformer family so far).
Reference: ``src/repro/models/``."""
from repro_torch.models.convert import (from_jax_tree, load_jax_params,
                                        to_jax_tree)
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM", "from_jax_tree", "get_model", "load_jax_params",
           "to_jax_tree"]
