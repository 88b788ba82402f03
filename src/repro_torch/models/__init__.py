"""Model zoo of the port (dense transformer family so far).
Reference: ``src/repro/models/``."""
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM", "get_model", "load_jax_params"]
