"""Carry weights across from the JAX reference (new; no reference module).

``load_jax_params(model, tree)`` takes the reference's param pytree
(``repro.models.transformer.TransformerLM.init`` output, leaves as numpy
arrays or anything ``np.asarray`` accepts) and copies it into a
:class:`~repro_torch.models.transformer.TransformerLM`:

* stacked ``seg_dense/<path>[L, ...]`` leaves are unstacked into
  ``layers.<i>.<path>``;
* every other leaf maps to the module parameter of the same path
  (``embed/embedding`` -> ``embed.embedding``).

Weights keep JAX's ``[d_in, d_out]`` layout on both sides (``common.dense``
is ``x @ w``), so nothing is transposed. A missing or extra leaf, or a
shape mismatch, raises ``ValueError`` naming every offender.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _to_module_leaves(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """JAX paths -> state-dict names, unstacking ``seg_dense`` layers."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        head, _, rest = path.partition("/")
        if head.startswith("seg_"):
            if head != "seg_dense":
                raise ValueError(f"{path}: only the dense family is ported")
            for i in range(arr.shape[0]):
                out[f"layers.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            out[path.replace("/", ".")] = arr
    return out


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Copy the JAX param tree ``tree`` into ``model`` in place (cast to
    each parameter's dtype, on its device). Returns ``model``."""
    leaves = _to_module_leaves(_flatten(tree))
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    bad_shape = sorted(
        f"{name}: jax {tuple(leaves[name].shape)} vs torch "
        f"{tuple(params[name].shape)}"
        for name in set(params) & set(leaves)
        if tuple(leaves[name].shape) != tuple(params[name].shape))
    if missing or extra or bad_shape:
        raise ValueError(
            f"param tree does not fit the model: missing {missing}, "
            f"extra {extra}, shape mismatches {bad_shape}")
    for name, p in params.items():
        src = torch.from_numpy(np.array(leaves[name], dtype=np.float32))
        p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model
