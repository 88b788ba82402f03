"""Carry weights across between the JAX reference's trees and the port's
modules (new; no reference module).

``load_jax_params(model, tree)`` takes the reference's param pytree
(``TransformerLM.init`` or ``RWKVLM.init`` output of ``repro.models``,
leaves as numpy arrays or anything ``np.asarray`` accepts) and copies it
into the port's model of the same family:

* stacked per-layer leaves are unstacked into the model's module list:
  ``seg_dense/<path>[L, ...]`` into ``layers.<i>.<path>`` (dense family),
  ``blocks/<path>[L, ...]`` into ``blocks.<i>.<path>`` (RWKV);
* every other leaf maps to the module parameter of the same path
  (``embed/embedding`` -> ``embed.embedding``).

Weights keep JAX's ``[d_in, d_out]`` layout on both sides (``common.dense``
is ``x @ w``), so nothing is transposed. A missing or extra leaf, or a
shape mismatch, raises ``ValueError`` naming every offender.

``to_jax_tree(named)`` is the inverse mapping on any dict keyed by module
parameter names (the parameters, and the optimizer's and the EMA's
per-parameter dicts, which mirror them): ``layers.<i>.<path>`` leaves are
restacked into ``seg_dense/<path>[L, ...]`` and ``blocks.<i>.<path>``
into ``blocks/<path>[L, ...]``, the rest nest by their dotted path.
``from_jax_tree`` flattens a reference tree to those names.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict:
    out: Dict = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val if isinstance(val, torch.Tensor) else \
                np.asarray(val)
    return out


# the reference's stacked root -> the port's module list, and back
_STACKED = {"seg_dense": "layers", "blocks": "blocks"}
_RESTACKED = {v: k for k, v in _STACKED.items()}


def _take(arr, i: int, axis: int):
    if isinstance(arr, torch.Tensor):
        return arr.select(axis, i)
    return np.take(arr, i, axis=axis)


def _to_module_leaves(flat: Dict, axis: int = 0) -> Dict:
    """JAX paths -> state-dict names, unstacking per-layer leaves (their
    layer axis is ``axis``)."""
    out: Dict = {}
    for path, arr in flat.items():
        head, _, rest = path.partition("/")
        if head in _STACKED:
            for i in range(arr.shape[axis]):
                out[f"{_STACKED[head]}.{i}.{rest.replace('/', '.')}"] = \
                    _take(arr, i, axis)
        elif head.startswith("seg_"):
            raise ValueError(f"{path}: only the dense segment (seg_dense) is "
                             f"ported")
        else:
            out[path.replace("/", ".")] = arr
    return out


def from_jax_tree(tree: Mapping, axis: int = 0) -> Dict:
    """A reference tree (params, or an optimizer / EMA tree mirroring
    them; leaves numpy arrays or tensors) -> ``{module parameter name:
    leaf}``, per-layer leaves unstacked. ``axis`` 1 reads a tree of
    stacked copies (``[W, L, ...]`` leaves, the event trainer's
    ``workers`` and ``stale_buffer``) into ``[W, ...]`` leaves."""
    return _to_module_leaves(_flatten(tree), axis)


def to_jax_tree(named: Mapping, axis: int = 0) -> Dict:
    """``{module parameter name: leaf}`` (numpy arrays or tensors) -> the
    reference's nested tree, per-layer leaves restacked into
    ``seg_dense/<path>[L, ...]`` or ``blocks/<path>[L, ...]``. With
    ``axis`` 1 the leaves are stacks ``[W, ...]`` and the layer axis goes
    second (``[W, L, ...]``), as in the reference's stacked trees."""
    layers: Dict[tuple, Dict[int, np.ndarray]] = {}
    tree: Dict = {}

    def put(path, arr):
        node = tree
        *heads, last = path
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr

    for name, arr in named.items():
        head, _, rest = name.partition(".")
        if head in _RESTACKED:
            idx, _, leaf = rest.partition(".")
            layers.setdefault((head, leaf), {})[int(idx)] = arr
        else:
            put(name.split("."), arr)
    for (head, leaf), by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{head}.*.{leaf}: layers {sorted(by_layer)} "
                             f"are not 0..L-1")
        rows = [by_layer[i] for i in range(len(by_layer))]
        put([_RESTACKED[head]] + leaf.split("."),
            torch.stack(rows, dim=axis) if isinstance(rows[0], torch.Tensor)
            else np.stack(rows, axis=axis))
    return tree


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
