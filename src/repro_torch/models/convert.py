"""Carry weights across between the JAX reference's trees and the port's
modules (new; no reference module).

``load_jax_params(model, tree)`` takes the reference's param pytree
(``TransformerLM.init`` or ``RWKVLM.init`` output of ``repro.models``,
leaves as numpy arrays or anything ``np.asarray`` accepts) and copies it
into the port's model of the same family:

* stacked per-layer leaves are unstacked into the model's module list:
  ``seg_dense/<path>[L, ...]`` into ``layers.<i>.<path>`` (dense family),
  ``seg_moe/<path>[L_moe, ...]`` into ``layers.<first_dense + i>.<path>``
  (MoE family; ``first_dense`` is the ``seg_dense`` stack's depth, 0
  without one), ``blocks/<path>[L, ...]`` into ``blocks.<i>.<path>``
  (RWKV, Hymba), ``enc_blocks/<path>[L_enc, ...]`` and
  ``dec_blocks/<path>[L, ...]`` into ``enc_blocks.<i>.<path>`` and
  ``dec_blocks.<i>.<path>`` (Whisper);
* every other leaf maps to the module parameter of the same path
  (``embed/embedding`` -> ``embed.embedding``).

Weights keep JAX's ``[d_in, d_out]`` layout on both sides (``common.dense``
is ``x @ w``), so nothing is transposed. A missing or extra leaf, or a
shape mismatch, raises ``ValueError`` naming every offender.

``to_jax_tree(named)`` is the inverse mapping on any dict keyed by module
parameter names (the parameters, and the optimizer's and the EMA's
per-parameter dicts, which mirror them): ``layers.<i>.<path>`` leaves are
restacked into ``seg_dense/<path>[L, ...]``, from the first layer that
holds an ``moe`` leaf on into ``seg_moe/<path>[L_moe, ...]``, and
``blocks.<i>.<path>``, ``enc_blocks.<i>.<path>`` and
``dec_blocks.<i>.<path>`` into ``blocks/<path>[L, ...]``,
``enc_blocks/...`` and ``dec_blocks/...``; the rest nest by their dotted
path.
``from_jax_tree`` flattens a reference tree to those names.

Tensor parallelism (the spmd engine's ``'model'`` axis) keeps a rank's
slice of each sharded leaf (``distributed.sharding``):

* ``shard_named(full, plan, index)`` cuts ``{name: full leaf}`` to rank
  ``index``'s slices (parameters, or an optimizer / EMA dict keyed like
  them); ``gather_named(local, dims, group)`` all-gathers them back over
  the model group;
* ``shard_model(model, plan, index)`` turns a full model into the rank's
  local one in place: each sharded parameter replaced by its slice, the
  config by ``sharding.tp_local_model_cfg``, and the split dimensions
  kept in ``model.tp_dims`` (with ``model.tp_slice = (plan, index)``).
  ``load_named`` and ``load_jax_params`` slice a full tree into such a
  model, so a reference tree crosses into a TP run as it is.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding


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
_STACKED = {"seg_dense": "layers", "seg_moe": "layers", "blocks": "blocks",
            "enc_blocks": "enc_blocks", "dec_blocks": "dec_blocks"}
_RESTACKED = {"layers": "seg_dense", "blocks": "blocks",
              "enc_blocks": "enc_blocks", "dec_blocks": "dec_blocks"}


def _take(arr, i: int, axis: int):
    if isinstance(arr, torch.Tensor):
        return arr.select(axis, i)
    return np.take(arr, i, axis=axis)


def _to_module_leaves(flat: Dict, axis: int = 0) -> Dict:
    """JAX paths -> state-dict names, unstacking per-layer leaves (their
    layer axis is ``axis``); ``seg_moe`` layers follow ``seg_dense``'s."""
    first_dense = next((arr.shape[axis] for path, arr in flat.items()
                        if path.startswith("seg_dense/")), 0)
    out: Dict = {}
    for path, arr in flat.items():
        head, _, rest = path.partition("/")
        if head in _STACKED:
            base = first_dense if head == "seg_moe" else 0
            for i in range(arr.shape[axis]):
                out[f"{_STACKED[head]}.{base + i}."
                    f"{rest.replace('/', '.')}"] = _take(arr, i, axis)
        elif head.startswith("seg_"):
            raise ValueError(f"{path}: only the dense and MoE segments "
                             f"(seg_dense, seg_moe) are ported")
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
    ``seg_dense/<path>[L, ...]`` (MoE layers: ``seg_moe``) or
    ``blocks/<path>[L, ...]`` (``enc_blocks``, ``dec_blocks``). With
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
    # an MoE model's layers from its first one with an moe leaf on
    first_moe = min((i for (head, leaf), by_layer in layers.items()
                     if head == "layers" and leaf.startswith("moe.")
                     for i in by_layer), default=None)
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    for (head, leaf), by_layer in layers.items():
        for i, arr in by_layer.items():
            root, j = _RESTACKED[head], i
            if head == "layers" and first_moe is not None and i >= first_moe:
                root, j = "seg_moe", i - first_moe
            stacks.setdefault((root, head, leaf), {})[j] = arr
    for (root, head, leaf), by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{head}.*.{leaf}: layers {sorted(by_layer)} "
                             f"are not 0..L-1")
        rows = [by_layer[i] for i in range(len(by_layer))]
        put([root] + leaf.split("."),
            torch.stack(rows, dim=axis) if isinstance(rows[0], torch.Tensor)
            else np.stack(rows, axis=axis))
    return tree


def shard_named(full: Mapping, plan: sharding.TPPlan, index: int) -> Dict:
    """Rank ``index``'s slices of ``{name: leaf}`` (tensors or numpy
    arrays, full shapes): each leaf cut along the dimension
    ``sharding.tp_param_spec`` splits, the others as they are."""
    out = {}
    for name, t in full.items():
        dim = sharding.tp_param_spec(name, tuple(t.shape), plan)
        if dim is None:
            out[name] = t
            continue
        n = t.shape[dim] // plan.size
        out[name] = (t.narrow(dim, index * n, n)
                     if isinstance(t, torch.Tensor)
                     else np.take(t, np.arange(index * n, (index + 1) * n),
                                  axis=dim))
    return out


def gather_named(local: Mapping[str, torch.Tensor],
                 dims: Mapping[str, Optional[int]], group) -> Dict:
    """The full leaves of ``{name: local slice}``: each leaf split along
    ``dims[name]`` all-gathered over the model ``group`` (every rank of it
    must call this, with the same names in the same order); the others as
    they are."""
    size = dist.get_world_size(group)
    out = {}
    for name, t in local.items():
        dim = dims.get(name)
        if dim is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[name] = torch.cat(parts, dim=dim)
    return out


@torch.no_grad()
def shard_model(model: nn.Module, plan: sharding.TPPlan,
                index: int) -> nn.Module:
    """Make ``model`` (full parameters) rank ``index``'s local model in
    place; returns it. Idempotent for the same plan and index."""
    if getattr(model, "tp_slice", None) is not None:
        if model.tp_slice != (plan, index):
            raise ValueError(f"model already sharded as {model.tp_slice}, "
                             f"not {(plan, index)}")
        return model
    params = dict(model.named_parameters())
    model.tp_dims = sharding.tp_param_specs(plan, params)
    for name, t in shard_named(params, plan, index).items():
        if model.tp_dims[name] is None:
            continue
        parent, _, leaf = name.rpartition(".")
        model.get_submodule(parent).register_parameter(
            leaf, nn.Parameter(t.clone(),
                               requires_grad=params[name].requires_grad))
    model.cfg = sharding.tp_local_model_cfg(model.cfg, plan)
    model.tp_slice = (plan, index)
    return model


def full_shapes(model: nn.Module, named: Mapping[str, torch.Tensor]
                ) -> Dict:
    """The full shapes of ``named`` (a sharded model's parameters, or a
    state dict keyed like them): the split dimension times the axis
    size."""
    tp_slice = getattr(model, "tp_slice", None)
    out = {}
    for name, t in named.items():
        shape = list(t.shape)
        dim = model.tp_dims.get(name) if tp_slice else None
        if dim is not None:
            shape[dim] *= tp_slice[0].size
        out[name] = tuple(shape)
    return out


@torch.no_grad()
def load_named(model: nn.Module, named: Mapping) -> nn.Module:
    """Copy ``{name: full leaf}`` into ``model``'s parameters in place
    (cast, on their device), each cut to the model's slice when it is a
    TP rank's (``shard_model``). Raises ``ValueError`` naming every
    missing or extra leaf and every shape that does not fit."""
    tp_slice = getattr(model, "tp_slice", None)
    if tp_slice is not None:
        named = shard_named(named, *tp_slice)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    bad_shape = sorted(
        f"{name}: given {tuple(named[name].shape)} vs model "
        f"{tuple(params[name].shape)}"
        for name in set(params) & set(named)
        if tuple(named[name].shape) != tuple(params[name].shape))
    if missing or extra or bad_shape:
        raise ValueError(
            f"param tree does not fit the model: missing {missing}, "
            f"extra {extra}, shape mismatches {bad_shape}")
    for name, p in params.items():
        src = named[name]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
        p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Copy the JAX param tree ``tree`` into ``model`` in place (cast to
    each parameter's dtype, on its device; a TP rank's model takes its
    slices). Returns ``model``."""
    return load_named(model, _to_module_leaves(_flatten(tree)))

