"""Which parameters the spmd engine's ``'model'`` axis splits, and how.
Reference: ``src/repro/distributed/sharding.py``, its manual tensor
parallelism part only (``TPPlan``, ``tp_plan``, ``tp_local_model_cfg``,
``tp_param_spec`` / ``tp_param_specs``, ``tp_state_specs``; :225-366). The
reference's GSPMD rules (``param_spec``, ``cache_shardings``, ...) have no
counterpart here.

The reference states a leaf's placement as a ``PartitionSpec``; here it is
the one dimension the ``'model'`` axis splits (``None``: the leaf is
replicated). Rank ``m`` of a model group holds the ``m``-th of ``size``
contiguous slices of that dimension. The rules match a path by its
suffix, with ``.`` or ``/`` between keys, so they read the port's
parameter names (``layers.3.attn.wq.w``, unstacked ``[d, H * hd]``) and
the reference's paths (``seg_dense/attn/wq/w``, stacked ``[L, d, H *
hd]``) alike: both split the last dimension.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence

# optimizer-state trees prefix their leaves (ms/mom/m/v/acc); strip the
# prefix so state leaves inherit the matching parameter's split
_OPT_PREFIX = re.compile(r"^(ms|mom|m|v|acc)[./]")
_SEP = re.compile(r"[./]")


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which parameter groups shard over the engine's ``'model'`` axis.

    Manual TP is group-consistent: the model runs with a locally reshaped
    config, so either every leaf of a group shards or none does (wq
    sharded with wk replicated would change ``q_per_kv`` on the rank).
    :func:`tp_plan` encodes those rules; the booleans mirror
    :class:`repro_torch.distributed.tp.TPContext`."""

    size: int = 1
    attn: bool = False                # wq/wk/wv out-dim, wo in-dim (heads)
    ffn: bool = False                 # w_up/w_gate out-dim, w_down in-dim
    vocab: bool = False               # embed rows, lm_head/head columns

    @property
    def any(self) -> bool:
        return self.attn or self.ffn or self.vocab


def tp_plan(model_cfg, model_size: int) -> TPPlan:
    """Group-consistency and divisibility rules for manual TP.

    * only the transformer families carry the f/g hooks
      (``models.transformer.block_apply``); other families run with the
      model axis replicated;
    * the attention group needs BOTH head counts divisible (contiguous
      q-head slices must align with their kv groups) and no biases (the
      row-parallel ``wo`` bias would be added ``size`` times before the
      all-reduce);
    * the ffn group needs the dense-segment hidden width divisible and no
      biases (same row-parallel ``w_down`` argument);
    * the vocab group needs the padded vocab divisible (embedding rows /
      head columns are sliced contiguously);
    * MoE expert / router / ssm / rwkv leaves never shard here.
    """
    m = model_size
    if m <= 1 or model_cfg is None or \
            model_cfg.family not in ("dense", "moe", "vlm"):
        return TPPlan(max(m, 1))
    attn = (model_cfg.attention_kind == "gqa" and not model_cfg.use_bias
            and model_cfg.num_heads % m == 0
            and model_cfg.num_kv_heads % m == 0)
    d_ff = (model_cfg.moe.dense_d_ff
            if (model_cfg.moe.enabled and model_cfg.moe.dense_d_ff)
            else model_cfg.d_ff)
    ffn = (not model_cfg.use_bias) and d_ff % m == 0 and d_ff >= m
    vocab = model_cfg.padded_vocab % m == 0 and model_cfg.padded_vocab >= m
    return TPPlan(m, attn, ffn, vocab)


def tp_local_model_cfg(model_cfg, plan: TPPlan):
    """The per-rank model config: head counts / hidden width divided by
    the axis size for the groups that shard. ``head_dim`` is pinned first
    so the derived ``resolved_head_dim`` cannot drift when ``num_heads``
    shrinks; vocab fields stay global (``tp.sharded_embed`` /
    ``tp.sharded_cross_entropy`` read the local slice size off the
    parameter itself)."""
    if not plan.any:
        return model_cfg
    kw = {}
    if plan.attn:
        kw.update(head_dim=model_cfg.resolved_head_dim,
                  num_heads=model_cfg.num_heads // plan.size,
                  num_kv_heads=model_cfg.num_kv_heads // plan.size)
    if plan.ffn:
        kw["d_ff"] = model_cfg.d_ff // plan.size
        if model_cfg.moe.enabled and model_cfg.moe.dense_d_ff:
            kw["moe"] = dataclasses.replace(
                model_cfg.moe,
                dense_d_ff=model_cfg.moe.dense_d_ff // plan.size)
    return dataclasses.replace(model_cfg, **kw)


def _ends(path: str, pattern: str) -> bool:
    """The reference's test, on the path with ``/`` between keys."""
    return re.search(pattern + "$", _SEP.sub("/", path)) is not None


def tp_param_spec(path: str, shape: Sequence[int],
                  plan: TPPlan) -> Optional[int]:
    """The dimension of one leaf that the ``'model'`` axis splits, or None
    (replicated). Only the three group-consistent transformer groups
    shard; scalars, 1-D leaves (norm scales) and every unmatched path are
    replicated, and so is a leaf whose dimension does not divide. A
    leading layer-stack dimension is never split."""
    nd = len(shape)

    def at(axis: int) -> Optional[int]:
        return axis if plan.size > 0 and shape[axis] % plan.size == 0 \
            else None

    if plan.vocab and nd >= 2:
        if _ends(path, "embed/embedding"):
            return at(0)
        if _ends(path, r"(lm_head|head)/w"):
            return at(nd - 1)
    if plan.attn and nd >= 2:
        if _ends(path, r"attn/(wq|wk|wv)/w"):
            return at(nd - 1)
        if _ends(path, r"attn/wo/w"):
            return at(nd - 2)
    if plan.ffn and nd >= 2:
        if _ends(path, r"mlp/(w_up|w_gate)/w"):
            return at(nd - 1)
        if _ends(path, r"mlp/w_down/w"):
            return at(nd - 2)
    return None


def tp_param_specs(plan: TPPlan, shapes: Mapping[str, Sequence[int]]
                   ) -> Dict[str, Optional[int]]:
    """``{name: split dimension or None}`` for ``{name: shape}`` (shapes
    or tensors)."""
    return {k: tp_param_spec(k, tuple(getattr(s, "shape", s)), plan)
            for k, s in shapes.items()}


def tp_state_specs(plan: TPPlan, state: Mapping) -> Dict:
    """The same for an optimizer-state or EMA dict: nested dicts keep
    their structure (``{"ms": {name: ...}, "mom": {...}}``), flat names
    lose an optimizer prefix (``ms.<name>``) before the parameter rules
    apply, so every state leaf inherits its parameter's split."""
    out: Dict = {}
    for k, v in state.items():
        if isinstance(v, Mapping):
            out[k] = tp_state_specs(plan, v)
        else:
            out[k] = tp_param_spec(_OPT_PREFIX.sub("", k),
                                   tuple(getattr(v, "shape", v)), plan)
    return out
