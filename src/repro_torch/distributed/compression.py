"""Gradient compression for the wire (paper §6 future work: reduce comms).
Reference: ``src/repro/distributed/compression.py`` (``compress_bf16`` /
``decompress_bf16``, ``_quant_one``, ``compress_int8`` /
``decompress_int8``, ``init_error_feedback``,
``compress_with_error_feedback``, ``compressed_bytes``).

Two schemes:
  * bf16        — stateless round-to-bf16 (halves collective bytes vs f32).
  * int8_ef     — per-tensor-scaled int8 quantization with ERROR FEEDBACK
                  (Seide et al. 2014 / 1-bit SGD lineage): the quantization
                  residual is carried to the next step so the compression
                  bias telescopes away.

The trees are the port's parameter dicts (``{name: tensor}``, nested dicts
too); a compressed gradient is ``{"q": int8 tree, "scale": tree of 0-d f32
tensors}``. The arithmetic is the reference's, in its order: the scale is
``max(max|g|, 1e-12) / 127`` in f32, each code ``g / scale`` (a division by
the 0-d tensor, never a multiply by its reciprocal) rounded half to even,
clipped to ±127. A library, as in the reference: no engine calls it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (nested mappings of tensors) and
    the matching leaves of ``rest``, keeping the keys."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def compress_bf16(tree: Any) -> Any:
    return _map(lambda g: g.to(torch.bfloat16), tree)


def decompress_bf16(tree: Any) -> Any:
    return _map(lambda g: g.to(torch.float32), tree)


def _quant_one(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_one(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_int8(tree: Any) -> Dict[str, Any]:
    pairs = _map(_quant_one, tree)           # (q, scale) at each leaf
    return {"q": _map(lambda qs: qs[0], pairs),
            "scale": _map(lambda qs: qs[1], pairs)}


def decompress_int8(c: Dict[str, Any]) -> Any:
    return _map(_dequant_one, c["q"], c["scale"])


def init_error_feedback(params_like: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params_like)


def compress_with_error_feedback(grads: Any, errors: Any
                                 ) -> Tuple[Dict[str, Any], Any]:
    """q = Q(g + e);  e' = (g + e) - deq(q). Returns (compressed, new_errors)."""
    corrected = _map(lambda g, e: g.to(torch.float32) + e, grads, errors)
    c = compress_int8(corrected)
    new_errors = _map(lambda x, q, s: x - _dequant_one(q, s), corrected,
                      c["q"], c["scale"])
    return c, new_errors


def compressed_bytes(tree: Any, scheme: str) -> int:
    """Wire bytes for a gradient tree under each scheme (for the roofline)."""
    leaves = _leaves(tree)
    n = sum(int(x.numel()) for x in leaves)
    if scheme == "none":
        return 4 * n
    if scheme == "bf16":
        return 2 * n
    if scheme == "int8_ef":
        return n + 4 * len(leaves)
    raise ValueError(scheme)
