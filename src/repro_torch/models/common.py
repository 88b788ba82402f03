"""Shared building blocks: device choice, inits, norms, rope, dense layers,
cross entropy. Reference: ``src/repro/models/common.py`` (``embed`` and
``softmax_cross_entropy`` take the vocab-sharded paths of
``distributed.tp`` under a TP context, as there).

Parameters live in ``nn.ParameterDict``/``nn.ModuleDict`` containers whose
keys are the reference pytree's (``{"w": [d_in, d_out], "b": [d_out]}``
for a dense layer, ``{"scale": [d]}`` for a norm), so the layer functions
below read like the reference's and a JAX param tree maps onto a module
leaf for leaf (``models/convert.py``). Weights keep JAX's ``[d_in, d_out]``
layout: ``dense`` is ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tp

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card: ``None`` means ``cuda``.

    Raises when CUDA is asked for (explicitly or by default) and absent;
    the CPU is used only when the caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU unless "
                "the caller passes device='cpu' (CLI: --device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def trunc_normal(gen: torch.Generator, shape, std: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """2-sigma truncated normal, the LM-standard init, drawn in f32 from
    ``gen`` (which must live on ``device``). Same distribution as the
    reference's ``jax.random.truncated_normal``; not the same numbers."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.to(dtype) * std


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class ParamTree(nn.Module):
    """A node of the reference's param tree holding both bare tensors and
    subtrees (``nn.ModuleDict`` holds only modules, ``nn.ParameterDict``
    only tensors): ``params[key]`` reads either, and the parameter names
    are the reference's paths (``att.w_base``, ``att.mu.r``)."""

    def __init__(self, items):
        super().__init__()
        for key, val in items.items():
            if isinstance(val, nn.Module):
                self.add_module(key, val)
            else:
                self.register_parameter(key, _param(val))

    def __getitem__(self, key: str):
        return getattr(self, key)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, device=None,
               *, bias: bool = False,
               std: Optional[float] = None) -> nn.ParameterDict:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _param(trunc_normal(gen, (d_in, d_out), std, dtype, device))}
    if bias:
        p["b"] = _param(torch.zeros((d_out,), dtype=dtype, device=device))
    return nn.ParameterDict(p)


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device=None,
               std: float = 0.02) -> nn.ParameterDict:
    return nn.ParameterDict(
        {"embedding": _param(trunc_normal(gen, (vocab, d), std, dtype,
                                          device))})


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    ctx = tp.vocab_active()
    if ctx is not None:               # TP: a vocab-sharded table
        return tp.sharded_embed(params["embedding"], ids, ctx)
    return F.embedding(ids, params["embedding"])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> nn.ParameterDict:
    return nn.ParameterDict(
        {"scale": _param(torch.ones((d,), dtype=dtype, device=device))})


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32,
                   device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": _param(torch.ones((d,), dtype=dtype, device=device)),
        "bias": _param(torch.zeros((d,), dtype=dtype, device=device))})


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``t`` [B, S, ...] padded with ``value`` by ``pad`` positions at the
    end of S (the blocked attention core's and the SSD's chunk padding)."""
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable). Split-halves
    layout (not interleaved), angles in f32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)          # [D/2]
    angles = positions[..., :, None, None].float() * freqs       # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _relu_sq(x):
    return torch.square(F.relu(x))


def activation(name: str):
    return {
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "relu": F.relu,
        "relu_sq": _relu_sq,
        "swiglu": F.silu,  # gate activation inside SwiGLU
    }[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------


class Remat(torch.autograd.Function):
    """``fn(*tensors)`` whose backward recomputes it: the reference's
    ``jax.checkpoint``, written so that ``torch.func`` goes through it.

    ``torch.utils.checkpoint`` cannot sit under ``torch.func.vmap(grad)``
    (the non-reentrant form uses saved-tensor hooks, the reentrant one has
    no ``setup_context``). This Function saves only its tensor inputs; its
    forward runs ``fn`` without recording anything, its backward runs it
    again under ``torch.func.vjp``. Under ``vmap`` PyTorch derives the
    batched rule from these (``generate_vmap_rule``). ``fn`` takes every
    other argument from its closure (which must hold no tensor the caller
    differentiates or vmaps), returns one tensor or a tuple of them (an
    MoE block's output and aux loss) and draws no random numbers.
    Gradients flow to the floating-point inputs."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grad_outs):
        args = ctx.saved_tensors
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def again(*primals):
            full = list(args)
            for i, t in zip(diff, primals):
                full[i] = t
            return ctx.fn(*full)

        _, pull = torch.func.vjp(again, *(args[i] for i in diff))
        grads = [None] * len(args)
        cot = grad_outs[0] if len(grad_outs) == 1 else grad_outs
        for i, g in zip(diff, pull(cot)):
            grads[i] = g
        return (None, *grads)


def param_tree(names: Sequence[str], leaves: Sequence[torch.Tensor]
               ) -> Dict:
    """Dotted parameter names and their tensors -> the nested dict the
    layer functions read (``p["attn"]["wq"]["w"]``)."""
    root: Dict = {}
    for name, t in zip(names, leaves):
        *path, last = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return root


def remat_module(fn: Callable, params: nn.Module, x: torch.Tensor,
                 *extra: torch.Tensor):
    """``fn(tree, x, *extra)`` through :class:`Remat`, ``tree`` being
    ``params``' tensors (the swapped-in ones under
    ``torch.func.functional_call``) as a nested dict."""
    names, leaves = zip(*params.named_parameters())
    k = len(extra)
    return Remat.apply(
        lambda x_, *rest: fn(param_tree(names, rest[k:]), x_, *rest[:k]),
        x, *extra, *leaves)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Per-position CE in f32, written as ``lse - label_logit`` with the
    max held constant (the reference's ``stop_gradient``). Vocab padding
    lanes at or past ``valid_vocab`` are masked out. Under a TP context
    with the vocab sharded the logits are the rank's columns and the
    reductions are all-reduces (``tp.sharded_cross_entropy``)."""
    ctx = tp.vocab_active()
    if ctx is not None:
        return tp.sharded_cross_entropy(logits, labels, valid_vocab, ctx)
    logits = logits.float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        pad_mask = torch.arange(logits.shape[-1],
                                device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad_mask, -1e30)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - label_logit


def _chunk_ce(xc, out_embed, lc, valid_vocab):
    return softmax_cross_entropy(xc @ out_embed, lc, valid_vocab)


def chunked_cross_entropy(x: torch.Tensor, out_embed: torch.Tensor,
                          labels: torch.Tensor, valid_vocab: int,
                          chunk: int = 4096) -> torch.Tensor:
    """CE over huge vocabs without materializing full [T, V] logits.

    x: [T, d]; out_embed: [d, V] (the rank's [d, V_local] columns under a
    TP context); labels: [T] -> per-token loss [T]. Each
    chunk of ``chunk`` tokens computes its logits inside :class:`Remat`,
    so backward recomputes them (the reference's ``jax.checkpoint`` scan
    body). The reference zero-pads T up to a multiple of ``chunk``; here
    the last chunk is ragged instead, which gives the same losses (rows
    never mix) without the padded rows' logits.
    """
    out = []
    for lo in range(0, x.shape[0], chunk):
        args = (x[lo:lo + chunk], out_embed, labels[lo:lo + chunk])
        out.append(Remat.apply(lambda *a: _chunk_ce(*a, valid_vocab), *args)
                   if torch.is_grad_enabled() else _chunk_ce(*args,
                                                             valid_vocab))
    return torch.cat(out)
