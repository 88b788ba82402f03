"""Flash attention forward: causal + sliding window + GQA + tanh softcap.
Reference: ``src/repro/kernels/flash_attention.py`` (``flash_attention``,
the TPU kernel this module's CUDA kernel replaces; its public wrapper
``ops.flash_attention_bshd`` takes the ``[B, S, H, D]`` layout used here)
and ``ref.reference_attention`` (the oracle).

``flash_attention(q, k, v)`` with q ``[B, S, H, D]`` and k/v ``[B, S, KV, D]``
returns ``[B, S, H, D]`` in q's dtype: softmax over keys of
``softcap(q k^T / sqrt(D))`` under the mask ``0 <= qpos - kpos`` (causal)
and ``qpos - kpos < window`` (window > 0), KV head ``h // (H // KV)``,
f32 accumulation. Prefill routes every layer's attention through it.

* CUDA tensors go to the hand-written kernels ``csrc/flash_attention.cu``
  (head dims 16, 32, 64, 128 and 256; any S) or raise: bf16 to the tensor-core
  kernel, which reads 16-byte rows (base pointers and the b, s, h strides
  of q, k and v must be multiples of 8 elements), f32 to the f32 one.
* CPU tensors go to :func:`flash_attention_plain`, the same function in
  plain PyTorch (full f32 softmax), which the kernel is held to on the card.
* ``use_kernel=False`` selects the plain version on either device.

``launches`` counts kernel launches (and nothing else); a launch recorded
in a CUDA-graph capture counts once per replay (``kernels.counters``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_GRID_YZ_MAX = 65535
_lib = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch, f32 math: q [B, S, H, D], k/v [B, S, KV, D] ->
    [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [B, S, H, D] and k/v one [B, S, KV, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q/k/v must share one of {list(_DTYPE_CODE)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """Causal / windowed / softcapped GQA attention in [B, S, H, D]."""
    _check(q, k, v)
    if not use_kernel or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return _flash_cuda(q, k, v, causal, int(window), float(softcap))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = (
            [i32, vp, vp, vp, vp, i32, i32, i32, i32, i32] + [i64] * 9
            + [i32, i32, ctypes.c_float, ctypes.c_float, vp])
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _flash_cuda(q, k, v, causal: bool, window: int,
                softcap: float) -> torch.Tensor:
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernel runs on CUDA tensors, "
                         f"not {q.device}")
    b, s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes "
                         f"{_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous last (head_dim) axis")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))
            for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel reads 16-byte rows: the base "
                         "pointers of q, k and v must be 16-byte aligned and "
                         "their b, s and h strides multiples of 8 elements")
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel grid's "
                         f"{_GRID_YZ_MAX}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _load()
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    err = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, k.shape[2], d, *strides, int(causal), window,
        1.0 / math.sqrt(d), softcap, _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out
