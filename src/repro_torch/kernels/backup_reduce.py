"""Masked backup-worker gradient reduce (paper Alg. 4 line 7).
Reference: ``src/repro/kernels/backup_reduce.py`` (``backup_reduce``, the
TPU kernel this module's CUDA kernel replaces; its oracles are
``kernels/ref.reference_backup_reduce`` and
``kernels/bucketed_reduce.ref_masked_mean``).

``backup_reduce(grads, mask, n_aggregate)``: grads ``[W, P]`` f32 (rows
may be ``ld`` apart, e.g. a bucket sliced out of a wider stack), mask
``[W]`` -> ``[P]`` f32 ``(1/N) * sum_w mask_w * g_w``.

* It launches the hand-written kernel ``csrc/backup_reduce.cu`` (one pass
  over the stack, float4 loads where P, the row stride and both bases
  allow, the mask in shared memory; bandwidth-bound) and counts the launch
  in ``launches`` (a launch recorded in a CUDA-graph capture counts once
  per replay: ``kernels.counters``). It refuses CPU tensors: the caller picks the plain twin
  for those (``bucketed_reduce.reduce_then_psum``, ``use_kernel``).
* ``backup_reduce_plain`` is the same function in plain PyTorch with the
  kernel's arithmetic (ordered f32 sum over w, then one multiply by the
  f32 ``1/N``), so the two agree bit for bit on the card. It differs from
  the reference's dot (another summation order) within rtol 1e-6.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0

MAX_WORKERS = 12288          # the mask lives in 48 KB of shared memory
_lib = None


def inv_n_f32(n_aggregate: int) -> float:
    """1/N rounded to f32, the factor both versions multiply by."""
    return float(np.float32(1.0 / n_aggregate))


def backup_reduce_plain(grads: torch.Tensor, mask: torch.Tensor,
                        n_aggregate: int) -> torch.Tensor:
    """Plain PyTorch: ordered f32 sum of mask_w * g_w over w, times 1/N."""
    g = grads.float()
    m = mask.float()
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for w in range(g.shape[0]):
        acc = acc + m[w] * g[w]
    return acc * inv_n_f32(n_aggregate)


def uses_vec4(grads: torch.Tensor, out: torch.Tensor) -> bool:
    """True when the kernel takes its float4 path for these tensors (the
    C entry point decides by the same rule; this reports it)."""
    return (grads.shape[1] % 4 == 0 and grads.stride(0) % 4 == 0
            and grads.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("backup_reduce")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.backup_reduce_f32.argtypes = [vp, vp, vp, i32, i64, i64,
                                          ctypes.c_float, vp]
        lib.backup_reduce_f32.restype = i32
        lib.backup_reduce_error_string.argtypes = [i32]
        lib.backup_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def backup_reduce(grads: torch.Tensor, mask: torch.Tensor, n_aggregate: int,
                  *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: grads [W, P] f32 on the card (unit column
    stride), mask [W] -> [P] f32, written into ``out`` when given."""
    global launches
    if grads.device.type != "cuda":
        raise ValueError(f"the backup_reduce kernel runs on CUDA tensors, "
                         f"not {grads.device}; the CPU takes "
                         f"backup_reduce_plain")
    if grads.dim() != 2 or grads.dtype != torch.float32:
        raise ValueError(f"grads must be a 2-D f32 [W, P] tensor, got "
                         f"{grads.dtype} {tuple(grads.shape)}")
    w, p = grads.shape
    if p > 1 and grads.stride(1) != 1:
        raise ValueError("grads must have unit stride along P")
    if not 1 <= w <= MAX_WORKERS:
        raise ValueError(f"the kernel reduces 1..{MAX_WORKERS} workers, got "
                         f"{w}")
    if mask.shape != (w,) or mask.device != grads.device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} does "
                         f"not match grads {tuple(grads.shape)} on "
                         f"{grads.device}")
    if out is None:
        out = torch.empty(p, dtype=torch.float32, device=grads.device)
    elif (out.shape != (p,) or out.dtype != torch.float32
          or out.device != grads.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous f32 [{p}] tensor on "
                         f"{grads.device}")
    if p == 0:
        return out
    m = mask.to(torch.float32).contiguous()
    lib = _load()
    err = lib.backup_reduce_f32(
        grads.data_ptr(), m.data_ptr(), out.data_ptr(), w, p,
        grads.stride(0), inv_n_f32(n_aggregate),
        _build.stream_ptr(grads.device))
    if err:
        raise RuntimeError(f"backup_reduce launch failed: "
                           f"{lib.backup_reduce_error_string(err).decode()}")
    launches += 1
    return out
