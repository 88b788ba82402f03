"""Page gather for paged decode attention, with fused int8 dequant.
Reference: ``src/repro/kernels/page_gather.py`` (``gather_pages``;
``gather_pages_reference`` is the function, ``gather_pages_pallas`` the
TPU kernel this module's CUDA kernel replaces).

``gather_pages(pool, page_table, scales)`` assembles, for every decode slot,
its pages of one layer's pool ``[P, ps, kv, hd]`` through the page table
``[B, maxp]`` into a contiguous ``[B, maxp * ps, kv, hd]`` view; with
``scales`` ``[P, ps, kv]`` (f16) the int8 payload is dequantized in the
same pass. Dead table entries point at the trash page 0.

* CUDA tensors go to the hand-written kernel ``csrc/page_gather.cu`` (one
  block per (slot, page), 16-byte vector copies; bandwidth-bound) or raise.
* CPU tensors go to :func:`gather_pages_plain`, the same function in plain
  PyTorch, which is also what the kernel is held to on the card.
* ``use_kernel=False`` selects the plain version on either device (the
  tests and ``chip_smoke.py``'s comparison phase).

``launches`` counts kernel launches (and nothing else); a launch recorded
in a CUDA-graph capture counts once per replay (``kernels.counters``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0

_FP_TYPES = (torch.float32, torch.bfloat16, torch.float16)
_DEQUANT_OUT = {torch.bfloat16: "page_gather_dequant_bf16",
                torch.float32: "page_gather_dequant_f32"}
_GRID_Y_MAX = 65535
_lib = None


def gather_pages_plain(pool: torch.Tensor, page_table: torch.Tensor,
                       scales: Optional[torch.Tensor] = None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch: pool [P, ps, kv, hd], page_table [B, maxp] ->
    [B, maxp*ps, kv, hd] (dead table entries gather the trash page)."""
    b, maxp = page_table.shape
    _, ps, kv, hd = pool.shape
    idx = page_table.long()
    g = pool[idx]                                   # [B, maxp, ps, kv, hd]
    if scales is not None:
        g = g.float() * scales[idx].float()[..., None]
    return g.reshape(b, maxp * ps, kv, hd).to(out_dtype)


def _check(pool, page_table, scales, out_dtype) -> None:
    if pool.dim() != 4:
        raise ValueError(f"pool must be [P, ps, kv, hd], got {tuple(pool.shape)}")
    if page_table.dim() != 2 or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be a 2-D int32 tensor, got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if page_table.device != pool.device:
        raise ValueError(f"page_table on {page_table.device}, pool on "
                         f"{pool.device}")
    if scales is None:
        if pool.dtype not in _FP_TYPES or out_dtype != pool.dtype:
            raise ValueError(f"fp gather copies the pool's own type: pool "
                             f"{pool.dtype} -> {out_dtype} is not supported")
        return
    if pool.dtype != torch.int8 or scales.dtype != torch.float16:
        raise ValueError(f"dequant gather takes an int8 pool and f16 scales, "
                         f"got {pool.dtype} and {scales.dtype}")
    if tuple(scales.shape) != tuple(pool.shape[:3]):
        raise ValueError(f"scales {tuple(scales.shape)} must be the pool's "
                         f"[P, ps, kv] = {tuple(pool.shape[:3])}")
    if scales.device != pool.device:
        raise ValueError(f"scales on {scales.device}, pool on {pool.device}")
    if out_dtype not in _DEQUANT_OUT:
        raise ValueError(f"dequant gather writes {list(_DEQUANT_OUT)}, "
                         f"not {out_dtype}")


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor,
                 scales: Optional[torch.Tensor] = None, *,
                 out_dtype=torch.float32,
                 use_kernel: bool = True) -> torch.Tensor:
    """Gather (and dequantize) one layer's pages for every slot."""
    _check(pool, page_table, scales, out_dtype)
    if not use_kernel or pool.device.type == "cpu":
        return gather_pages_plain(pool, page_table, scales, out_dtype)
    return _gather_cuda(pool, page_table, scales, out_dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("page_gather")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.page_gather_copy.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
        for name in _DEQUANT_OUT.values():
            getattr(lib, name).argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                           i32, vp]
            getattr(lib, name).restype = i32
        lib.page_gather_copy.restype = i32
        lib.page_gather_error_string.argtypes = [i32]
        lib.page_gather_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _gather_cuda(pool, page_table, scales, out_dtype) -> torch.Tensor:
    global launches
    if pool.device.type != "cuda":
        raise ValueError(f"the page-gather kernel runs on CUDA tensors, not "
                         f"{pool.device}")
    tensors = (pool, page_table) if scales is None else (pool, page_table,
                                                          scales)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("page gather needs contiguous pool, table and scales")
    b, maxp = page_table.shape
    num_pages, ps, kv, hd = pool.shape
    if b > _GRID_Y_MAX:
        raise ValueError(f"{b} slots exceed the kernel grid's {_GRID_Y_MAX}")
    out = torch.empty((b, maxp * ps, kv, hd), dtype=out_dtype,
                      device=pool.device)
    if out.numel() == 0:
        return out
    lib = _load()
    stream = _build.stream_ptr(pool.device)
    if scales is None:
        err = lib.page_gather_copy(
            pool.data_ptr(), page_table.data_ptr(), out.data_ptr(),
            ps * kv * hd * pool.element_size(), num_pages, b, maxp, stream)
    else:
        err = getattr(lib, _DEQUANT_OUT[out_dtype])(
            pool.data_ptr(), scales.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), ps * kv, hd, num_pages, b, maxp, stream)
    if err:
        raise RuntimeError(f"page_gather launch failed: "
                           f"{lib.page_gather_error_string(err).decode()}")
    launches += 1
    return out
