"""Paged KV cache: fixed-size pages allocated per request from a shared pool.
Reference: ``src/repro/serve/pages.py``.

The device side is one stacked tensor per buffer on the engine's device —
``k``/``v`` of shape ``[L, num_pages, page_size, kv_heads, head_dim]``
(plus f16 scale tables ``[L, num_pages, page_size, kv_heads]`` when
quantized) — shared by every layer through one host page table: a
request's logical page ``i`` is the same physical page id in every layer.

Physical page 0 is the **trash page**: the allocator never hands it out,
and idle decode slots (zeroed page-table rows) scatter their dead writes
there. Allocation is host bookkeeping identical to the reference's. The
port updates the device buffers in place (``serve/paged_model.py``), where
the reference returns new arrays, which saves a pool-sized copy per step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static geometry of a page pool (one per ServeEngine)."""

    num_layers: int
    kv_heads: int
    head_dim: int
    num_pages: int                 # total physical pages incl. the trash page
    page_size: int                 # tokens per page (power of two)
    num_slots: int                 # concurrent decode slots
    max_pages_per_slot: int        # page-table width (static decode shape)
    quantized: bool = False        # int8 payload + per-(pos, head) f16 scales

    def __post_init__(self):
        if self.page_size & (self.page_size - 1):
            raise ValueError(f"page_size must be a power of two "
                             f"(got {self.page_size})")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")

    @property
    def tokens_per_slot(self) -> int:
        return self.max_pages_per_slot * self.page_size


class PagePool:
    """Host allocator + device buffers for the paged KV cache."""

    def __init__(self, pool_cfg: PoolConfig, dtype=torch.float32,
                 device="cpu", *,
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        """``buffers``: an earlier pool's buffers of this config, zeroed and
        reused in place (so a captured decode graph keeps reading them)."""
        self.cfg = pool_cfg
        c = pool_cfg
        shape = (c.num_layers, c.num_pages, c.page_size, c.kv_heads,
                 c.head_dim)
        payload_dtype = torch.int8 if c.quantized else dtype
        if buffers is not None:
            for t in buffers.values():
                t.zero_()
            self.buffers = buffers
        else:
            bufs: Dict[str, torch.Tensor] = {
                "k": torch.zeros(shape, dtype=payload_dtype, device=device),
                "v": torch.zeros(shape, dtype=payload_dtype, device=device),
            }
            if c.quantized:
                bufs["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float16,
                                              device=device)
                bufs["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float16,
                                              device=device)
            self.buffers = bufs
        # -- host bookkeeping: page 0 reserved as the trash page ------------
        self._free: List[int] = list(range(c.num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}
        self.page_table = np.zeros((c.num_slots, c.max_pages_per_slot),
                                   np.int32)
        self.peak_pages = 0
        self._occupancy_sum = 0.0
        self._occupancy_n = 0

    @property
    def nbytes(self) -> int:
        """Device bytes held by the pool's buffers."""
        return sum(t.numel() * t.element_size() for t in self.buffers.values())

    # -- allocation -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.cfg.num_pages - 1) - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, slot: int, n: int) -> np.ndarray:
        """Reserve ``n`` pages for ``slot``; returns their physical ids."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        if n > self.cfg.max_pages_per_slot:
            raise ValueError(
                f"request needs {n} pages but the page table is only "
                f"{self.cfg.max_pages_per_slot} wide")
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: need {n} pages, {len(self._free)} free")
        ids = np.array([self._free.pop() for _ in range(n)], np.int32)
        self._owned[slot] = list(ids)
        self.page_table[slot, :n] = ids
        self.page_table[slot, n:] = 0
        self.peak_pages = max(self.peak_pages, self.used_pages)
        return ids

    def try_alloc(self, slot: int, n: int) -> Optional[np.ndarray]:
        """:meth:`alloc` that returns ``None`` instead of raising when ``n``
        pages cannot be reserved."""
        if (slot in self._owned or n > self.cfg.max_pages_per_slot
                or n > len(self._free)):
            return None
        return self.alloc(slot, n)

    def free_slot(self, slot: int) -> None:
        """Return ``slot``'s pages to the pool (evict/complete)."""
        for pid in self._owned.pop(slot, []):
            self._free.append(pid)
        self.page_table[slot] = 0

    # -- occupancy telemetry --------------------------------------------------

    def occupancy(self) -> float:
        return self.used_pages / (self.cfg.num_pages - 1)

    def note_occupancy(self) -> None:
        self._occupancy_sum += self.occupancy()
        self._occupancy_n += 1

    def mean_occupancy(self) -> float:
        return self._occupancy_sum / max(self._occupancy_n, 1)


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` positions."""
    return -(-tokens // page_size)
