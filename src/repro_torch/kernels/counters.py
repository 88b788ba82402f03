"""The kernel wrappers' launch counts, read and advanced as one vector.

Each wrapper adds one to a module-level count where it launches its
kernel (``page_gather.launches``, ``flash_attention.launches``,
``backup_reduce.launches``, ``rwkv6_scan.launches_fwd`` /
``launches_fwd_states`` / ``launches_bwd``), and so does the tensor
parallelism's all-reduce and vocab all-gather (``distributed.tp.
all_reduces`` / ``all_gathers``). Under
CUDA-graph capture a wrapper call records its kernel and launches nothing:
``core.step_graph.StepGraph`` takes back what the capture added and adds
it again on every replay, so each count is the launches the card ran.
"""
from __future__ import annotations

import importlib
from typing import Tuple

COUNTERS = (("page_gather", "launches"), ("flash_attention", "launches"),
            ("backup_reduce", "launches"), ("rwkv6_scan", "launches_fwd"),
            ("rwkv6_scan", "launches_fwd_states"),
            ("rwkv6_scan", "launches_bwd"),
            ("repro_torch.distributed.tp", "all_reduces"),
            ("repro_torch.distributed.tp", "all_gathers"))

Counts = Tuple[int, ...]


def _module(name: str):
    return importlib.import_module(
        name if "." in name else f"repro_torch.kernels.{name}")


def read() -> Counts:
    return tuple(getattr(_module(m), a) for m, a in COUNTERS)


def write(counts: Counts) -> None:
    for (m, a), n in zip(COUNTERS, counts):
        setattr(_module(m), a, n)


def add(counts: Counts) -> None:
    write(tuple(a + b for a, b in zip(read(), counts)))


def since(before: Counts) -> Counts:
    return tuple(a - b for a, b in zip(read(), before))
