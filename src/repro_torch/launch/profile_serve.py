"""Where the serve path's time goes on the card: a torch.profiler window.

    python -m repro_torch.launch.profile_serve [--graph]

Builds qwen3-0.6b at full width (28 layers, bf16, seeded random weights)
and, for an fp pool and then an int8 pool, fills all 8 decode slots of a
``ServeEngine``'s pool with a 512-token context and profiles

* 20 decode steps over all slots (the engine's eager decode function,
  with its one packed host->device transfer and one token read per step),
* with ``--graph``, 20 decode steps through the engine's own graph decode
  (``ServeEngine._decode_step``: the state copied into its captured CUDA
  graph's buffer, one replay, one token read; the capture's time is
  printed),
* three 512-token prefills (eager, as the engine runs them),

printing, per phase: host wall ms per call (unprofiled and profiled),
device busy ms per call (the union of the kernel and copy intervals on the
card), the device's idle share of the profiled wall time, kernel launches
per call, the kernels ranked by device time, the ops ranked by the device
time of the kernels they launched (kernels launched through ctypes have no
op above them and show only in the kernel list), and the ops ranked by
self host time. Runs under ``torch.inference_mode`` (no autograd graph),
as the serve path does. Needs a card. When the profiler shows no kernel
inside a graph replay, the device time printed is the CUDA-event span of
the calls (gaps between kernels included), and the line says so.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.serve import PagePool, ServeEngine

SLOTS = 8
CONTEXT = 512
DECODE_STEPS = 20
PREFILLS = 3
TOP = 15
_LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")
_GRAPH_LAUNCH_API = ("cudaGraphLaunch", "cuGraphLaunch")


def _on_device(e) -> bool:
    """A kernel or copy on the card (not the device span of a
    ``record_function`` range, which the profiler also lists there)."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _busy_us(events) -> float:
    """Length of the union of the device intervals (kernels, copies)."""
    return _union_us((e.time_range.start, e.time_range.end) for e in events
                     if _on_device(e))


def _top(title: str, rows, key, calls: int) -> None:
    print(f"    {title} (us per call, count per call):")
    for e in sorted(rows, key=key, reverse=True)[:TOP]:
        print(f"    {key(e) / calls:10.1f}  x{e.count / calls:6.1f}  "
              f"{e.key[:140]}")


def _report(name: str, prof, wall_s: float, plain_wall_s: float,
            calls: int, span_ms: float) -> None:
    """``calls`` is what the figures are per (calls, or steps); ``span_ms``
    the CUDA-event span of the unprofiled calls, printed in place of the
    device busy time when the profiler saw no kernel."""
    avgs = prof.key_averages()
    busy_ms = _busy_us(prof.events()) / 1e3 / calls
    launches = sum(e.count for e in avgs if e.key in _LAUNCH_API)
    graphs = sum(e.count for e in avgs if e.key in _GRAPH_LAUNCH_API)
    wall_ms = 1e3 * wall_s / calls
    if busy_ms > 0:
        device = (f"device busy {busy_ms:.3f} ms/call | device idle share "
                  f"(profiled window) {1 - busy_ms / wall_ms:.3f}")
    else:
        device = (f"device busy not seen by the profiler; CUDA-event span "
                  f"of the unprofiled calls {span_ms / calls:.3f} ms/call "
                  f"(gaps included)")
    print(f"[{name}] host wall {1e3 * plain_wall_s / calls:.3f} ms/call "
          f"unprofiled, {wall_ms:.3f} profiled | {device} | kernel launch "
          f"API calls {launches / calls:.1f}/call, graph launches "
          f"{graphs / calls:.1f}/call")
    kernels = [e for e in avgs if _on_device(e)]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU]
    _top("kernels by device time", kernels,
         lambda e: e.self_device_time_total, calls)
    _top("ops by device time of the kernels they launched", ops,
         lambda e: e.self_device_time_total, calls)
    _top("ops by self host time", ops, lambda e: e.self_cpu_time_total,
         calls)


def _profile(name: str, fn, calls: int, per_call: int = 1):
    """Warm up, time ``calls`` calls unprofiled, then profile ``calls``
    more and print the report per ``per_call``-th of a call (a chunk's
    steps); returns the profile."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    span_ms = start.elapsed_time(end)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(name, prof, wall, plain_wall, calls * per_call, span_ms)
    return prof


@torch.inference_mode()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", action="store_true",
                    help="also profile decode as a captured CUDA graph")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = configs.get_config("qwen3-0.6b")
    model = get_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    for int8 in (False, True):
        tag = "int8" if int8 else "fp"
        eng = ServeEngine(cfg, model, num_slots=SLOTS, page_size=16,
                          max_prompt_len=CONTEXT, max_new_cap=128,
                          cache_int8=int8, decode_graph=args.graph)
        pc = eng.pool_cfg
        pool = PagePool(pc, dtype=model.dtype, device=dev)
        for slot in range(pc.num_slots):
            pool.alloc(slot, pc.max_pages_per_slot)
        state = np.zeros((pc.num_slots, 2 + pc.max_pages_per_slot), np.int32)
        state[:, 0] = np.arange(pc.num_slots)
        state[:, 1] = CONTEXT
        state[:, 2:] = pool.page_table
        n_pages = CONTEXT // pc.page_size
        packed = np.zeros((1 + n_pages + CONTEXT,), np.int32)
        packed[0] = CONTEXT
        packed[1:1 + n_pages] = pool.page_table[0, :n_pages]

        eng._bufs = pool.buffers

        def step():
            eng._decode(torch.from_numpy(state).to(dev), eng._bufs).cpu()

        def graph_step():
            eng._decode_step(state).cpu()

        def prefill():
            eng._prefill(torch.from_numpy(packed).to(dev), CONTEXT, n_pages,
                         pool.buffers).item()

        print(f"[profile] {torch.cuda.get_device_name(0)} torch "
              f"{torch.__version__} | qwen3-0.6b {cfg.num_layers} layers "
              f"bf16, {pc.num_slots} slots x {pc.max_pages_per_slot} pages "
              f"of {pc.page_size}, {tag} pool")
        _profile(f"decode {tag}", step, DECODE_STEPS)
        if args.graph:
            _profile(f"decode {tag} graph", graph_step, DECODE_STEPS)
            graph = eng._decode_graph
            print(f"[decode {tag} graph] {graph.captures} capture, "
                  f"{graph.capture_s:.3f} s (the capture alone); peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated()} bytes allocated, "
                  f"{torch.cuda.max_memory_reserved()} reserved")
        _profile(f"prefill{CONTEXT} {tag}", prefill, PREFILLS)


if __name__ == "__main__":
    main()
