"""One step captured as a CUDA graph and replayed: the port's ``jax.jit``.

The reference dispatches K training steps as one ``lax.scan`` and compiles
the decode step once. PyTorch runs eagerly, one kernel launch per op from
the host, so the port's steps were bound by launches, not by the card. A
captured CUDA graph replays a whole step's kernels with one launch. It has
no reference file.

:class:`StepGraph` holds one step function ``fn(static) -> {name:
tensor}`` that reads its inputs only from ``static``, a dict of device
buffers the graph owns:

* each call copies the caller's inputs into the static buffers (device to
  device), then replays the graph; the outputs are the graph's static
  output tensors, overwritten by the next replay;
* the first call is the warmup: ``fn`` runs eagerly on the capture stream
  (a real step, whose outputs it returns), then ``torch.cuda.
  empty_cache()`` and the capture with ``torch.cuda.graph``, which runs
  nothing;
* the graph reads and writes the state tensors it saw at capture by
  address. Each call is handed the state tensors it must act on; when
  they are not the captured ones (a new model from ``init``, a new
  optimizer state or EMA), the graph is dropped and the call warms up and
  captures anew;
* the kernel wrappers' launch counts (``kernels.counters``) count what
  ran: the launches a capture records are taken back and added again on
  every replay.

It needs the card: it raises for any other device, and on the card it
never runs the step another way. :func:`chunk_step` builds the trainer's
K-step chunk from a step function: a graph replayed K times on the card,
a Python loop on the CPU.
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from repro_torch.kernels import counters

Tensors = Dict[str, torch.Tensor]


class StepGraph:
    """``fn`` captured once over static input buffers, then replayed."""

    def __init__(self, fn: Callable[[Tensors], Tensors], device,
                 pool=None):
        """``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
        graphs that never replay concurrently with this one (None: a
        private pool)."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph replays on the card, not on "
                             f"{device}; run the step as it is there")
        self.fn = fn
        self.device = device
        self.pool = pool
        self.static: Tensors = {}
        self.outputs: Optional[Tensors] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._refs: List[weakref.ref] = []
        self._ptrs: tuple = ()
        self._launches: counters.Counts = ()
        self.captures = 0          # captures so far (the compile count)
        self.capture_s = 0.0       # host seconds spent capturing
        self.replays = 0

    def reset(self) -> None:
        """Drop the captured graph and its outputs; the next call warms up
        and captures anew."""
        self.graph = self.outputs = None
        self._refs, self._ptrs, self._launches = [], (), ()

    def _captured(self, state: Sequence[torch.Tensor]) -> bool:
        return (len(state) == len(self._refs)
                and all(r() is t for r, t in zip(self._refs, state))
                and tuple(t.data_ptr() for t in state) == self._ptrs)

    def _load(self, inputs: Tensors) -> None:
        if not self.static:
            self.static = {k: torch.empty_like(v, device=self.device)
                           for k, v in inputs.items()}
        if inputs.keys() != self.static.keys():
            raise ValueError(f"inputs {sorted(inputs)} are not the "
                             f"captured {sorted(self.static)}")
        for k, v in inputs.items():
            buf = self.static[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"input {k!r}: {v.dtype} {tuple(v.shape)}, "
                                 f"captured {buf.dtype} {tuple(buf.shape)}")
            buf.copy_(v, non_blocking=True)

    def __call__(self, inputs: Tensors,
                 state: Sequence[torch.Tensor]) -> Tensors:
        """One step on ``inputs`` acting on ``state`` (the tensors the
        step updates in place, in a fixed order)."""
        state = list(state)
        if self.graph is not None and not self._captured(state):
            self.reset()
        self._load(inputs)
        if self.graph is None:
            return self._warm_up_and_capture(state)
        self.graph.replay()
        counters.add(self._launches)
        self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self, state: List[torch.Tensor]) -> Tensors:
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # the warmup runs where the capture will, so the stream's lazily
        # made resources (cuBLAS workspace) exist before the capture
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self.fn(self.static)
        cur.wait_stream(self._stream)
        for t in out.values():
            t.record_stream(cur)
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        # dead cycles (an earlier engine's graph, events) are freed now and
        # the cyclic collector stays off during the capture: a CUDA graph
        # or event destroyed while the stream captures invalidates it
        gc.collect()
        torch.cuda.empty_cache()
        before = counters.read()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self._stream):
                outputs = self.fn(self.static)
        finally:
            if collecting:
                gc.enable()
            self._launches = counters.since(before)
            counters.write(before)          # the capture launched nothing
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        self.graph, self.outputs = graph, outputs
        self._refs = [weakref.ref(t) for t in state]
        self._ptrs = tuple(t.data_ptr() for t in state)
        self.captures += 1
        return out


def train_state(model, opt_state: Dict[str, Tensors],
                ema: Optional[Tensors]) -> Iterable[torch.Tensor]:
    """The tensors a training step updates in place: the parameters, every
    optimizer state tensor and the EMA."""
    yield from model.parameters()
    for sub in opt_state.values():
        yield from sub.values()
    if ema is not None:
        yield from ema.values()


def chunk_step(step_fn: Callable, model) -> Callable:
    """K steps of ``step_fn(opt_state, ema, scalars, batch, mask) ->
    metrics`` over stacked inputs:

        chunk(opt_state, ema, scalars {name: [K]}, batches {name: [K,
              ...]}, masks [K, W]) -> metrics {name: [K]}

    On the card each step copies its row of every input into the
    :class:`StepGraph`'s buffers and replays the graph (the first step of
    the first chunk warms up and captures); its metrics are copied into
    row k of the outputs. On the CPU it calls ``step_fn`` K times.
    ``chunk.graph`` is the StepGraph (None on the CPU)."""
    device = torch.device(model.device)
    held: Dict[str, object] = {}

    def body(static: Tensors) -> Tensors:
        return step_fn(
            held["opt_state"], held["ema"],
            {k[7:]: v for k, v in static.items() if k.startswith("scalar/")},
            {k[6:]: v for k, v in static.items() if k.startswith("batch/")},
            static["mask"])

    graph = StepGraph(body, device) if device.type == "cuda" else None

    def chunk(opt_state, ema, scalars: Tensors, batches: Tensors,
              masks: torch.Tensor) -> Tensors:
        k = masks.shape[0]
        rows: Tensors = {}
        for i in range(k):
            inputs = {"mask": masks[i],
                      **{f"scalar/{n}": v[i] for n, v in scalars.items()},
                      **{f"batch/{n}": v[i] for n, v in batches.items()}}
            held["opt_state"], held["ema"] = opt_state, ema
            out = (body(inputs) if graph is None else
                   graph(inputs, train_state(model, opt_state, ema)))
            for name, v in out.items():
                if name not in rows:
                    rows[name] = torch.empty((k,), dtype=v.dtype,
                                             device=v.device)
                rows[name][i].copy_(v.detach())
        held.clear()
        return rows

    chunk.graph = graph
    return chunk
