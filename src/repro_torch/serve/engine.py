"""The serve engine: continuous batching over the paged KV cache.
Reference: ``src/repro/serve/engine.py`` (``ServeEngine.run`` with the
``continuous`` and ``static`` policies and both clocks, ``ServeReport``,
``CompletedRequest``, ``validate_request``, ``pages_needed``, ``_metrics``).

One engine owns a bucketed prefill (one shape per power-of-two prompt
bucket) and a single decode step over all ``num_slots`` slots
(``paged_model``). The host loop is the scheduler: it admits requests from
the open-loop arrival queue whenever a slot AND enough pool pages are free
(continuous batching), or only when the whole batch has drained
(``policy="static"``), and evicts at decode-step granularity.

Two clocks: ``"wall"`` (real seconds, the measurement path) and
``"virtual"`` (fixed units per step, the test path).

A decode step costs one packed int32 host->device transfer
(``[last_token, len, *page_table_row]`` per slot) and one ``[S]`` int32
device->host read; an admission one packed transfer and one scalar read.
Those reads are also what fences the device inside each span.

On the card the decode step is one captured CUDA graph per engine
(``core.step_graph.StepGraph``; its shapes are static and it reads the
page table on the device): each step copies the packed state into the
graph's static ``[slots, 2 + max_pages]`` buffer and replays it over the
engine's pool, which persists across runs (zeroed at the start of each).
``decode_compiles`` counts its captures: 1, the reference's contract.
``decode_graph=False`` runs the step eagerly (the comparison runs), and
the CPU always does. Prefill stays eager, one shape per bucket.

Not ported yet, and refused with ``NotImplementedError`` naming the slice
that brings them: ``mesh_model > 1`` (tensor-parallel decode, ROADMAP
Queue 1 item 8; the trainer's tensor parallelism is ported), ``faults``
(chaos), ``slo`` (admission gate), ``metrics`` (the telemetry registry),
``restore_params`` (checkpoint bridge) and ``StepSession`` (the router's
per-replica surface).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.step_graph import StepGraph
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import as_tracer
from repro_torch.serve import pages as pages_lib
from repro_torch.serve import trace as trace_lib
from repro_torch.serve.paged_model import (build_paged_decode,
                                           build_paged_prefill,
                                           supports_paged)

SERVE_POLICIES = ("continuous", "static")


@dataclasses.dataclass
class CompletedRequest:
    rid: int
    arrival: float
    admitted: float
    first_token: float
    finish: float
    prompt_len: int
    tokens: List[int]
    preemptions: int = 0

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival


@dataclasses.dataclass
class ServeReport:
    policy: str
    completed: List[CompletedRequest]
    metrics: Dict[str, float]
    events: List[Dict[str, Any]]
    # requests the engine refused instead of wedging on — each entry
    # {"rid", "reason", "t"} (reasons: "queue_overflow", "pool_exhausted")
    rejected: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def tokens_by_rid(self) -> Dict[int, List[int]]:
        return {c.rid: list(c.tokens) for c in self.completed}


class _Slot:
    __slots__ = ("req", "admitted", "first_token", "tokens", "last_token",
                 "length", "produced", "preemptions")

    def __init__(self, req, admitted, first_token, first_tok_id, preemptions):
        self.req = req
        self.admitted = admitted
        self.first_token = first_token
        self.tokens = [first_tok_id]
        self.last_token = first_tok_id
        self.length = req.prompt_len      # positions with K/V written
        self.produced = 1                 # prefill samples the first token
        self.preemptions = preemptions


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (it comes with the "
        f"{slice_name} slice)")


class ServeEngine:
    """Continuous-batching inference over a paged, optionally int8, pool.

    ``model`` is a :class:`~repro_torch.models.transformer.TransformerLM`
    built for ``model_cfg`` on ``device`` (``None`` means ``cuda``; pass
    ``device="cpu"`` to serve on the CPU). ``use_kernel=False`` swaps the
    hand-written kernels for their plain versions (used by the tests and
    the kernel-vs-plain comparison only). ``decode_graph`` (default: on
    the card) replays decode as a captured CUDA graph; True on the CPU
    raises."""

    def __init__(self, model_cfg, model, *, num_slots: int = 4,
                 page_size: int = 8, max_prompt_len: int = 32,
                 max_new_cap: int = 32, num_pages: Optional[int] = None,
                 cache_int8: bool = False, mesh_model: int = 1,
                 use_kernel: bool = True, device=None,
                 clock: str = "wall", step_time: float = 1.0,
                 prefill_time: float = 1.0, faults: Optional[str] = None,
                 eos_id: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 strict_capacity: bool = True,
                 slo=None, tracer=None, metrics=None,
                 decode_graph: Optional[bool] = None):
        ok, why = supports_paged(model_cfg)
        if not ok:
            raise ValueError(f"paged serving unsupported: {why}")
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual' (got {clock})")
        if mesh_model > 1:
            # the trainer's TP plan and hooks exist; the paged decode's
            # sharded caches do not yet
            raise _not_ported("tensor-parallel decode (mesh_model > 1)",
                              "distributed serving (ROADMAP Queue 1 item 8)")
        if faults:
            raise _not_ported("serve chaos injection (faults=)",
                              "fault-tolerance")
        if slo is not None:
            raise _not_ported("the SLO admission gate (slo=)",
                              "serving resilience")
        if metrics is not None:
            raise _not_ported("the metrics registry (metrics=)", "telemetry")
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model.cfg != model_cfg:
            raise ValueError("model was built for another config than "
                             "model_cfg")
        if model_device != self.device:
            raise ValueError(f"model lives on {model_device}, the engine "
                             f"serves on {self.device}")
        self.cfg = model_cfg
        self.model = model
        self.tracer = as_tracer(tracer)
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self.clock = clock
        self.step_time = step_time
        self.prefill_time = prefill_time
        self.eos_id = eos_id
        self.page_size = page_size
        self.max_queue = max_queue
        self.max_bucket = trace_lib.bucket_for(max_prompt_len,
                                               floor=page_size, cap=1 << 30)
        self.max_new_cap = max_new_cap
        max_pages = pages_lib.pages_for(self.max_bucket + max_new_cap,
                                        page_size)
        if num_pages is None:
            num_pages = num_slots * max_pages + 1
        if strict_capacity and num_pages - 1 < max_pages:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one request "
                f"({max_pages} pages + the trash page); pass "
                f"strict_capacity=False to degrade to rejection instead")
        self.pool_cfg = pages_lib.PoolConfig(
            num_layers=model_cfg.num_layers,
            kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.resolved_head_dim,
            num_pages=num_pages, page_size=page_size, num_slots=num_slots,
            max_pages_per_slot=max_pages, quantized=cache_int8)
        self._decode = build_paged_decode(model, quantized=cache_int8,
                                          use_kernel=use_kernel)
        self._prefill = build_paged_prefill(model, quantized=cache_int8,
                                            use_kernel=use_kernel)
        self._buckets_run: set = set()
        self._decode_ran = False
        self.pool_bytes = 0
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        if decode_graph is None:
            decode_graph = self.device.type == "cuda"
        self._decode_graph = (StepGraph(self._decode_on_static, self.device)
                              if decode_graph else None)

    def _decode_on_static(self, static):
        return {"tokens": self._decode(static["state"], self._bufs)}

    def _decode_step(self, state: np.ndarray) -> torch.Tensor:
        """One decode step over every slot from the packed host state
        ``[slots, 2 + max_pages]`` int32: the next tokens ``[slots]`` on
        the device (a graph replay on the card)."""
        state_t = torch.from_numpy(state)
        if self._decode_graph is None:
            return self._decode(state_t.to(self.device), self._bufs)
        weights_and_pool = [*self.model.parameters(), *self._bufs.values()]
        return self._decode_graph({"state": state_t},
                                  weights_and_pool)["tokens"]

    # -- shape counters (the reference's compile counters) -------------------

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill buckets run (PyTorch has no jit to count)."""
        return len(self._buckets_run)

    @property
    def decode_compiles(self) -> int:
        """Captures of the decode graph (1 once decode ran); eager: 1 once
        decode ran."""
        if self._decode_graph is not None:
            return self._decode_graph.captures
        return int(self._decode_ran)

    # -- clock ----------------------------------------------------------------

    def _now(self) -> float:
        if self.clock == "wall":
            return time.perf_counter() - self._t0
        return self._vnow

    def _advance_to(self, t: float) -> None:
        if self.clock == "wall":
            dt = t - self._now()
            if dt > 0:
                time.sleep(dt)
        else:
            self._vnow = max(self._vnow, t)

    def _advance_decode(self) -> None:
        if self.clock == "virtual":
            self._vnow += self.step_time

    def _advance_prefill(self) -> None:
        if self.clock == "virtual":
            self._vnow += self.prefill_time

    # -- request geometry ------------------------------------------------------

    def validate_request(self, r: trace_lib.Request) -> None:
        if r.prompt_len > self.max_bucket:
            raise ValueError(f"request {r.rid}: prompt_len "
                             f"{r.prompt_len} > bucket cap "
                             f"{self.max_bucket}")
        if not 1 <= r.max_new <= self.max_new_cap:
            raise ValueError(f"request {r.rid}: max_new {r.max_new} "
                             f"outside [1, {self.max_new_cap}]")

    def pages_needed(self, req: trace_lib.Request) -> int:
        """Pages a request holds for its whole lifetime: the prefill
        scatter needs the full bucket, the decode tail the rest."""
        return max(
            trace_lib.bucket_for(req.prompt_len, floor=self.page_size,
                                 cap=self.max_bucket) // self.page_size,
            pages_lib.pages_for(req.prompt_len + req.max_new,
                                self.page_size))

    @property
    def page_capacity(self) -> int:
        """Most pages any single request can ever be granted."""
        return min(self.pool_cfg.num_pages - 1,
                   self.pool_cfg.max_pages_per_slot)

    # -- the serving loop -----------------------------------------------------

    @torch.inference_mode()
    def run(self, trace: Sequence[trace_lib.Request],
            policy: str = "continuous") -> ServeReport:
        """Serve ``trace`` to completion under ``torch.inference_mode``:
        no autograd graph is recorded, though the weights are trainable."""
        if policy not in SERVE_POLICIES:
            raise ValueError(f"policy must be one of {SERVE_POLICIES}")
        for r in trace:
            self.validate_request(r)
        pool = pages_lib.PagePool(self.pool_cfg, dtype=self.model.dtype,
                                  device=self.device, buffers=self._bufs)
        self._bufs = pool.buffers
        self.pool_bytes = pool.nbytes
        pending = collections.deque(
            sorted(trace, key=lambda r: (r.arrival, r.rid)))
        queue: collections.deque = collections.deque()
        active: Dict[int, _Slot] = {}
        free_slots = list(range(self.pool_cfg.num_slots - 1, -1, -1))
        completed: List[CompletedRequest] = []
        events: List[Dict[str, Any]] = []
        rejected: List[Dict[str, Any]] = []
        self._prefill_s = 0.0
        self._decode_s = 0.0
        wall_t0 = time.perf_counter()
        self._t0 = time.perf_counter()
        self._vnow = 0.0
        step_idx = 0

        def complete(slot: int, st: _Slot, now: float) -> None:
            pool.free_slot(slot)
            free_slots.append(slot)
            completed.append(CompletedRequest(
                rid=st.req.rid, arrival=st.req.arrival, admitted=st.admitted,
                first_token=st.first_token, finish=now,
                prompt_len=st.req.prompt_len, tokens=st.tokens,
                preemptions=st.preemptions))

        def reject(req: trace_lib.Request, reason: str, now: float) -> None:
            rejected.append({"rid": req.rid, "reason": reason,
                             "t": float(now)})
            events.append({"event": "reject", "rid": req.rid,
                           "reason": reason, "step": step_idx})

        while pending or queue or active:
            now = self._now()
            while pending and pending[0].arrival <= now:
                req = pending.popleft()
                if (self.max_queue is not None
                        and len(queue) >= self.max_queue):
                    reject(req, "queue_overflow", now)
                    continue
                queue.append(req)
            # -- admission ---------------------------------------------------
            may_admit = bool(queue) and (policy == "continuous"
                                         or not active)
            while may_admit and queue and free_slots:
                req = queue[0]
                need = self.pages_needed(req)
                if need > self.page_capacity:
                    # can never fit, even into an idle pool
                    queue.popleft()
                    reject(req, "pool_exhausted", now)
                    continue
                if not pool.can_alloc(need):
                    break
                queue.popleft()
                slot = free_slots.pop()
                st = self._admit(req, slot, need, pool)
                if st.produced >= req.max_new or (
                        self.eos_id is not None
                        and st.last_token == self.eos_id):
                    complete(slot, st, self._now())
                else:
                    active[slot] = st
            if not active:
                if pending:
                    self._advance_to(pending[0].arrival)
                    continue
                if queue:          # pool can hold any valid request when idle
                    raise RuntimeError("scheduler wedged: empty slots but "
                                       "queue not admissible")
                continue
            # -- one decode step over every slot -----------------------------
            n_slots = self.pool_cfg.num_slots
            state = np.zeros((n_slots, 2 + self.pool_cfg.max_pages_per_slot),
                             np.int32)
            for slot, st in active.items():
                state[slot, 0] = st.last_token
                state[slot, 1] = st.length
            state[:, 2:] = pool.page_table
            t_start = time.perf_counter()
            with self.tracer.span("serve/decode", step=step_idx,
                                  n_active=len(active)):
                next_tokens = self._decode_step(state).cpu().numpy()
            self._decode_ran = True
            self._decode_s += time.perf_counter() - t_start
            self._advance_decode()
            pool.note_occupancy()
            now = self._now()
            for slot in sorted(active):
                st = active[slot]
                st.length += 1
                tok = int(next_tokens[slot])
                st.tokens.append(tok)
                st.last_token = tok
                st.produced += 1
                if st.produced >= st.req.max_new or (
                        self.eos_id is not None and tok == self.eos_id):
                    del active[slot]
                    complete(slot, st, now)
            step_idx += 1

        metrics = self._metrics(trace, completed, pool, step_idx, events,
                                rejected=rejected)
        metrics["wall_time_s"] = time.perf_counter() - wall_t0
        metrics["prefill_s"] = self._prefill_s
        metrics["decode_s"] = self._decode_s
        metrics["rejected_slo_shed"] = 0
        return ServeReport(policy=policy, completed=completed,
                           metrics=metrics, events=events, rejected=rejected)

    def _admit(self, req, slot: int, need: int,
               pool: pages_lib.PagePool) -> _Slot:
        pool.alloc(slot, need)
        bucket = trace_lib.bucket_for(req.prompt_len, floor=self.page_size,
                                      cap=self.max_bucket)
        n_pages = bucket // self.page_size
        # [true_len, *page_ids, *bucket-padded tokens]: one transfer
        packed = np.zeros((1 + n_pages + bucket,), np.int32)
        packed[0] = req.prompt_len
        packed[1:1 + n_pages] = pool.page_table[slot, :n_pages]
        packed[1 + n_pages:1 + n_pages + req.prompt_len] = req.prompt
        admitted = self._now()
        with self.tracer.span("serve/admit", rid=req.rid):
            t_start = time.perf_counter()
            with self.tracer.span("serve/prefill", rid=req.rid,
                                  prompt_len=req.prompt_len):
                tok_dev = self._prefill(
                    torch.from_numpy(packed).to(self.device),
                    req.prompt_len, n_pages, self._bufs)
                first_tok = int(tok_dev.item())
            dt = time.perf_counter() - t_start
        self._buckets_run.add(bucket)
        self._prefill_s += dt
        self._advance_prefill()
        return _Slot(req, admitted, self._now(), first_tok, 0)

    def _metrics(self, trace, completed, pool, decode_steps, events,
                 rejected=()):
        lats = np.array([c.latency for c in completed] or [0.0])
        ttfts = np.array([c.ttft for c in completed] or [0.0])
        total_tokens = sum(len(c.tokens) for c in completed)
        t_end = max((c.finish for c in completed), default=0.0)
        t_start = min((r.arrival for r in trace), default=0.0)
        duration = max(t_end - t_start, 1e-9)
        return {
            "completed": len(completed),
            "total_tokens": total_tokens,
            "duration": duration,
            "tokens_per_s": total_tokens / duration,
            "p50_latency": float(np.percentile(lats, 50)),
            "p99_latency": float(np.percentile(lats, 99)),
            "p50_ttft": float(np.percentile(ttfts, 50)),
            "p99_ttft": float(np.percentile(ttfts, 99)),
            "mean_occupancy": pool.mean_occupancy(),
            "peak_pages": pool.peak_pages,
            "decode_steps": decode_steps,
            "preemptions": sum(1 for e in events if e["event"] == "preempt"),
            "prefill_compiles": self.prefill_compiles,
            "decode_compiles": self.decode_compiles,
            "rejected": len(rejected),
            "rejected_queue_overflow": sum(
                1 for r in rejected if r["reason"] == "queue_overflow"),
            "rejected_pool_exhausted": sum(
                1 for r in rejected if r["reason"] == "pool_exhausted"),
        }


class StepSession:
    """The router's per-replica admit/tick surface (reference:
    ``repro.serve.engine.StepSession``); not ported yet."""

    def __init__(self, engine: ServeEngine, name: str = ""):
        raise _not_ported("StepSession", "serving resilience")


def restore_params(directory: str, model_cfg, *, step: Optional[int] = None,
                   use_ema: bool = False):
    """Checkpoint -> serve bridge (reference:
    ``repro.serve.engine.restore_params``); not ported yet."""
    raise _not_ported("restore_params", "trainer and checkpoint")
