"""The serve engine: continuous batching over the paged KV cache.
Reference: ``src/repro/serve/engine.py`` (``ServeEngine.run`` with the
``continuous`` and ``static`` policies, both clocks, chaos, the SLO gate
and the metrics mirror, ``ServeReport``, ``CompletedRequest``,
``validate_request``, ``pages_needed``, ``_metrics``, ``StepSession`` and
``restore_params``).

One engine owns a bucketed prefill (one shape per power-of-two prompt
bucket) and a single decode step over all ``num_slots`` slots
(``paged_model``). The host loop is the scheduler: it admits requests from
the open-loop arrival queue whenever a slot AND enough pool pages are free
(continuous batching), or only when the whole batch has drained
(``policy="static"``), and evicts at decode-step granularity: on
completion, and under the chaos engine's ``preempt`` fault (``faults=``,
``core.faults``' grammar, ``slowdown`` and ``preempt`` only), which throws
every in-flight request back to the queue (recomputed on readmission;
greedy decode makes the retry token-identical). ``slo=``
(``serve.slo.SLOConfig``) gates arrivals on the windowed p99 of the
engine's own clock; ``metrics=`` (``obs.MetricsRegistry``) mirrors the
report into the ``serve/*`` schema.

Two clocks: ``"wall"`` (real seconds, the measurement path; a chaos
slowdown stretches each decode step by sleeping the residual) and
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

:class:`StepSession` is one replica of the replica router
(``serve.router``): it shares the engine's weights and prefill / decode
functions but owns its pool, page table and slots, and on the card its own
decode graph, captured over its own pool (R sessions never share one).

:func:`restore_params` is the checkpoint -> serve bridge: the ``params``
(or ``ema``) subtree of a training checkpoint (the reference's format,
written by either package; replicated, TP and sim checkpoints are all
stored full) loaded into a model for the engine.

``mesh_model = M > 1`` is tensor-parallel serving (the reference's
``shard_map`` over the mesh ``'model'`` axis). The port has no single
controller over M devices: every rank of a ``torch.distributed`` world of
``D x M`` ranks (``distributed.mesh``: ``spawn``, or a ``torchrun`` world
joined with ``mesh.join``) builds the engine over the same full model and
runs the same host scheduler on the same trace. The engine cuts the model
to the rank's slice (``convert.shard_model`` with ``sharding.tp_plan``;
``tp_plan`` is an attribute, as in the reference), holds its slice of the
pool (the kv-head axis when attention shards) and runs
``paged_model.build_tp_paged_fns``; rank 0 reports. On the wall clock each
reading is the model group's first rank's (a broadcast), so every rank
takes the same admission decisions. Outside a world of at least M ranks it
raises ``ValueError``. Under NCCL (a card a rank) the decode graph captures
the model group's all-reduces and the vocab all-gather (the prefills and
the graph's eager first call make the communicator live first); a gloo
world on the card (ranks sharing one) cannot capture, so ``decode_graph``
defaults to off there and ``True`` raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults as faults_lib
from repro_torch.core.step_graph import StepGraph
from repro_torch.distributed import mesh, tp
from repro_torch.distributed.spmd_engine import resolve_tp
from repro_torch.models import from_jax_tree, get_model, to_jax_tree
from repro_torch.models.common import resolve_device
from repro_torch.models.convert import load_named, shard_model
from repro_torch.obs.trace import as_tracer
from repro_torch.serve import pages as pages_lib
from repro_torch.serve import trace as trace_lib
from repro_torch.serve.paged_model import (build_paged_decode,
                                           build_paged_prefill,
                                           build_tp_paged_fns,
                                           supports_paged)
from repro_torch.serve.slo import SLOController

SERVE_FAULT_KINDS = ("slowdown", "preempt")
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


def _model_group(mesh_model: int):
    """This rank's ``'model'`` group of the world's D x M mesh; a
    ``ValueError`` outside a world of a multiple of M ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < mesh_model or world % mesh_model:
        raise ValueError(
            f"mesh_model={mesh_model} needs {mesh_model} devices: a "
            f"torch.distributed world of {mesh_model} ranks (or a multiple), "
            f"one a device, and this process is in "
            f"{f'a world of {world}' if world else 'none'}; start the ranks "
            f"with repro_torch.distributed.mesh.spawn(..., "
            f"mesh_model={mesh_model}) or torchrun, then mesh.join")
    return mesh.model_group(world // mesh_model, mesh_model)


class ServeEngine:
    """Continuous-batching inference over a paged, optionally int8, pool.

    ``model`` is a :class:`~repro_torch.models.transformer.TransformerLM`
    built for ``model_cfg`` on ``device`` (``None`` means ``cuda``; pass
    ``device="cpu"`` to serve on the CPU). ``use_kernel=False`` swaps the
    hand-written kernels for their plain versions (used by the tests and
    the kernel-vs-plain comparison only). ``decode_graph`` (default: on
    the card, over NCCL under TP) replays decode as a captured CUDA graph;
    True on the CPU, or over gloo on the card, raises. ``mesh_model > 1``
    serves tensor-parallel over the model group of this rank (see the
    module docstring); ``model`` then holds the full weights, and the
    engine cuts it to the rank's slice in place. ``faults`` (with
    ``fault_horizon`` / ``fault_seed``), ``slo``, ``tracer`` and
    ``metrics`` are the reference's."""

    def __init__(self, model_cfg, model, *, num_slots: int = 4,
                 page_size: int = 8, max_prompt_len: int = 32,
                 max_new_cap: int = 32, num_pages: Optional[int] = None,
                 cache_int8: bool = False, mesh_model: int = 1,
                 use_kernel: bool = True, device=None,
                 clock: str = "wall", step_time: float = 1.0,
                 prefill_time: float = 1.0, faults: Optional[str] = None,
                 fault_horizon: int = 256, fault_seed: int = 0,
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
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        self.mesh_model = mesh_model
        self.tp_plan = None
        self._tp_ctx: Optional[tp.TPContext] = None
        sliced = mesh_model > 1 and getattr(model, "tp_slice", None)
        if model.cfg != model_cfg and not sliced:
            raise ValueError("model was built for another config than "
                             "model_cfg")
        if mesh_model > 1:
            group = _model_group(mesh_model)
            plan = self.tp_plan = resolve_tp(model_cfg, mesh_model)
            shard_model(model, plan, mesh.model_index())
            self._tp_ctx = tp.TPContext(group, mesh.model_index(),
                                        plan.attn, plan.ffn, plan.vocab)
        if model_device != self.device:
            raise ValueError(f"model lives on {model_device}, the engine "
                             f"serves on {self.device}")
        self.cfg = model_cfg
        self.model = model
        # the SLO gate controls on the engine's clock; tracer / metrics are
        # observability only
        self.slo_cfg = slo
        self.tracer = as_tracer(tracer)
        self.registry = metrics
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
        # a TP rank's model config holds its kv heads: its slice of the pool
        self.pool_cfg = pages_lib.PoolConfig(
            num_layers=model_cfg.num_layers, kv_heads=model.cfg.num_kv_heads,
            head_dim=model_cfg.resolved_head_dim,
            num_pages=num_pages, page_size=page_size, num_slots=num_slots,
            max_pages_per_slot=max_pages, quantized=cache_int8)
        if self._tp_ctx is not None:
            self._prefill, self._decode = build_tp_paged_fns(
                model, self._tp_ctx, quantized=cache_int8,
                use_kernel=use_kernel)
        else:
            self._decode = build_paged_decode(model, quantized=cache_int8,
                                              use_kernel=use_kernel)
            self._prefill = build_paged_prefill(model, quantized=cache_int8,
                                                use_kernel=use_kernel)
        self._buckets_run: set = set()
        self._decode_ran = False
        self.pool_bytes = 0
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        capturable = (self.device.type == "cuda"
                      and (mesh_model == 1 or mesh.backend() == "nccl"))
        if decode_graph is None:
            decode_graph = capturable
        elif decode_graph and self.device.type == "cuda" and not capturable:
            raise ValueError(
                f"decode_graph=True replays a captured CUDA graph of the "
                f"decode step, and the '{mesh.backend()}' world's "
                f"collectives cannot be captured (several ranks on one card "
                f"run over gloo); use decode_graph=False here, or one card "
                f"per rank (NCCL)")
        self._graph_decode = decode_graph
        self._decode_graph = self.decode_graph_for(lambda: self._bufs)
        self.fault_plan = None
        if faults:
            plan = faults_lib.plan_from_spec(
                faults, num_steps=fault_horizon, num_workers=num_slots,
                seed=fault_seed)
            bad = sorted({e.kind for e in plan.events
                          if e.kind not in SERVE_FAULT_KINDS})
            if bad:
                raise ValueError(
                    f"serve wires only {SERVE_FAULT_KINDS} of the fault "
                    f"taxonomy (decode is lockstep — no per-worker crash/"
                    f"restart/ckpt_io surface); got {bad}")
            self.fault_plan = plan

    def decode_graph_for(self, bufs) -> Optional[StepGraph]:
        """A decode graph over the pool ``bufs()`` returns (the engine's,
        or a session's), None when decode runs eagerly."""
        if not self._graph_decode:
            return None
        return StepGraph(lambda static: {"tokens": self._decode(
            static["state"], bufs())}, self.device)

    def _decode_step(self, state: np.ndarray, bufs: Dict[str, torch.Tensor],
                     graph: Optional[StepGraph]) -> torch.Tensor:
        """One decode step over every slot of the pool ``bufs`` from the
        packed host state ``[slots, 2 + max_pages]`` int32: the next
        tokens ``[slots]`` on the device (a replay of ``graph``, captured
        over ``bufs``, on the card)."""
        state_t = torch.from_numpy(state)
        if graph is None:
            return self._decode(state_t.to(self.device), bufs)
        weights_and_pool = [*self.model.parameters(), *bufs.values()]
        return graph({"state": state_t}, weights_and_pool)["tokens"]

    def _prefill_into(self, req: trace_lib.Request, slot: int,
                      pool: pages_lib.PagePool) -> int:
        """Prefill ``req`` into ``slot``'s pages of ``pool`` (allocated by
        the caller); returns the greedy first token."""
        bucket = trace_lib.bucket_for(req.prompt_len, floor=self.page_size,
                                      cap=self.max_bucket)
        n_pages = bucket // self.page_size
        # [true_len, *page_ids, *bucket-padded tokens]: one transfer
        packed = np.zeros((1 + n_pages + bucket,), np.int32)
        packed[0] = req.prompt_len
        packed[1:1 + n_pages] = pool.page_table[slot, :n_pages]
        packed[1 + n_pages:1 + n_pages + req.prompt_len] = req.prompt
        tok_dev = self._prefill(torch.from_numpy(packed).to(self.device),
                                req.prompt_len, n_pages, pool.buffers)
        self._buckets_run.add(bucket)
        return int(tok_dev.item())

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
            t = time.perf_counter() - self._t0
            if self._tp_ctx is not None:    # TP: the group's first rank's
                group = self._tp_ctx.group
                dev = self.device if mesh.backend() == "nccl" else "cpu"
                t_dev = torch.tensor([t], dtype=torch.float64, device=dev)
                dist.broadcast(t_dev, src=dist.get_global_rank(group, 0),
                               group=group)
                t = float(t_dev.item())
            return t
        return self._vnow

    def _advance_to(self, t: float) -> None:
        if self.clock == "wall":
            dt = t - self._now()
            if dt > 0:
                time.sleep(dt)
        else:
            self._vnow = max(self._vnow, t)

    def _advance_decode(self, elapsed: float, factor: float) -> None:
        if self.clock == "wall":
            extra = elapsed * (factor - 1.0)
            if extra > 0:
                time.sleep(extra)
        else:
            self._vnow += self.step_time * factor

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
        preempt_counts: Dict[int, int] = {}
        slo = SLOController(self.slo_cfg) if self.slo_cfg else None
        held: List[trace_lib.Request] = []     # the SLO "queue" pen
        self._prefill_s = 0.0
        self._decode_s = 0.0
        wall_t0 = time.perf_counter()
        self._t0 = time.perf_counter()
        self._vnow = 0.0
        step_idx = 0
        slow_factor, slow_until = 1.0, -1

        def complete(slot: int, st: _Slot, now: float) -> None:
            if slo is not None:
                slo.observe(now - st.req.arrival)
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

        while pending or queue or active or held:
            now = self._now()
            while pending and pending[0].arrival <= now:
                req = pending.popleft()
                if (self.max_queue is not None
                        and len(queue) >= self.max_queue):
                    # shed at the door (requeued preemptions re-enter at
                    # the queue head and are never shed)
                    reject(req, "queue_overflow", now)
                    continue
                verdict = slo.admit(now) if slo is not None else "admit"
                if verdict == "shed":
                    reject(req, "slo_shed", now)
                elif verdict == "queue":
                    held.append(req)
                else:
                    queue.append(req)
            if held and not slo.violating:
                # the gate re-opened: release the pen in arrival order
                queue.extend(held)
                held.clear()
            elif held and not queue and not active and not pending:
                # gate shut and the engine idle: nothing in flight can feed
                # the estimator, so probe with the oldest held request
                queue.append(held.pop(0))
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
                st = self._admit(req, slot, need, pool,
                                 preempt_counts.get(req.rid, 0))
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
            # -- chaos at decode-step granularity ----------------------------
            if self.fault_plan:
                for ev in self.fault_plan.events:
                    if ev.step != step_idx:
                        continue
                    if ev.kind == "slowdown":
                        slow_factor, slow_until = ev.factor, \
                            step_idx + ev.duration
                        events.append({"event": "slowdown", "step": step_idx,
                                       "factor": ev.factor,
                                       "duration": ev.duration})
                    elif ev.kind == "preempt":
                        evicted = sorted(active.items())
                        for slot, st in evicted:
                            pool.free_slot(slot)
                            free_slots.append(slot)
                            preempt_counts[st.req.rid] = st.preemptions + 1
                        active.clear()
                        for _, st in reversed(evicted):
                            queue.appendleft(st.req)
                        events.append({"event": "preempt", "step": step_idx,
                                       "evicted": len(evicted)})
                        self.tracer.instant("serve/evict", step=step_idx,
                                            evicted=len(evicted))
                if not active:
                    step_idx += 1
                    continue
            factor = slow_factor if step_idx <= slow_until else 1.0
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
                next_tokens = self._decode_step(
                    state, self._bufs, self._decode_graph).cpu().numpy()
            dt = time.perf_counter() - t_start
            self._decode_ran = True
            self._decode_s += dt
            if self.registry is not None:
                self.registry.histogram("serve/decode_s").observe(dt)
            self._advance_decode(dt, factor)
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
        metrics["rejected_slo_shed"] = sum(
            1 for r in rejected if r["reason"] == "slo_shed")
        if slo is not None:
            metrics["slo_trips"] = slo.trips
            metrics["slo_estimate"] = slo.estimate()
        if self.registry is not None:
            reg = self.registry
            reg.counter("serve/completed").inc(len(completed))
            reg.counter("serve/rejected").inc(len(rejected))
            reg.counter("serve/slo_shed").inc(metrics["rejected_slo_shed"])
            reg.counter("serve/tokens").inc(
                sum(len(c.tokens) for c in completed))
            hl = reg.histogram("serve/latency")
            ht = reg.histogram("serve/ttft")
            for c in completed:
                hl.observe(c.latency)
                ht.observe(c.ttft)
            reg.gauge("serve/wall_time_s").set(metrics["wall_time_s"])
        return ServeReport(policy=policy, completed=completed,
                           metrics=metrics, events=events, rejected=rejected)

    def _admit(self, req, slot: int, need: int, pool: pages_lib.PagePool,
               preemptions: int) -> _Slot:
        pool.alloc(slot, need)
        admitted = self._now()
        with self.tracer.span("serve/admit", rid=req.rid):
            t_start = time.perf_counter()
            with self.tracer.span("serve/prefill", rid=req.rid,
                                  prompt_len=req.prompt_len):
                first_tok = self._prefill_into(req, slot, pool)
            dt = time.perf_counter() - t_start
        self._prefill_s += dt
        if self.registry is not None:
            self.registry.histogram("serve/prefill_s").observe(dt)
        self._advance_prefill()
        return _Slot(req, admitted, self._now(), first_tok, preemptions)

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


# ---------------------------------------------------------------------------
# Incremental per-replica surface (the router drives R of these)
# ---------------------------------------------------------------------------


class StepSession:
    """One serving replica as an incremental admit / tick surface.

    Sessions share one engine's weights and prefill / decode functions (R
    replicas of one server build), but each owns its KV pool, page table
    and decode slots, so replicas fail and drain independently; on the
    card each also owns its decode graph, captured over its own pool on
    its first tick and replayed after (``decode_captures``). The caller
    owns all timekeeping: ``admit`` takes explicit timestamps and ``tick``
    only reports which requests finished, so the router's virtual clock
    decides every report and same-seed replays are bit-identical. Greedy
    decode makes a request's tokens the same on whichever replica (or
    however many hedged copies) ran it."""

    def __init__(self, engine: ServeEngine, name: str = ""):
        self.engine = engine
        self.name = name
        self.pool = pages_lib.PagePool(engine.pool_cfg,
                                       dtype=engine.model.dtype,
                                       device=engine.device)
        self.free_slots = list(range(engine.pool_cfg.num_slots - 1, -1, -1))
        self.active: Dict[int, _Slot] = {}
        self._slot_of: Dict[int, int] = {}
        self._graph = engine.decode_graph_for(lambda: self.pool.buffers)

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def decode_captures(self) -> int:
        """Captures of this session's decode graph (0 when eager)."""
        return self._graph.captures if self._graph is not None else 0

    def can_admit(self, req: trace_lib.Request) -> bool:
        need = self.engine.pages_needed(req)
        return (bool(self.free_slots) and need <= self.engine.page_capacity
                and self.pool.can_alloc(need))

    @torch.inference_mode()
    def admit(self, req: trace_lib.Request, admitted_t: float,
              first_token_t: float, preemptions: int = 0) -> _Slot:
        """Prefill ``req`` into a free slot (the caller checked
        ``can_admit`` and stamps both times). The returned slot state may
        already be ``done()``: a one-token request finishes at prefill."""
        eng = self.engine
        need = eng.pages_needed(req)
        slot = self.free_slots.pop()
        self.pool.alloc(slot, need)
        with eng.tracer.span("serve/prefill", rid=req.rid,
                             replica=self.name):
            first_tok = eng._prefill_into(req, slot, self.pool)
        st = _Slot(req, admitted_t, first_token_t, first_tok, preemptions)
        self.active[slot] = st
        self._slot_of[req.rid] = slot
        return st

    def done(self, st: _Slot) -> bool:
        return st.produced >= st.req.max_new or (
            self.engine.eos_id is not None
            and st.last_token == self.engine.eos_id)

    def release(self, rid: int) -> _Slot:
        """Free ``rid``'s slot and pages (completion, a hedge loser
        cancelled, or an unhealthy replica draining); returns its slot
        state."""
        slot = self._slot_of.pop(rid)
        st = self.active.pop(slot)
        self.pool.free_slot(slot)
        self.free_slots.append(slot)
        return st

    def evict_all(self) -> List[_Slot]:
        """Crash / preempt: drop every in-flight request, freeing all
        pages. Returns the slot states in slot order, for a deterministic
        requeue."""
        sts = [st for _, st in sorted(self.active.items())]
        for slot in list(self.active):
            self.pool.free_slot(slot)
            self.free_slots.append(slot)
        self.active.clear()
        self._slot_of.clear()
        return sts

    @torch.inference_mode()
    def tick(self) -> List[int]:
        """One decode step over every active slot (one token each).
        Returns the rids that finished this step; the caller stamps their
        finish time and calls :meth:`release`."""
        if not self.active:
            return []
        eng = self.engine
        n_slots = eng.pool_cfg.num_slots
        state = np.zeros((n_slots, 2 + eng.pool_cfg.max_pages_per_slot),
                         np.int32)
        for slot, st in self.active.items():
            if self.done(st):
                continue   # finished at prefill: it holds its slot until
                           # the caller's scheduled release, never decodes
            state[slot, 0] = st.last_token
            state[slot, 1] = st.length
        state[:, 2:] = self.pool.page_table
        with eng.tracer.span("serve/decode", replica=self.name,
                             n_active=len(self.active)):
            next_tokens = eng._decode_step(state, self.pool.buffers,
                                           self._graph).cpu().numpy()
        eng._decode_ran = True
        finished: List[int] = []
        for slot in sorted(self.active):
            st = self.active[slot]
            if self.done(st):
                continue
            st.length += 1
            tok = int(next_tokens[slot])
            st.tokens.append(tok)
            st.last_token = tok
            st.produced += 1
            if self.done(st):
                finished.append(st.req.rid)
        self.pool.note_occupancy()
        return finished


# ---------------------------------------------------------------------------
# Checkpoint -> serve bridge
# ---------------------------------------------------------------------------


@torch.no_grad()
def restore_params(directory: str, model_cfg, *, step: Optional[int] = None,
                   use_ema: bool = False, device=None):
    """Load the weights of a training checkpoint for serving.

    Every backend stores its checkpoints full (sim, replicated spmd and
    TP-sharded alike, in the reference's format, from either package), so
    one template, the model's parameters, restores all three, through
    ``checkpoint.restore``'s checksum-verified walk-back path (``step``:
    the latest good one when None). ``use_ema`` loads the ``ema`` subtree
    instead, cast to the parameters' dtype as in the reference. Returns
    ``(model, manifest)``: a model for ``model_cfg`` on ``device`` (None:
    the card) holding the weights, which the port's engine takes where the
    reference's takes the parameter tree."""
    from repro_torch.train import checkpoint as ckpt_lib
    model = get_model(model_cfg, device=resolve_device(device))
    template = to_jax_tree({
        k: torch.empty(p.shape, dtype=p.dtype, device="meta")
        for k, p in model.named_parameters()})
    key = "ema" if use_ema else "params"
    tree, manifest = ckpt_lib.restore(directory, {key: template}, step)
    load_named(model, from_jax_tree(tree[key]))
    return model, manifest
