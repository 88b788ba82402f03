"""The Trainer: the paper's coordination regimes behind one entry point.
Reference: ``src/repro/train/loop.py`` (``TrainResult``,
``_normalize_kills``, ``Trainer`` — ``_build``, ``_build_mask``,
``_build_event``, ``init_state``, ``_init_event_state``, ``_state_tree``,
``save_checkpoint``, ``restore_checkpoint``, ``_restore_event_state``,
``_template``, ``rescale``, ``fault_kill`` / ``fault_slowdown`` /
``fault_revive``, ``_apply_faults``, ``run``, ``_chunk_len_at``,
``_next_chunk_specs``, ``_fence`` / ``_observe_chunk`` for the spans,
the registry and the measured latency feed, ``_run_one_step``, ``_run_chunk`` on both straggler
backends, ``_kill_event_worker``, ``_run_event``, ``_run_event_chunked``
— and ``run_experiment``; :97-1162, the telemetry at :140-185,
:475-490, :742-757 and :850-975, the mesh shrink at :625-635).

The token stream comes from ``data_cfg`` (a ``SyntheticLMConfig``; by
default the config's vocabulary, sequence, batch and seed at the default
noise), with its worker count set to the strategy's, as in the
reference.

The strategy, built from ``cfg.aggregation`` by
``core.registry.get_strategy``, picks the mode. A strategy the spmd
engine does not take (``registry.supports_spmd``: event strategies,
plugins that opt out) warns and runs on the ``sim`` backend, as in the
reference.

**Mask mode** (full_sync, backup, timeout, dynamic_backup). Per step:

1. the ``StragglerSimulator`` samples worker arrival times and the
   strategy selects the mask and the iteration time (simulated seconds);
2. the data pipeline emits the global batch (worker-contiguous rows);
3. the train step applies the masked aggregation, the optimizer and the
   EMA: the ``sim`` backend through the mask-weighted loss
   (``train_step.build_train_step``), the ``spmd`` backend through each
   worker's own gradient and the ``backup_reduce`` kernel
   (``distributed.spmd_engine``);
4. on checkpoint cadence, state is committed atomically in the
   reference's format (so either package resumes the other's run).

On the spmd backend with ``mesh_data * mesh_model > 1`` the trainer is
one rank of the mesh's world (``distributed.mesh.spawn``; each rank builds
its own Trainer from the same config). Every rank plans the same masks
from the same seed and builds the same global batch on the host, and
copies only its data index's workers' rows to its card; the engine sums
the reduced gradients over the ``'data'`` group, and every rank applies
the update to what it holds. With ``mesh_model > 1`` and a TP plan the
model is the rank's slice (``models.convert.shard_model``), and so are
the optimizer state and the EMA: ``init_state`` draws the full parameters
from the seed, exactly as on one card, and keeps the rank's slices;
checkpoints stay in the reference's full format (the model group of data
index 0 all-gathers each sharded leaf, rank 0 writes) and every rank
restores the full file and keeps its slices, so they interchange with
one-card and JAX runs. Rank 0 alone writes checkpoints (the others wait
at a barrier); every rank restores them. Chunked runs capture the NCCL
all-reduces inside the step graph (the first, eager step makes the
communicators live); a gloo world on CUDA tensors (several ranks on one
card) cannot be captured, so there ``chunk_size > 1`` raises.

With ``cfg.chunk_size > 1`` the loop runs chunks of up to K steps: the
simulator plans the chunk's K masks at once (``next_events``), the
``ChunkPrefetcher`` builds its K stacked batches ahead on a thread, and
the batches, masks and the optimizer's K per-step scalars reach the
device in one copy each (through pinned memory on the card). The chunk
step (``train_step.build_chunk_step``, ``spmd_engine.
build_spmd_chunk_step``) replays one captured CUDA graph per step on the
card and loops on the CPU; its metrics are read back once per chunk, and
only when a logged step falls inside it. Chunk boundaries fall on the run
target, the checkpoint cadence, kill steps and pending faults, so resume
and failure handling are unchanged, and a chunk of one step still takes
the chunk path, as in the reference.

With ``straggler_backend='device'`` (``sim`` backend, ``chunk_size >
1``) a chunk draws its K batches (``data.synthetic_lm.device_batch_fn``)
and its ``[K, W]`` arrivals (``core.straggler_device``, dead workers at
+inf) on the device, selects the masks there (``select_device``), ANDs
them with the live workers and replays the same step graph K times; the
host reads back the chunk's times, masks and logged metrics in one copy.
Each step's draws are a function of ``(seed, step)``, so any chunking and
a resume see the same arrivals and batches.

**Faults** (``core.faults``): the injector's events fire at chunk
boundaries (``_apply_faults``): a crash gives the worker +inf arrivals
(on the spmd engine its row of the stack is masked out of
``backup_reduce``), a slowdown scales its latencies for ``duration``
steps, a restart revives it with the current parameters, ``ckpt_io``
fails the next checkpoint writes, ``preempt`` checkpoints and raises
``Preemption`` for ``train.supervisor.run_supervised``. While the live
workers stay at the strategy's floor (N; ``min_alive`` for
``dynamic_backup``) the protocol absorbs losses; below it ``rescale``
checkpoints, rebuilds for fewer workers (``train.elastic``) and
restores. ``kill_worker_at`` is the plain form of a crash.

**Event mode** (async, softsync, staleness): the discrete-event
parameter server. The scheduler pops gradient arrivals, the strategy
decides apply-or-buffer per arrival, and each applied update advances
``step``. The model holds the PS parameters; a second copy of it (the
gradient model) takes the arriving worker's read copy and computes its
gradient (``coordination.make_grad_fn``). Read copies are clones: in
``VersionedReads`` (one per distinct version) per arrival, in one stacked
``[W, ...]`` tensor per parameter at ``chunk_size > 1``. With
``chunk_size > 1`` the host plans a chunk of arrivals
(``coordination.plan_events``) ending on an update, and
``train_step.build_event_chunk_step`` runs them: a graph replay per
arrival on the card (the branch the plan names), a loop on the CPU.
Checkpoints carry the reference's ``workers`` and ``stale_buffer`` trees
and its ``meta["event"]``, so event runs resume across the packages. The
``model=`` and ``batch_fn=`` overrides plug non-LM rigs (the §2.1 MNIST
CNN) into the event mode. A killed worker leaves the scheduler; a
slowdown scales its service times.

**Telemetry** (``obs``): with a ``tracer`` the loop records the
reference's spans (``train/step`` per step or ``train/chunk`` per chunk,
each holding ``train/data_wait`` and ``train/device_wait``, and
``train/ckpt_save``; the spmd engine adds ``spmd/dispatch`` and
``spmd/collective_wait``), and a ``metrics`` registry takes
``train/steps``, ``train/wall_time_s`` and the ``train/dispatch_s`` /
``data_s`` / ``ckpt_s`` phases at the end of a run, ``train/chunk_time_s``
and ``train/step_time_s`` per chunk and, in measured mode,
``spmd/worker_step_s``. Either turns on one fence a chunk
(``torch.cuda.synchronize`` inside ``train/device_wait``, after the
chunk's replays), so the spans cover the device time; nothing in a step
changes, and with both off the loop is untouched. Event mode gets the
checkpoint span and the registry's totals, as in the reference.

A rescale on the spmd engine over ranks shrinks ``mesh_data`` to the
largest size the new worker count divides over (the reference's rule): the
ranks whose data index falls outside go idle. They plan every step on the
host and take none, so they reach the live ranks' checkpoint barriers,
group creations and the supervisor's restore barrier.

The optimizer state and the EMA are dicts of f32 tensors keyed like the
parameters. Everything runs on ``device`` (``None`` = the card; ``"cpu"``
must be asked for).
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import TrainConfig
from repro_torch.core import coordination
from repro_torch.core import ema as ema_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import registry
from repro_torch.core import straggler_device
from repro_torch.core.events import StragglerSimulator
from repro_torch.core.straggler import LatencyModel, PaperCalibrated
from repro_torch.data.synthetic_lm import (ChunkPrefetcher, PipelineState,
                                           SyntheticLMConfig,
                                           SyntheticLMPipeline,
                                           device_batch_fn, worker_batch)
from repro_torch.distributed import mesh, spmd_engine
from repro_torch.models import from_jax_tree, get_model, to_jax_tree
from repro_torch.models import convert
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import as_tracer
from repro_torch.optim import make_optimizer, schedules
from repro_torch.optim.optimizers import stage_scalars
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.train.train_step import (build_chunk_step,
                                          build_event_chunk_step,
                                          build_train_step)


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]
    metrics: List[Dict]
    sim_time: float
    steps: int
    restarts: int
    # realized mean of aggregated workers per step (Timeout's actual
    # per-step mean, not its upper bound) and of the applied gradients'
    # staleness (0 for the mask strategies)
    mean_selected: float = 0.0
    mean_staleness: float = 0.0
    wall_time_s: float = 0.0
    # host wall time of each step (PS update, in event mode) of this run (a
    # chunk's steps share its time evenly); a logged step includes its
    # metrics read, which waits for the device
    step_times_s: List[float] = dataclasses.field(default_factory=list)
    # event mode: gradient arrivals this run processed
    arrivals: int = 0
    # the chaos engine's and the supervisor's structured events (the
    # reference's schema; steps and workers only, no wall clock)
    recovery_log: List[Dict] = dataclasses.field(default_factory=list)
    # host seconds per phase (dispatch_s, data_s, ckpt_s) when a tracer, a
    # registry or the measured feed is on; {} otherwise
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)


def _normalize_kills(kill_worker_at: Optional[Dict[int, Any]]
                     ) -> Dict[int, List[int]]:
    """{step: worker | [workers]} -> {step: [workers]}."""
    out: Dict[int, List[int]] = {}
    for s, ws in (kill_worker_at or {}).items():
        if isinstance(ws, (list, tuple, np.ndarray)):
            out[int(s)] = [int(w) for w in ws]
        else:
            out[int(s)] = [int(ws)]
    return out


def _host(v) -> np.ndarray:
    """A batch leaf (numpy or tensor) as a numpy array."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def falls_back_to_sim(cfg: TrainConfig) -> bool:
    """True when ``cfg`` asks for the spmd backend with a strategy it does
    not take: the trainer then warns and runs ``sim``. The CLI asks before
    it starts a world of ranks, so a fallen-back run never starts one."""
    return (cfg.execution.backend == "spmd" and not registry.supports_spmd(
        registry.get_strategy(cfg.aggregation), cfg.execution))


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 latency: Optional[LatencyModel] = None, *, device=None,
                 data_cfg: Optional[SyntheticLMConfig] = None,
                 model=None, batch_fn: Optional[Callable] = None,
                 injector: Optional[faults_lib.FaultInjector] = None,
                 tracer=None, metrics=None):
        """``data_cfg`` sets the synthetic token stream (its
        ``num_workers`` is replaced by the strategy's). ``model`` /
        ``batch_fn`` override the config's model and the
        per-worker batch source (``batch_fn`` in event mode only): how
        non-LM rigs such as the §2.1 MNIST staleness experiment route
        through ``run_experiment``. ``batch_fn(worker, draw_index)`` ->
        batch dict (numpy arrays or tensors). ``model`` must live on
        ``device``. ``injector`` attaches a chaos plan
        (``core.faults``); the supervisor owns it across restarts, so
        faults fire at most once.

        ``tracer`` (``obs.Tracer``) records the ``train/*`` spans (and the
        spmd engine's ``spmd/*``); ``metrics`` (``obs.MetricsRegistry``)
        takes the ``train/*`` schema. Either, or the measured latency
        feed, turns on the fence at chunk edges (``torch.cuda.
        synchronize`` inside ``train/device_wait``, never inside a
        chunk's replays); with neither the loop is untouched."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.latency = latency or PaperCalibrated()
        self.injector = injector
        self.restarts = 0
        self.sim_time = 0.0
        self.metrics: List[Dict] = []
        self._model_override = model
        self._batch_fn_override = batch_fn
        # realized selected / staleness accumulators behind TrainResult's
        # means (persisted across checkpoints)
        self._sel_sum = 0.0
        self._sel_count = 0
        self._stal_sum = 0.0
        self._stal_count = 0
        self._wall_s = 0.0
        self.tracer = as_tracer(tracer)
        self.registry = metrics
        self._phase = {"dispatch_s": 0.0, "data_s": 0.0, "ckpt_s": 0.0}
        self.data_cfg = data_cfg or SyntheticLMConfig(
            vocab_size=cfg.model.vocab_size, seq_len=cfg.shape.seq_len,
            global_batch=cfg.shape.global_batch,
            num_workers=cfg.aggregation.total_workers, seed=cfg.seed)
        self._build()
        # measured mode: fenced wall-clock rows feed the strategy's window
        self._measured_feed = (
            getattr(self.strategy, "latency_source", "sim") == "measured")
        self._obs = (self.tracer.enabled or self.registry is not None
                     or self._measured_feed)

    # -- construction ---------------------------------------------------------

    def _build(self) -> None:
        cfg = self.cfg
        self.strategy = registry.get_strategy(cfg.aggregation)
        backend = cfg.execution.backend
        if backend not in ("sim", "spmd"):
            raise ValueError(f"unknown execution backend {backend!r} "
                             f"(valid: sim, spmd)")
        self._spmd = backend == "spmd"
        # the spmd mesh's world, if any, and its 'model' group under TP; a
        # rank off a shrunk 'data' axis idles
        self._world = False
        self._idle = False
        self._model_group = None
        # several processes write one checkpoint directory: rank 0 writes
        self._shared_ckpt = False
        if self._spmd and not registry.supports_spmd(self.strategy,
                                                     cfg.execution):
            warnings.warn(
                f"strategy {cfg.aggregation.strategy!r} has no SPMD "
                "support (registry.supports_spmd); falling back to the "
                "single-device simulated backend", stacklevel=3)
            self._spmd = False
            # a torchrun world is joined before the trainer exists
            self._shared_ckpt = torch.distributed.is_initialized()
        if self.strategy.kind == "mask":
            self._build_mask()
        elif self.strategy.kind == "event":
            self._build_event()
        else:
            raise ValueError(f"strategy {cfg.aggregation.strategy!r} has "
                             f"unknown kind {self.strategy.kind!r}")
        self.step = 0

    def _make_model(self):
        if self._model_override is not None:
            return self._model_override
        return get_model(
            self.cfg.model, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                self.cfg.seed))

    def _check_straggler_backend(self) -> bool:
        """The reference's rules for ``straggler_backend``, with its
        messages; True for the device backend."""
        cfg = self.cfg
        if cfg.straggler_backend not in ("host", "device"):
            raise ValueError(f"unknown straggler_backend "
                             f"{cfg.straggler_backend!r} (host|device)")
        device = cfg.straggler_backend == "device"
        if device and not getattr(self.strategy, "device_select_supported",
                                  True):
            raise ValueError(
                f"strategy {cfg.aggregation.strategy!r} selects on the host "
                "(stateful adaptation has no traceable select_jax); use "
                "straggler_backend='host'")
        if self.injector is not None and device:
            raise ValueError(
                "fault injection composes with host-planned arrivals only: "
                "straggler_backend must be 'host' when cfg.faults is active")
        if self._spmd and device:
            raise ValueError(
                "straggler_backend='device' applies to the simulated "
                "backend only: the spmd engine consumes host-planned "
                "masks (use straggler_backend='host')")
        if device and cfg.chunk_size <= 1:
            raise ValueError(
                "straggler_backend='device' requires chunk_size > 1 — the "
                "device backend lives inside the fused chunk dispatch")
        return device

    def _build_mask(self) -> None:
        cfg = self.cfg
        if self._batch_fn_override is not None:
            raise ValueError("batch_fn overrides are only supported for "
                             "event strategies (async/softsync/staleness)")
        self._device_backend = self._check_straggler_backend()
        self.model = self._make_model()
        self.sim = StragglerSimulator(self.strategy, self.latency, cfg.seed)
        sched = schedules.from_config(cfg.optimizer,
                                      cfg.aggregation.num_workers)
        self.optimizer = make_optimizer(cfg.optimizer, sched)
        self.pipeline = SyntheticLMPipeline(dataclasses.replace(
            self.data_cfg, num_workers=cfg.aggregation.total_workers))
        step_kwargs = dict(
            num_workers=cfg.aggregation.total_workers,
            n_aggregate=cfg.aggregation.num_workers,
            ema_decay=cfg.optimizer.ema_decay,
            clip_norm=cfg.optimizer.clip_global_norm)
        chunked = cfg.chunk_size > 1
        self._rows = slice(None)             # this rank's rows of a batch
        if self._spmd:
            ex = cfg.execution
            spmd_engine.check_mesh(ex.mesh_data, ex.mesh_model)
            spmd_engine.validate_layout(cfg.aggregation.total_workers,
                                        cfg.shape.global_batch, ex.mesh_data)
            # a mesh of ranks, or the 'data' axis a rescale shrank inside
            # one (also for a restart after it)
            self._world = (ex.mesh_data * ex.mesh_model > 1
                           or mesh.current_shape() == (ex.mesh_data,
                                                       ex.mesh_model))
            if self._world:
                # every rank makes the (sub-)mesh's groups, idle ones too
                self._idle = not mesh.in_mesh(ex.mesh_data, ex.mesh_model)
                self._model_group = mesh.model_group(ex.mesh_data,
                                                     ex.mesh_model)
                per_rank = cfg.shape.global_batch // ex.mesh_data
                lo = mesh.data_index() * per_rank
                self._rows = slice(lo, lo + per_rank)
                if (chunked and self.device.type == "cuda"
                        and mesh.backend() != "nccl"):
                    raise ValueError(
                        f"chunk_size={cfg.chunk_size} replays a captured "
                        f"CUDA graph of the step, and the '{mesh.backend()}'"
                        f" world's all-reduces cannot be captured (several "
                        f"ranks on one card run over gloo); use "
                        f"chunk_size=1 here, or one card per rank (NCCL)")
            build = (spmd_engine.build_spmd_chunk_step if chunked
                     else spmd_engine.build_spmd_step)
            # a model override has no config: its 'model' axis stays
            # replicated, as in the reference; the engine's spans only
            # with a live tracer (its fence serializes the dispatch)
            step_kwargs.update(
                use_kernel=ex.use_kernel, interpret=ex.interpret,
                grad_batch=ex.grad_batch, bucket_size=ex.bucket_size,
                mesh_data=ex.mesh_data, mesh_model=ex.mesh_model,
                model_cfg=(None if self._model_override is not None
                           else cfg.model),
                tracer=self.tracer if self.tracer.enabled else None)
        else:
            build = build_chunk_step if chunked else build_train_step
        # an idle rank builds no step: it takes no part in the data axis
        step = None if self._idle else build(self.model, self.optimizer,
                                             **step_kwargs)
        if chunked:
            self.chunk_step = step
            self.prefetcher = ChunkPrefetcher(self.pipeline.cfg,
                                              depth=cfg.prefetch_depth)
        else:
            self.train_step = step
        if self._device_backend:
            # the chunk's draws on the device: a sampler per latency model
            # (NotImplementedError for one without) and the batch twin
            self._sample_fn = straggler_device.sampler_for(self.latency)
            self._device_batch = device_batch_fn(self.pipeline.cfg,
                                                 self.device)
            self._dead_key, self._dead_dev = None, None

    def _build_event(self) -> None:
        cfg = self.cfg
        if cfg.straggler_backend != "host":
            raise ValueError(
                "event strategies (async/softsync/staleness) schedule "
                "arrivals on the host: straggler_backend must be 'host'")
        self._event_fused = cfg.chunk_size > 1
        if self._event_fused and not registry.supports_event_scan(
                self.strategy):
            # a plugin with only on_arrival still runs, per arrival
            warnings.warn(
                f"strategy {cfg.aggregation.strategy!r} does not implement "
                "the chunked plan/scan protocol (plan_arrival + "
                "on_arrival_scan); falling back to the per-arrival path "
                "(chunk_size=1 semantics)", stacklevel=3)
            self._event_fused = False
        self.model = self._make_model()
        # the gradient model: each arrival's read copy is loaded into it
        self._grad_model = copy.deepcopy(self.model)
        sched = schedules.from_config(cfg.optimizer,
                                      cfg.aggregation.num_workers)
        self.optimizer = make_optimizer(cfg.optimizer, sched)
        self._grad_fn = coordination.make_grad_fn(self._grad_model)
        self._update_fn = coordination.make_update_fn(
            self.optimizer, cfg.optimizer.clip_global_norm)
        if self._event_fused:
            self._event_chunk = build_event_chunk_step(
                self._grad_model, self._grad_fn, self._update_fn,
                self.strategy, ema_decay=cfg.optimizer.ema_decay)
        if self._batch_fn_override is not None:
            host = self._batch_fn_override
        else:
            data_cfg = dataclasses.replace(
                self.data_cfg, num_workers=self.strategy.total_workers)

            def host(worker: int, draw: int) -> Dict:
                return worker_batch(data_cfg, worker, draw)
        self._event_batch_host = lambda w, d: {
            k: _host(v) for k, v in host(w, d).items()}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, seed: Optional[int] = None) -> None:
        """Draw the parameters from ``seed`` (default ``cfg.seed``) and
        initialize the optimizer state and the EMA from them (and, in
        event mode, the workers' read copies and the scheduler)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed if seed is None else seed)
        if self._tp_slice is not None:
            # the full parameters, drawn as on one card; keep the slices
            full = get_model(self.cfg.model, device=self.device,
                             generator=gen)
            convert.load_named(self.model, dict(full.named_parameters()))
            del full
        else:
            self.model.init(gen)
        self.reset_optimizer_state()
        if self.strategy.kind == "event":
            self._init_event_state()

    def reset_optimizer_state(self) -> None:
        """Optimizer state and EMA afresh from the current parameters."""
        self.opt_state = self.optimizer.init(self.params)
        self.ema = (ema_lib.init(self.params.items())
                    if self.cfg.optimizer.ema_decay > 0 else None)

    def _init_event_state(self) -> None:
        w = self.strategy.total_workers
        self._draws = np.zeros(w, dtype=np.int64)
        self._arrival_count = 0
        self._event_dead: set = set()
        if self.strategy.uses_clock:
            self._sched = coordination.EventScheduler(
                w, self.latency, self.cfg.seed)
        else:
            self._sched = coordination.SerialScheduler()
        # drop the old copies before making new ones
        self._workers_stacked = self._scan_aux = self._reads = None
        with torch.no_grad():
            if self._event_fused:
                # one stacked [W, ...] row per worker and the strategy's
                # device carry; the host keeps the plan state only
                self._ev_state = None
                self._plan_state = self.strategy.init_plan_state(
                    self.cfg.seed)
                self._read_version = np.zeros(w, dtype=np.int64)
                self._workers_stacked = {
                    k: p.detach().unsqueeze(0).repeat(
                        (w,) + (1,) * p.dim())
                    for k, p in self.params.items()}
                self._scan_aux = self.strategy.init_scan_state(self.params)
            else:
                self._reads = coordination.VersionedReads(self.params, w)
                self._read_version = self._reads.version
                self._ev_state = self.strategy.init_state(self.cfg.seed)

    @property
    def _tp_slice(self):
        """(plan, model index) of a TP rank's model, else None."""
        return getattr(self.model, "tp_slice", None)

    # -- checkpointing --------------------------------------------------------

    def _full(self, named: Dict[str, torch.Tensor]) -> Dict:
        """``named`` (keyed like the parameters) with its sharded leaves
        all-gathered over the model group (as it is without TP)."""
        if self._tp_slice is None:
            return named
        return convert.gather_named(named, self.model.tp_dims,
                                    self._model_group)

    def _state_tree(self) -> Dict:
        """The reference's tree: params, opt, ema in its layout (full
        leaves: under TP each rank of the model group must call this); in
        event mode also ``workers`` (every worker's read copy, for
        strategies with a clock) and ``stale_buffer`` (the staleness FIFO,
        oldest first), stacked ``[n, ...]``."""
        out = {"params": to_jax_tree(self._full(self.params)),
               "opt": {k: to_jax_tree(self._full(v))
                       for k, v in self.opt_state.items()}}
        if self.ema is not None:
            out["ema"] = to_jax_tree(self._full(self.ema))
        if self.strategy.kind != "event":
            return out
        if self.strategy.uses_clock:
            workers = self._workers_stacked if self._event_fused else {
                k: torch.stack([self._reads.read(i)[k] for i in
                                range(self.strategy.total_workers)])
                for k in self.params}
            out["workers"] = to_jax_tree(workers, axis=1)
        if self._event_fused:
            slots = [s for _, s in getattr(self._plan_state, "fifo", [])]
            idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
            stale = {k: r.index_select(0, idx)
                     for k, r in self._scan_aux.items()} if slots else None
        else:
            buf = getattr(self._ev_state, "buffer", None)
            stale = {k: torch.stack([g[k] for _, g in buf])
                     for k in self.params} if buf else None
        if stale is not None:
            out["stale_buffer"] = to_jax_tree(stale, axis=1)
        return out

    def _template(self, buffer_len: int = 0) -> Dict:
        def meta(named, n=None):
            shapes = convert.full_shapes(self.model, named)
            return {k: torch.empty(((n,) if n else ()) + shapes[k],
                                   dtype=t.dtype, device="meta")
                    for k, t in named.items()}

        out = {"params": to_jax_tree(meta(self.params)),
               "opt": {k: to_jax_tree(meta(v))
                       for k, v in self.opt_state.items()}}
        if self.ema is not None:
            out["ema"] = to_jax_tree(meta(self.ema))
        if self.strategy.kind == "event":
            if self.strategy.uses_clock:
                out["workers"] = to_jax_tree(
                    meta(self.params, self.strategy.total_workers), axis=1)
            if buffer_len:
                out["stale_buffer"] = to_jax_tree(
                    meta(self.params, buffer_len), axis=1)
        return out

    def save_checkpoint(self) -> str:
        ck = self.cfg.checkpoint
        shared = self._world or self._shared_ckpt
        if shared and mesh.rank() != 0:
            # rank 0 writes (its model group gathers the sharded leaves
            # with it); every rank leaves once the write is committed
            if self._tp_slice is not None and mesh.data_index() == 0:
                with torch.no_grad():
                    self._state_tree()
            torch.distributed.barrier()
            return ckpt_lib.step_dir(ck.directory, self.step)
        meta = {
            "num_workers": self.cfg.aggregation.num_workers,
            "backup_workers": self.cfg.aggregation.backup_workers,
            "strategy": self.cfg.aggregation.strategy,
            "sim_time": self.sim_time,
            "restarts": self.restarts,
            "means": {"sel_sum": self._sel_sum, "sel_count": self._sel_count,
                      "stal_sum": self._stal_sum,
                      "stal_count": self._stal_count},
        }
        # an adaptive strategy's window and cutoff (dynamic_backup), so a
        # restore resumes the adapted n
        if hasattr(self.strategy, "state_dict"):
            meta["strategy_state"] = self.strategy.state_dict()
        if self.strategy.kind == "event":
            # the loop checkpoints right after an applied update, where the
            # softsync window is empty; a mid-window snapshot would lose
            # the buffered gradients on resume
            strat_state = (self._plan_state if self._event_fused
                           else self._ev_state)
            if getattr(strat_state, "pending", None) or getattr(
                    strat_state, "pending_stals", None):
                raise RuntimeError(
                    "event checkpoint with a non-empty softsync window — "
                    "checkpoint only lands right after an applied update")
            entries = getattr(strat_state,
                              "fifo" if self._event_fused else "buffer", [])
            meta["event"] = {
                "sched": self._sched.state_dict(),
                "read_version": [int(v) for v in self._read_version],
                "draws": [int(d) for d in self._draws],
                "arrival_count": int(self._arrival_count),
                "dead": sorted(int(w) for w in self._event_dead),
                "buffer_tags": [int(tag) for tag, _ in entries],
                "strategy_rng": coordination.encode_rng(
                    getattr(strat_state, "rng", None)),
            }
        else:
            meta["data_state"] = self.pipeline.state.save()
            meta["dead_workers"] = [int(w) for w in
                                    np.nonzero(self.sim.dead)[0]]
        inj = self.injector
        t0 = self._now()
        with torch.no_grad(), self.tracer.span("train/ckpt_save",
                                               step=int(self.step)):
            path = ckpt_lib.save(
                ck.directory, self.step, self._state_tree(), meta, ck.keep,
                retries=ck.write_retries, backoff_s=ck.retry_backoff_s,
                max_backoff_s=ck.retry_max_backoff_s, jitter=ck.retry_jitter,
                backoff_seed=self.cfg.seed,
                io_check=inj.ckpt_io_check if inj is not None else None,
                on_retry=(inj.on_ckpt_retry(self.step)
                          if inj is not None else None))
        if t0 is not None:
            self._phase["ckpt_s"] += time.perf_counter() - t0
        if shared:
            torch.distributed.barrier()
        return path

    @torch.no_grad()
    def restore_checkpoint(self, step: Optional[int] = None) -> None:
        # manifest first: the event template depends on the saved buffer
        # length; the resolved step is pinned for the second read
        directory = self.cfg.checkpoint.directory
        manifest = ckpt_lib.read_manifest(directory, step)
        tree, manifest = ckpt_lib.restore(
            directory, self._template(len(manifest.get("event", {}).get(
                "buffer_tags", []))), int(manifest["step"]))

        def load(named, sub):
            full = from_jax_tree(sub)
            if self._tp_slice is not None:
                full = convert.shard_named(full, *self._tp_slice)
            for k, t in full.items():
                named[k].copy_(t)

        load(self.params, tree["params"])
        for k, v in self.opt_state.items():
            load(v, tree["opt"][k])
        if self.ema is not None:
            load(self.ema, tree["ema"])
        self.step = int(manifest["step"])
        self.sim_time = float(manifest.get("sim_time", 0.0))
        self.restarts = int(manifest.get("restarts", 0))
        means = manifest.get("means", {})
        self._sel_sum = float(means.get("sel_sum", 0.0))
        self._sel_count = int(means.get("sel_count", 0))
        self._stal_sum = float(means.get("stal_sum", 0.0))
        self._stal_count = int(means.get("stal_count", 0))
        if (hasattr(self.strategy, "load_state_dict")
                and manifest.get("strategy_state")):
            self.strategy.load_state_dict(manifest["strategy_state"])
        if self.strategy.kind == "event":
            self._restore_event_state(tree, manifest["event"])
            return
        self.pipeline.state = PipelineState.restore(manifest["data_state"])
        # replay-exact resume: the simulator is deterministic in (seed, step)
        self.sim.reset_to_step(self.step)
        # recorded deaths, while the cluster shape is unchanged (a rescale
        # renumbers the workers and starts them all alive)
        if (manifest.get("num_workers") == self.cfg.aggregation.num_workers
                and manifest.get("backup_workers")
                == self.cfg.aggregation.backup_workers):
            for w in manifest.get("dead_workers", []):
                if 0 <= int(w) < self.strategy.total_workers:
                    self.sim.kill_worker(int(w))

    def _restore_event_state(self, tree: Dict, ev_meta: Dict) -> None:
        self._init_event_state()
        read_version = np.array(ev_meta["read_version"], np.int64)
        self._draws = np.array(ev_meta["draws"], np.int64)
        self._arrival_count = int(ev_meta["arrival_count"])
        self._event_dead = set(ev_meta.get("dead", []))
        self._sched.load_state_dict(ev_meta["sched"])
        tags = ev_meta.get("buffer_tags", [])
        workers = (from_jax_tree(tree["workers"], axis=1)
                   if self.strategy.uses_clock else None)
        stale = from_jax_tree(tree["stale_buffer"], axis=1) if tags else {}
        if self._event_fused:
            self._read_version = read_version
            if workers is not None:
                for k, s in self._workers_stacked.items():
                    s.copy_(workers[k])
            if tags:
                # the FIFO-ordered buffer into ring slots 0..n-1, the
                # round-robin write pointer after them
                for k, r in self._scan_aux.items():
                    r[:len(tags)].copy_(stale[k])
                self._plan_state.fifo = [(int(tag), i)
                                         for i, tag in enumerate(tags)]
                self._plan_state.writes = len(tags)
            strat_state = self._plan_state
        else:
            # one copy per distinct read version (a serial rig's worker
            # reads the live parameters)
            self._reads.load(read_version, (
                (lambda i: {k: v[i] for k, v in workers.items()})
                if workers is not None else (lambda i: self.params)))
            if tags:
                self._ev_state.buffer = [
                    (int(tag), {k: v[i].to(self.device)
                                for k, v in stale.items()})
                    for i, tag in enumerate(tags)]
            strat_state = self._ev_state
        rng = getattr(strat_state, "rng", None)
        if rng is not None and ev_meta.get("strategy_rng"):
            coordination.decode_rng(rng, ev_meta["strategy_rng"])

    # -- elastic rescale ------------------------------------------------------

    def rescale(self, new_total: int) -> None:
        """Checkpoint, rebuild for ``new_total`` workers, restore, continue.

        ``new_total`` is rounded down to a divisor of the global batch, so
        the per-worker shard stays whole. Mask strategies only. On the spmd
        engine ``mesh_data`` shrinks to the largest size the new count
        divides over, as in the reference: the ranks past it idle (they
        plan every step on the host, take none, and reach every barrier
        and group creation of the live ranks). The old model, its step
        graph and the spmd engine's ``[W, P]`` stack are released before
        the rebuild, so their memory comes back; the new W captures a new
        graph on its first chunk (after an eager step that makes a new
        data group's communicator live)."""
        if self.strategy.kind != "mask":
            raise NotImplementedError("elastic rescale applies to mask "
                                      "strategies only")
        w = max(1, new_total)
        while self.cfg.shape.global_batch % w:
            w -= 1
        self.save_checkpoint()
        prev_restarts = self.restarts
        prev_total = self.cfg.aggregation.total_workers
        self.cfg = elastic.apply_rescale(self.cfg,
                                         elastic.plan_rescale(self.cfg, w))
        if self._spmd:
            # shrink the 'data' axis to the largest size the new worker
            # count still divides over; the freed ranks idle
            md = self.cfg.execution.mesh_data
            while w % md:
                md -= 1
            if md != self.cfg.execution.mesh_data:
                self.cfg = dataclasses.replace(
                    self.cfg, execution=dataclasses.replace(
                        self.cfg.execution, mesh_data=md))
                if self._world:
                    # every rank makes the shrunk mesh's groups and joins
                    # it, the freed ones too
                    mesh.in_mesh(md, self.cfg.execution.mesh_model)
        self._release()
        self._build()
        self.reset_optimizer_state()
        self.restore_checkpoint()
        self.restarts = prev_restarts + 1
        if self.injector is not None:
            self.injector.record("rescale", step=self.step,
                                 from_workers=prev_total,
                                 to_workers=self.cfg.aggregation.total_workers)
            # the rescaled cluster is renumbered and starts healthy
            self.injector.dead.clear()
            self.injector.slow_active.clear()

    def _release(self) -> None:
        """Drop the model, the state and the steps (their graphs, pools
        and the engine's stack; in event mode the read copies too) ahead
        of a rebuild, and hand the memory back."""
        for name in ("model", "opt_state", "ema", "chunk_step", "train_step",
                     "prefetcher", "_device_batch", "_dead_dev",
                     "_grad_model", "_grad_fn", "_update_fn", "_event_chunk",
                     "_workers_stacked", "_scan_aux", "_reads"):
            if hasattr(self, name):
                setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- fault injection (the chaos engine's trainer-side primitives) ---------

    def fault_kill(self, worker: int) -> None:
        """Permanent worker crash, in whichever mode is running."""
        if self.strategy.kind == "mask":
            self.sim.kill_worker(worker)
        else:
            self._kill_event_worker(worker)

    def fault_slowdown(self, worker: int, factor: float) -> None:
        """Latency spike on one worker (factor=1.0 restores health)."""
        if self.strategy.kind == "mask":
            self.sim.set_slowdown(worker, factor)
        else:
            self._sched.set_slowdown(worker, factor)

    @torch.no_grad()
    def fault_revive(self, worker: int) -> None:
        """A crashed worker rejoins with the *current* parameters."""
        if self.strategy.kind == "mask":
            self.sim.revive_worker(worker)
            return
        self._event_dead.discard(worker)
        # a fresh read copy at the live version; next arrival from now
        if self._event_fused:
            for k, p in self.params.items():
                self._workers_stacked[k][worker].copy_(p)
            self._read_version[worker] = self.step
        else:
            self._reads.write(worker, self.params, self.step)
        self._sched.revive_worker(worker, self.sim_time)

    def _event_window_empty(self) -> bool:
        """True when no softsync-style window is buffering gradients: the
        precondition of an event checkpoint."""
        if self.strategy.kind != "event":
            return True
        state = self._plan_state if self._event_fused else self._ev_state
        return not (getattr(state, "pending", None)
                    or getattr(state, "pending_stals", None))

    def _apply_faults(self, step: int) -> None:
        """Fire every due event of the chaos plan. Called at chunk
        boundaries in every loop; ``_chunk_len_at`` forces a boundary at
        each pending fault step, so faults land on the same step on every
        path."""
        if self.injector is None:
            return
        inj = self.injector
        w_total = self.strategy.total_workers
        for ev in inj.take_due(step):
            w = ev.worker % w_total if ev.worker >= 0 else ev.worker
            if (ev.kind in ("crash", "slowdown", "restart")
                    and self.strategy.kind == "event"
                    and not self.strategy.uses_clock):
                raise ValueError("failure injection does not apply to serial "
                                 "rigs (the staleness strategy has a single "
                                 "logical worker)")
            if ev.kind == "crash":
                if w not in inj.dead:
                    self.fault_kill(w)
                    inj.note_crash(step, w)
            elif ev.kind == "slowdown":
                self.fault_slowdown(w, ev.factor)
                inj.note_slowdown(step, w, ev.factor, ev.duration)
            elif ev.kind == "slow_end":
                inj.note_slow_end(w)
                self.fault_slowdown(w, 1.0)
            elif ev.kind == "restart":
                if w in inj.dead:
                    self.fault_revive(w)
                    inj.note_restart(step, w)
            elif ev.kind == "ckpt_io":
                inj.arm_ckpt_failures(step, ev.fails)
            elif ev.kind == "preempt":
                if not self._event_window_empty():
                    # an event checkpoint lands only right after an
                    # applied update: push the notice to the next one
                    inj.defer(ev, step + 1)
                    continue
                ckpted = False
                if ev.grace:
                    self.save_checkpoint()
                    ckpted = True
                inj.record("preempt", step=step, grace=ckpted)
                raise faults_lib.Preemption(step, ckpted)

    # -- the loop -------------------------------------------------------------

    def run(self, num_steps: int,
            kill_worker_at: Optional[Dict[int, Any]] = None,
            min_alive_behavior: str = "rescale") -> TrainResult:
        """``num_steps`` steps (PS updates in event mode).
        ``kill_worker_at``: {step: worker | [workers]} crashes (a
        correlated outage kills several at once)."""
        kill_worker_at = _normalize_kills(kill_worker_at)
        t0 = time.perf_counter()
        step0 = self.step
        target = self.step + num_steps
        step_times: List[float] = []
        arrivals0 = getattr(self, "_arrival_count", 0)
        try:
            if self.strategy.kind == "event":
                if self._event_fused:
                    self._run_event_chunked(target, kill_worker_at,
                                            step_times)
                else:
                    self._run_event(target, kill_worker_at, step_times)
            else:
                self._run_mask(target, kill_worker_at, min_alive_behavior,
                               step_times)
        finally:
            self._wall_s += time.perf_counter() - t0
            if self.registry is not None:
                self.registry.counter("train/steps").inc(self.step - step0)
                self.registry.gauge("train/wall_time_s").set(self._wall_s)
                for key, v in self._phase.items():
                    self.registry.gauge(f"train/{key}").set(v)
        return TrainResult(
            self.params, self.ema, self.metrics, self.sim_time, self.step,
            self.restarts,
            mean_selected=self._sel_sum / max(self._sel_count, 1),
            mean_staleness=self._stal_sum / max(self._stal_count, 1),
            wall_time_s=self._wall_s, step_times_s=step_times,
            arrivals=getattr(self, "_arrival_count", 0) - arrivals0,
            recovery_log=(list(self.injector.log)
                          if self.injector is not None else []),
            phase_times=dict(self._phase) if self._obs else {})

    def _run_mask(self, target: int, kill_worker_at: Dict[int, List[int]],
                  min_alive_behavior: str, step_times: List[float]) -> None:
        while self.step < target:
            self._apply_faults(self.step)
            if self.step in kill_worker_at:
                # popped as applied: a rescale renumbers the workers
                for w in kill_worker_at.pop(self.step):
                    self.sim.kill_worker(w)
            # an adaptive strategy's floor (dynamic_backup) is below N
            min_alive = getattr(self.strategy, "min_alive",
                                self.cfg.aggregation.num_workers)
            if self.sim.alive < min_alive:
                if min_alive_behavior == "rescale":
                    self.rescale(self.sim.alive)
                    continue
                raise RuntimeError("insufficient live workers")
            ts = time.perf_counter()
            k = self._chunk_len_at(self.step, target, kill_worker_at)
            if self._idle:
                self._idle_steps(k)
            elif self.cfg.chunk_size > 1:
                # k == 1 still goes through the chunk path
                self._run_chunk(k, target, kill_worker_at)
            else:
                self._run_one_step(target)
            step_times += [(time.perf_counter() - ts) / k] * k
            every = self.cfg.checkpoint.every_steps
            if every > 0 and self.step % every == 0:
                self.save_checkpoint()

    def _chunk_len_at(self, step: int, target: int,
                      kill_worker_at: Dict[int, List[int]]) -> int:
        """Steps from ``step`` to the next forced boundary: the run target,
        the checkpoint cadence, a kill step or a pending fault (so resume
        and failure handling are unchanged by chunking). Also predicts
        the next chunks' lengths for the prefetcher."""
        k = min(self.cfg.chunk_size, target - step)
        every = self.cfg.checkpoint.every_steps
        if every > 0:
            k = min(k, every - step % every)
        for s in kill_worker_at:
            if step < s < step + k:
                k = s - step
        if self.injector is not None:
            for s in self.injector.upcoming_steps():
                if step < s < step + k:
                    k = s - step
        return max(k, 1)

    def _next_chunk_specs(self, k: int, target: int,
                          kill_worker_at: Dict[int, List[int]]) -> List:
        """Predicted (data step, length) of the ``prefetch_depth`` chunks
        after the current one, by the same boundary rules, so speculation
        hits at ragged boundaries too; a miss costs only the speculated
        work."""
        specs = []
        s = self.step + k
        d = self.pipeline.state.step + k
        for _ in range(max(self.cfg.prefetch_depth, 0)):
            if s >= target:
                break
            kk = self._chunk_len_at(s, target, kill_worker_at)
            specs.append((d, kk))
            s += kk
            d += kk
        return specs

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device: on the card copied once into pinned
        memory, then to the device without blocking the host."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _log(self, selected: int, metrics: Dict[str, float],
             lr: float) -> None:
        self.metrics.append({"step": self.step, "sim_time": self.sim_time,
                             "selected": selected, "staleness": 0.0,
                             **metrics, "lr": lr})

    def _logged(self, target: int) -> bool:
        return self.step % self.cfg.log_every == 0 or self.step == target

    # -- observability hooks (no-ops unless tracer / metrics / measured) ---

    def _now(self) -> Optional[float]:
        return time.perf_counter() if self._obs else None

    def _fence(self) -> None:
        """The card's queue drained at the chunk edge, inside
        ``train/device_wait``: the only sync observability adds, so a
        chunk's replays are never split and nothing waits when it is
        off."""
        with self.tracer.span("train/device_wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _observe_chunk(self, k: int, t0: Optional[float],
                       data_s: float) -> None:
        """The fenced chunk's host seconds into the phase breakdown and the
        registry; in measured mode one per-worker row: the wall time per
        step for every live worker (on a lockstep card they all take it),
        dead workers at +inf."""
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        self._phase["dispatch_s"] += dt - data_s
        self._phase["data_s"] += data_s
        if self.registry is not None:
            self.registry.histogram("train/chunk_time_s").observe(dt)
            self.registry.histogram("train/step_time_s").observe(dt / k)
        if self._measured_feed:
            row = np.where(self.sim.dead, np.inf, (dt - data_s) / k)
            self.strategy.observe_measured(row)
            if self.registry is not None:
                h = self.registry.histogram("spmd/worker_step_s")
                for v in row[np.isfinite(row)]:
                    h.observe(float(v))

    def _idle_steps(self, k: int) -> None:
        """k steps of a rank off a shrunk 'data' axis: the host plan every
        rank makes (masks, data position, simulated time) and no device
        work, so the rank reaches the live ranks' checkpoints and
        rescales at the same steps."""
        events = self.sim.next_events(k)
        self.pipeline.state.step += k
        for i in range(k):
            self.sim_time += float(events.times[i])
            self.step += 1

    def _run_one_step(self, target: int) -> None:
        """One step: plan the mask, build the batch, run the train step;
        the metrics are read back (one sync) only on a logged step."""
        t0 = self._now()
        with self.tracer.span("train/step", step=int(self.step)):
            with self.tracer.span("train/data_wait"):
                ev = self.sim.next_event()
                batch = {k: torch.from_numpy(v[self._rows]).to(self.device)
                         for k, v in self.pipeline.next().items()}
            data_s = time.perf_counter() - t0 if t0 is not None else 0.0
            mask = torch.from_numpy(ev.mask).to(self.device)
            lr = self.optimizer.scalars(self.step)["lr"]
            scalars = {k: v[0] for k, v in stage_scalars(
                self.optimizer, [self.step], self.device).items()}
            m = self.train_step(self.opt_state, self.ema, scalars, batch,
                                mask)
            if self._obs:
                self._fence()
        self._observe_chunk(1, t0, data_s)
        self.sim_time += ev.iteration_time
        self.step += 1
        selected = int(ev.mask.sum())
        self._sel_sum += selected
        self._sel_count += 1
        if self._logged(target):
            self._log(selected, {k: float(v) for k, v in m.items()}, lr)

    def _run_chunk(self, k: int, target: int,
                   kill_worker_at: Dict[int, List[int]]) -> None:
        """k steps through the chunk step: one copy each of the stacked
        batches, masks and scalars, one metrics read when a logged step
        falls inside the chunk."""
        if self._device_backend:
            self._run_device_chunk(k, target)
            return
        steps = list(range(self.step, self.step + k))
        t0 = self._now()
        with self.tracer.span("train/chunk", k=k, step=int(self.step)):
            with self.tracer.span("train/data_wait"):
                chunk_np = self.prefetcher.get(
                    self.pipeline.state.step, k,
                    next_specs=self._next_chunk_specs(k, target,
                                                      kill_worker_at))
                self.pipeline.state.step += k
                batches = {key: self._to_device(
                    np.ascontiguousarray(v[:, self._rows]))
                    for key, v in chunk_np.items()}
            data_s = time.perf_counter() - t0 if t0 is not None else 0.0
            events = self.sim.next_events(k)
            masks = self._to_device(events.masks)
            scalars = stage_scalars(self.optimizer, steps, self.device)
            ms = self.chunk_step(self.opt_state, self.ema, scalars, batches,
                                 masks)
            if self._obs:
                self._fence()
        self._observe_chunk(k, t0, data_s)
        selected = events.masks.sum(axis=1)
        self._sel_sum += float(selected.sum())
        self._sel_count += k
        ms_np = None
        for i, step in enumerate(steps):
            self.sim_time += float(events.times[i])
            self.step += 1
            if self._logged(target):
                if ms_np is None:
                    ms_np = {key: v.cpu().numpy() for key, v in ms.items()}
                self._log(int(selected[i]),
                          {key: float(v[i]) for key, v in ms_np.items()},
                          self.optimizer.scalars(step)["lr"])

    def _dead_on_device(self) -> torch.Tensor:
        """The simulator's dead workers as a bool tensor on the device,
        copied again only when the set changes."""
        key = self.sim.dead.tobytes()
        if key != self._dead_key:
            self._dead_key = key
            self._dead_dev = self._to_device(self.sim.dead.copy())
        return self._dead_dev

    def _run_device_chunk(self, k: int, target: int) -> None:
        """k steps on the device backend, in the reference's order: the K
        batches, the ``[K, W]`` arrivals (dead workers at +inf), the
        selection on the device, the masks ANDed with the live workers,
        then the step graph replayed K times over the stacked buffers.
        Draws are per step (``(seed, step)``), never per chunk. The host
        reads back times, masks and any logged metrics in one copy."""
        steps = list(range(self.step, self.step + k))
        t0 = self._now()
        with self.tracer.span("train/chunk", k=k, step=int(self.step)):
            dead = self._dead_on_device()
            rows = [self._device_batch(s) for s in steps]
            batches = {key: torch.stack([r[key] for r in rows])
                       for key in rows[0]}
            del rows
            arrivals = straggler_device.chunk_arrivals(
                self._sample_fn, self.cfg.seed, steps,
                self.strategy.total_workers, dead, self.device)
            masks, times = self.strategy.select_device(arrivals)
            masks = masks & ~dead[None, :]
            scalars = stage_scalars(self.optimizer, steps, self.device)
            ms = self.chunk_step(self.opt_state, self.ema, scalars, batches,
                                 masks)
            if self._obs:
                self._fence()
        self._observe_chunk(k, t0, 0.0)
        self.pipeline.state.step += k
        self.sim.reset_to_step(self.sim.step + k)
        logged = [i for i in range(k)
                  if (steps[i] + 1) % self.cfg.log_every == 0
                  or steps[i] + 1 == target]
        names = list(ms) if logged else []
        host = torch.cat([times.double()[:, None], masks.double()]
                         + [ms[n].double()[:, None] for n in names],
                         dim=1).cpu().numpy()
        w = masks.shape[1]
        selected = host[:, 1:1 + w].sum(axis=1)
        self._sel_sum += float(selected.sum())
        self._sel_count += k
        for i, step in enumerate(steps):
            self.sim_time += float(host[i, 0])
            self.step += 1
            if logged and i == logged[0]:
                logged.pop(0)
                self._log(int(selected[i]),
                          {n: float(host[i, 1 + w + j])
                           for j, n in enumerate(names)},
                          self.optimizer.scalars(step)["lr"])

    # -- the event loop -------------------------------------------------------

    def _event_batch(self, worker: int, draw: int) -> Dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self._event_batch_host(worker, draw).items()}

    def _log_update(self, loss: float, selected: int,
                    staleness: float) -> None:
        self.metrics.append({"step": self.step, "loss": loss,
                             "sim_time": self.sim_time,
                             "selected": int(selected),
                             "staleness": float(staleness)})

    def _event_alive(self) -> int:
        return self.strategy.total_workers - len(self._event_dead)

    def _kill_event_worker(self, worker: int) -> None:
        if worker in self._event_dead:
            return
        self._event_dead.add(worker)
        self._sched.drop_worker(worker)
        if self._event_alive() == 0 or not self._sched.queue:
            raise RuntimeError("insufficient live workers")

    def _event_faults(self, kill_worker_at: Dict[int, List[int]]) -> None:
        """Due faults and kills at the current PS version."""
        self._apply_faults(self.step)
        if self.step in kill_worker_at:
            for kw in kill_worker_at.pop(self.step):
                self._kill_event_worker(kw)

    def _refuse_serial_kills(self, kill_worker_at) -> None:
        if kill_worker_at and not self.strategy.uses_clock:
            raise ValueError("failure injection does not apply to serial "
                             "rigs (the staleness strategy has a single "
                             "logical worker)")

    def _run_event(self, target: int, kill_worker_at: Dict[int, List[int]],
                   step_times: List[float]) -> None:
        """The discrete-event PS loop, one arrival at a time:
        ``coordination.run_events`` arrival for arrival, plus the
        checkpoint cadence, faults and kills, and the metrics records. A
        record's loss is
        read back (one sync) only on a logged update. The arrival's
        phases are ``torch.profiler`` ranges (``event/grad``,
        ``event/update``, ``event/read_copy``), which
        ``launch/profile_train.py`` reads."""
        every = self.cfg.checkpoint.every_steps
        ema_decay = self.cfg.optimizer.ema_decay
        self._refuse_serial_kills(kill_worker_at)
        ts = time.perf_counter()
        while self.step < target:
            self._event_faults(kill_worker_at)
            t, w = self._sched.pop()
            batch = self._event_batch(w, int(self._draws[w]))
            self._draws[w] += 1
            with record_function("event/grad"):
                loss, grads = self._grad_fn(self._reads.read(w), batch)
            arrival = coordination.Arrival(
                index=self._arrival_count, worker=w, time=float(t),
                staleness=int(self.step - self._read_version[w]),
                version=self.step)
            self._arrival_count += 1
            if self.strategy.stals_per_arrival:
                self._stal_sum += arrival.staleness
                self._stal_count += 1
            ready = self.strategy.on_arrival(self._ev_state, grads, arrival)
            del grads
            updated = False
            if ready is not None:
                with record_function("event/update"):
                    self._update_fn(self.params, self.opt_state,
                                    ready.grads, self.step)
                    if ema_decay > 0:
                        ema_lib.update(self.ema, self.params.items(),
                                       ema_decay)
                # simulated seconds; the serial rig's clock is the arrival
                # index
                self.sim_time = float(t)
                if not self.strategy.stals_per_arrival:
                    self._stal_sum += ready.staleness
                    self._stal_count += 1
                self._sel_sum += ready.selected
                self._sel_count += 1
                self.step += 1
                updated = True
                if self._logged(target):
                    self._log_update(float(loss), ready.selected,
                                     ready.staleness)
                del ready
            # the worker reads the fresh params and starts its next batch
            with record_function("event/read_copy"):
                self._reads.write(w, self.params, self.step)
            self._sched.push(t, w)
            if updated:
                step_times.append(time.perf_counter() - ts)
                if every > 0 and self.step % every == 0:
                    self.save_checkpoint()
                ts = time.perf_counter()

    def _run_event_chunked(self, target: int,
                           kill_worker_at: Dict[int, List[int]],
                           step_times: List[float]) -> None:
        """Chunks of host-planned arrivals through the event chunk step.
        A chunk's length is counted in PS updates (``_chunk_len_at``) and
        its plan ends on its last update, so checkpoints land on the same
        steps, with the same state, as on the per-arrival path. The
        batches, the plan's rows and the staged scalars reach the device
        in one copy each; the losses are read back only when a logged
        update falls in the chunk."""
        every = self.cfg.checkpoint.every_steps
        self._refuse_serial_kills(kill_worker_at)
        while self.step < target:
            self._event_faults(kill_worker_at)
            ts = time.perf_counter()
            u = self._chunk_len_at(self.step, target, kill_worker_at)
            plan = coordination.plan_events(
                self.strategy, self._sched, self._plan_state,
                self._read_version, self._draws,
                version0=self.step, arrival0=self._arrival_count,
                num_updates=u)
            self._arrival_count += len(plan)
            host = [self._event_batch_host(int(wk), int(d))
                    for wk, d in zip(plan.worker, plan.draw)]
            batches = {k: self._to_device(np.stack([b[k] for b in host]))
                       for k in host[0]}
            scalars = stage_scalars(self.optimizer,
                                    [int(s) for s in plan.step], self.device)
            losses = self._event_chunk(
                self.params, self.opt_state, self.ema, self._workers_stacked,
                self._scan_aux, scalars, batches, plan.rows(self.device),
                plan.apply)
            # host bookkeeping straight off the plan, no device sync
            if self.strategy.stals_per_arrival:
                self._stal_sum += float(plan.arrival_staleness.sum())
                self._stal_count += len(plan)
            else:
                self._stal_sum += float(
                    plan.update_staleness[plan.apply].sum())
                self._stal_count += plan.updates
            self._sel_sum += float(plan.selected[plan.apply].sum())
            self._sel_count += plan.updates
            losses_np = None
            for k in np.nonzero(plan.apply)[0]:
                self.step += 1
                self.sim_time = float(plan.time[k])
                if self._logged(target):
                    if losses_np is None:
                        losses_np = losses.cpu().numpy()
                    self._log_update(float(losses_np[k]),
                                     int(plan.selected[k]),
                                     float(plan.update_staleness[k]))
            step_times += [(time.perf_counter() - ts) / u] * u
            if every > 0 and self.step % every == 0:
                self.save_checkpoint()


# ---------------------------------------------------------------------------
# The one-call entry point
# ---------------------------------------------------------------------------


def run_experiment(cfg: TrainConfig, *,
                   latency: Optional[LatencyModel] = None,
                   device=None,
                   data_cfg: Optional[SyntheticLMConfig] = None,
                   model=None,
                   batch_fn: Optional[Callable] = None,
                   resume: bool = False, save_final: bool = False,
                   kill_worker_at: Optional[Dict[int, Any]] = None,
                   min_alive_behavior: str = "rescale",
                   injector: Optional[faults_lib.FaultInjector] = None,
                   tracer=None, metrics=None) -> TrainResult:
    """Run a coordination regime (full_sync, backup, timeout,
    dynamic_backup, async, softsync, staleness) from ``cfg`` alone: build
    the Trainer, initialize or resume its state, run ``cfg.total_steps``
    steps (PS updates in event mode) and return the :class:`TrainResult`.
    ``data_cfg`` sets the token stream (``Trainer``); ``model`` /
    ``batch_fn`` plug non-LM problems into the event regimes (the MNIST
    staleness rig). ``cfg.faults.spec`` attaches a chaos plan (an
    ``injector`` overrides it); an injected preemption or crash
    propagates out of this call, and ``train.supervisor.run_supervised``
    is the entry point that recovers from it. ``tracer`` / ``metrics``
    record the run's spans and registry (``Trainer``)."""
    if injector is None:
        injector = faults_lib.build_injector(
            cfg.faults, num_steps=cfg.total_steps,
            num_workers=cfg.aggregation.total_workers)
    tr = Trainer(cfg, latency=latency, device=device, data_cfg=data_cfg,
                 model=model, batch_fn=batch_fn, injector=injector,
                 tracer=tracer, metrics=metrics)
    if resume and ckpt_lib.latest_step(cfg.checkpoint.directory) is not None:
        tr.reset_optimizer_state()
        tr.restore_checkpoint()
        if injector is not None:
            injector.resync(tr)
    else:
        tr.init_state()
    res = tr.run(cfg.total_steps, kill_worker_at=kill_worker_at,
                 min_alive_behavior=min_alive_behavior)
    if save_final:
        tr.save_checkpoint()
    return res
