"""The Trainer: the paper's mask-mode coordination regimes behind one entry
point. Reference: ``src/repro/train/loop.py`` (``TrainResult``,
``Trainer`` in mask mode — ``_build_mask``, ``init_state``,
``save_checkpoint``, ``restore_checkpoint``, ``run``, ``_chunk_len_at``,
``_next_chunk_specs``, ``_run_one_step``, ``_run_chunk`` on the host
straggler backend — and ``run_experiment``; :97-311, 366-533, 738-968,
1122-1162).

The strategy, built from ``cfg.aggregation`` by
``core.registry.get_strategy``, is one of the mask strategies (full_sync,
backup, timeout). Per step:

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

With ``cfg.chunk_size > 1`` the loop runs chunks of up to K steps: the
simulator plans the chunk's K masks at once (``next_events``), the
``ChunkPrefetcher`` builds its K stacked batches ahead on a thread, and
the batches, masks and the optimizer's K per-step scalars reach the
device in one copy each (through pinned memory on the card). The chunk
step (``train_step.build_chunk_step``, ``spmd_engine.
build_spmd_chunk_step``) replays one captured CUDA graph per step on the
card and loops on the CPU; its metrics are read back once per chunk, and
only when a logged step falls inside it. Chunk boundaries fall on the run
target and the checkpoint cadence, so resume is unchanged, and a chunk of
one step still takes the chunk path, as in the reference.

The model holds the parameters; the optimizer state and the EMA are
dicts of f32 tensors keyed like them. Everything runs on ``device``
(``None`` = the card; ``"cpu"`` must be asked for).

Refused, each with ``NotImplementedError`` naming its ROADMAP item, and
never run another way: the device straggler backend (with its
``device_batch_fn``), the event strategies and ``dynamic_backup`` (the
registry), fault injection and supervision, failure injection
(``kill_worker_at``) and elastic rescale.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import ema as ema_lib
from repro_torch.core import registry
from repro_torch.core.events import StragglerSimulator
from repro_torch.core.straggler import LatencyModel, PaperCalibrated
from repro_torch.data.synthetic_lm import (ChunkPrefetcher, PipelineState,
                                           SyntheticLMConfig,
                                           SyntheticLMPipeline)
from repro_torch.distributed import spmd_engine
from repro_torch.models import from_jax_tree, get_model, to_jax_tree
from repro_torch.models.common import resolve_device
from repro_torch.optim import make_optimizer, schedules
from repro_torch.optim.optimizers import stage_scalars
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import build_chunk_step, build_train_step

_FAULTS = "fault tolerance, ROADMAP Queue 1 item 7"


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]
    metrics: List[Dict]
    sim_time: float
    steps: int
    restarts: int
    # realized mean of aggregated workers per step (Timeout's actual
    # per-step mean, not its upper bound) and of staleness (0 here)
    mean_selected: float = 0.0
    mean_staleness: float = 0.0
    wall_time_s: float = 0.0
    # host wall time of each step of this run (a chunk's steps share its
    # time evenly); a logged step includes its metrics read, which waits
    # for the device
    step_times_s: List[float] = dataclasses.field(default_factory=list)


def _refuse_deferred(cfg: TrainConfig) -> None:
    """Options of later slices: refused by name, never run another way."""
    if cfg.straggler_backend == "device":
        raise NotImplementedError(
            "straggler_backend='device' (arrivals and batches sampled on "
            "the device inside the chunk: straggler_jax, device_batch_fn) "
            "is not ported yet (ROADMAP Queue 1 item 6); use 'host'")
    if cfg.straggler_backend != "host":
        raise ValueError(f"unknown straggler_backend "
                         f"{cfg.straggler_backend!r} (host|device)")
    if cfg.faults.spec or cfg.faults.supervise:
        raise NotImplementedError(
            f"fault injection / supervision (cfg.faults) is not ported yet "
            f"({_FAULTS})")


class Trainer:
    def __init__(self, cfg: TrainConfig,
                 latency: Optional[LatencyModel] = None, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.latency = latency or PaperCalibrated()
        self.restarts = 0
        self.sim_time = 0.0
        self.metrics: List[Dict] = []
        self._sel_sum = 0.0
        self._sel_count = 0
        self._wall_s = 0.0
        self._build()

    # -- construction ---------------------------------------------------------

    def _build(self) -> None:
        cfg = self.cfg
        _refuse_deferred(cfg)
        self.strategy = registry.get_strategy(cfg.aggregation)
        backend = cfg.execution.backend
        if backend not in ("sim", "spmd"):
            raise ValueError(f"unknown execution backend {backend!r} "
                             f"(valid: sim, spmd)")
        self._spmd = backend == "spmd"
        if self._spmd and not registry.supports_spmd(self.strategy):
            raise NotImplementedError(
                f"strategy {cfg.aggregation.strategy!r} ({self.strategy.kind}"
                f" mode) does not run on the spmd engine, which takes the "
                f"mask strategies; use backend='sim'")
        self.model = get_model(
            cfg.model, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                cfg.seed))
        self.sim = StragglerSimulator(self.strategy, self.latency, cfg.seed)
        sched = schedules.from_config(cfg.optimizer,
                                      cfg.aggregation.num_workers)
        self.optimizer = make_optimizer(cfg.optimizer, sched)
        self.pipeline = SyntheticLMPipeline(SyntheticLMConfig(
            vocab_size=cfg.model.vocab_size, seq_len=cfg.shape.seq_len,
            global_batch=cfg.shape.global_batch,
            num_workers=cfg.aggregation.total_workers, seed=cfg.seed))
        step_kwargs = dict(
            num_workers=cfg.aggregation.total_workers,
            n_aggregate=cfg.aggregation.num_workers,
            ema_decay=cfg.optimizer.ema_decay,
            clip_norm=cfg.optimizer.clip_global_norm)
        chunked = cfg.chunk_size > 1
        if self._spmd:
            ex = cfg.execution
            spmd_engine.check_mesh(ex.mesh_data, ex.mesh_model)
            spmd_engine.validate_layout(cfg.aggregation.total_workers,
                                        cfg.shape.global_batch, ex.mesh_data)
            build = (spmd_engine.build_spmd_chunk_step if chunked
                     else spmd_engine.build_spmd_step)
            step_kwargs.update(
                use_kernel=ex.use_kernel, interpret=ex.interpret,
                grad_batch=ex.grad_batch, bucket_size=ex.bucket_size,
                mesh_data=ex.mesh_data, mesh_model=ex.mesh_model)
        else:
            build = build_chunk_step if chunked else build_train_step
        step = build(self.model, self.optimizer, **step_kwargs)
        if chunked:
            self.chunk_step = step
            self.prefetcher = ChunkPrefetcher(self.pipeline.cfg,
                                              depth=cfg.prefetch_depth)
        else:
            self.train_step = step
        self.step = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, seed: Optional[int] = None) -> None:
        """Draw the parameters from ``seed`` (default ``cfg.seed``) and
        initialize the optimizer state and the EMA from them."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed if seed is None else seed)
        self.model.init(gen)
        self.reset_optimizer_state()

    def reset_optimizer_state(self) -> None:
        """Optimizer state and EMA afresh from the current parameters."""
        self.opt_state = self.optimizer.init(self.params)
        self.ema = (ema_lib.init(self.params.items())
                    if self.cfg.optimizer.ema_decay > 0 else None)

    # -- checkpointing --------------------------------------------------------

    def _state_tree(self, leaf=lambda t: t) -> Dict:
        """The reference's tree: params, opt and ema in its layout."""
        def tree(named):
            return to_jax_tree({k: leaf(v) for k, v in named.items()})
        out = {"params": tree(self.params),
               "opt": {k: tree(v) for k, v in self.opt_state.items()}}
        if self.ema is not None:
            out["ema"] = tree(self.ema)
        return out

    def save_checkpoint(self) -> str:
        meta = {
            "num_workers": self.cfg.aggregation.num_workers,
            "backup_workers": self.cfg.aggregation.backup_workers,
            "strategy": self.cfg.aggregation.strategy,
            "sim_time": self.sim_time,
            "restarts": self.restarts,
            "means": {"sel_sum": self._sel_sum, "sel_count": self._sel_count,
                      "stal_sum": 0.0, "stal_count": 0},
            "data_state": self.pipeline.state.save(),
            "dead_workers": [int(w) for w in np.nonzero(self.sim.dead)[0]],
        }
        ck = self.cfg.checkpoint
        with torch.no_grad():
            return ckpt_lib.save(
                ck.directory, self.step, self._state_tree(), meta, ck.keep,
                retries=ck.write_retries, backoff_s=ck.retry_backoff_s,
                max_backoff_s=ck.retry_max_backoff_s, jitter=ck.retry_jitter,
                backoff_seed=self.cfg.seed)

    @torch.no_grad()
    def restore_checkpoint(self, step: Optional[int] = None) -> None:
        directory = self.cfg.checkpoint.directory
        manifest = ckpt_lib.read_manifest(directory, step)
        template = self._state_tree(
            leaf=lambda t: torch.empty_like(t, device="meta"))
        tree, manifest = ckpt_lib.restore(directory, template,
                                          int(manifest["step"]))

        def load(named, sub):
            for k, t in from_jax_tree(sub).items():
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
        self.pipeline.state = PipelineState.restore(manifest["data_state"])
        # replay-exact resume: the simulator is deterministic in (seed, step)
        self.sim.reset_to_step(self.step)
        if (manifest.get("num_workers") == self.cfg.aggregation.num_workers
                and manifest.get("backup_workers")
                == self.cfg.aggregation.backup_workers):
            for w in manifest.get("dead_workers", []):
                if 0 <= int(w) < self.strategy.total_workers:
                    self.sim.kill_worker(int(w))

    # -- the loop -------------------------------------------------------------

    def run(self, num_steps: int,
            kill_worker_at: Optional[Dict[int, Any]] = None,
            min_alive_behavior: str = "rescale") -> TrainResult:
        if kill_worker_at:
            raise NotImplementedError(
                f"kill_worker_at (failure injection) is not ported yet "
                f"({_FAULTS})")
        t0 = time.perf_counter()
        target = self.step + num_steps
        step_times: List[float] = []
        try:
            while self.step < target:
                if self.sim.alive < self.cfg.aggregation.num_workers:
                    if min_alive_behavior == "rescale":
                        raise NotImplementedError(
                            f"{self.sim.alive} live workers < N: elastic "
                            f"rescale is not ported yet ({_FAULTS})")
                    raise RuntimeError("insufficient live workers")
                ts = time.perf_counter()
                if self.cfg.chunk_size > 1:
                    # k == 1 still goes through the chunk path
                    k = self._chunk_len_at(self.step, target)
                    self._run_chunk(k, target)
                else:
                    k = 1
                    self._run_one_step(target)
                step_times += [(time.perf_counter() - ts) / k] * k
                every = self.cfg.checkpoint.every_steps
                if every > 0 and self.step % every == 0:
                    self.save_checkpoint()
        finally:
            self._wall_s += time.perf_counter() - t0
        return TrainResult(
            self.params, self.ema, self.metrics, self.sim_time, self.step,
            self.restarts,
            mean_selected=self._sel_sum / max(self._sel_count, 1),
            wall_time_s=self._wall_s, step_times_s=step_times)

    def _chunk_len_at(self, step: int, target: int) -> int:
        """Steps from ``step`` to the next forced boundary: the run target
        or the checkpoint cadence (so resume is unchanged by chunking).
        Also predicts the next chunks' lengths for the prefetcher."""
        k = min(self.cfg.chunk_size, target - step)
        every = self.cfg.checkpoint.every_steps
        if every > 0:
            k = min(k, every - step % every)
        return max(k, 1)

    def _next_chunk_specs(self, k: int, target: int) -> List:
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
            kk = self._chunk_len_at(s, target)
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

    def _run_one_step(self, target: int) -> None:
        """One step: plan the mask, build the batch, run the train step;
        the metrics are read back (one sync) only on a logged step."""
        ev = self.sim.next_event()
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.pipeline.next().items()}
        mask = torch.from_numpy(ev.mask).to(self.device)
        lr = self.optimizer.scalars(self.step)["lr"]
        scalars = {k: v[0] for k, v in stage_scalars(
            self.optimizer, [self.step], self.device).items()}
        m = self.train_step(self.opt_state, self.ema, scalars, batch, mask)
        self.sim_time += ev.iteration_time
        self.step += 1
        selected = int(ev.mask.sum())
        self._sel_sum += selected
        self._sel_count += 1
        if self._logged(target):
            self._log(selected, {k: float(v) for k, v in m.items()}, lr)

    def _run_chunk(self, k: int, target: int) -> None:
        """k steps through the chunk step: one copy each of the stacked
        batches, masks and scalars, one metrics read when a logged step
        falls inside the chunk."""
        steps = list(range(self.step, self.step + k))
        chunk_np = self.prefetcher.get(
            self.pipeline.state.step, k,
            next_specs=self._next_chunk_specs(k, target))
        self.pipeline.state.step += k
        events = self.sim.next_events(k)
        batches = {key: self._to_device(v) for key, v in chunk_np.items()}
        masks = self._to_device(events.masks)
        scalars = stage_scalars(self.optimizer, steps, self.device)
        ms = self.chunk_step(self.opt_state, self.ema, scalars, batches,
                             masks)
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


# ---------------------------------------------------------------------------
# The one-call entry point
# ---------------------------------------------------------------------------


def run_experiment(cfg: TrainConfig, *,
                   latency: Optional[LatencyModel] = None,
                   device=None, resume: bool = False,
                   save_final: bool = False,
                   kill_worker_at: Optional[Dict[int, Any]] = None,
                   min_alive_behavior: str = "rescale") -> TrainResult:
    """Run a mask regime (full_sync, backup, timeout) from ``cfg`` alone:
    build the Trainer, initialize or resume its state, run
    ``cfg.total_steps`` steps and return the :class:`TrainResult`."""
    tr = Trainer(cfg, latency=latency, device=device)
    if resume and ckpt_lib.latest_step(cfg.checkpoint.directory) is not None:
        tr.reset_optimizer_state()
        tr.restore_checkpoint()
    else:
        tr.init_state()
    res = tr.run(cfg.total_steps, kill_worker_at=kill_worker_at,
                 min_alive_behavior=min_alive_behavior)
    if save_final:
        tr.save_checkpoint()
    return res
