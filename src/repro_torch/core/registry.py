"""String-keyed strategy registry: ``AggregationConfig`` -> strategy.
Reference: ``src/repro/core/registry.py``.

``get_strategy(cfg)`` is the trainer's only construction path. The port
registers every strategy of the reference: the mask strategies
(full_sync, backup, timeout, dynamic_backup) and the event strategies
(async, softsync, staleness); an unknown name raises ``ValueError``
listing the valid ones. ``supports_spmd`` and ``supports_event_scan`` are
the reference's capability checks.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.core import coordination

_BUILDERS: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    """Decorator: register a builder(cfg) -> CoordinationStrategy."""

    def deco(fn: Callable) -> Callable:
        _BUILDERS[name] = fn
        return fn

    return deco


def available() -> List[str]:
    return sorted(_BUILDERS)


def supports_spmd(strategy: coordination.CoordinationStrategy,
                  exec_cfg=None) -> bool:
    """True when the strategy can run on the spmd engine: any mask
    strategy, unless it opts out with ``spmd_supported = False``; with an
    ``ExecutionConfig`` of ``mesh_model > 1`` it must also allow tensor
    parallelism (``spmd_tp_supported``, default True). Event strategies
    never run there. When this is False the trainer warns and falls back
    to the sim backend, as the reference's does."""
    ok = (getattr(strategy, "kind", "") == "mask"
          and bool(getattr(strategy, "spmd_supported", True)))
    if ok and exec_cfg is not None and getattr(exec_cfg, "mesh_model", 1) > 1:
        ok = bool(getattr(strategy, "spmd_tp_supported", True))
    return ok


def supports_event_scan(strategy: coordination.CoordinationStrategy) -> bool:
    """True when an event strategy implements the chunked plan/scan
    protocol (``plan_arrival`` + ``on_arrival_scan``) that the chunked
    event path (``chunk_size > 1``) needs. A plugin with only
    ``on_arrival`` runs per arrival."""
    return (getattr(strategy, "kind", "") == "event"
            and bool(getattr(strategy, "scan_supported", False)))


def get_strategy(agg_cfg) -> coordination.CoordinationStrategy:
    """Build the strategy named by ``agg_cfg.strategy``."""
    name = agg_cfg.strategy
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown coordination strategy {name!r}; "
            f"valid strategies: {', '.join(available())}") from None
    return builder(agg_cfg)


@register("full_sync")
def _full_sync(cfg) -> coordination.FullSync:
    return coordination.FullSync(cfg.total_workers)


@register("backup")
def _backup(cfg) -> coordination.BackupWorkers:
    return coordination.BackupWorkers(cfg.num_workers, cfg.backup_workers)


@register("timeout")
def _timeout(cfg) -> coordination.Timeout:
    return coordination.Timeout(cfg.num_workers, cfg.deadline_s)


@register("dynamic_backup")
def _dynamic_backup(cfg) -> coordination.DynamicBackup:
    return coordination.DynamicBackup(
        cfg.num_workers, cfg.backup_workers, cfg.dynamic_window,
        cfg.dynamic_min_workers, latency_source=cfg.latency_source)


@register("async")
def _async(cfg) -> coordination.Async:
    return coordination.Async(cfg.num_workers)


@register("softsync")
def _softsync(cfg) -> coordination.SoftSync:
    return coordination.SoftSync(cfg.num_workers, cfg.softsync_c)


@register("staleness")
def _staleness(cfg) -> coordination.Staleness:
    return coordination.Staleness(cfg.staleness_tau, cfg.staleness_ramp_steps,
                                  cfg.staleness_jitter)
