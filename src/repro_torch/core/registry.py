"""String-keyed strategy registry: ``AggregationConfig`` -> strategy.
Reference: ``src/repro/core/registry.py``.

``get_strategy(cfg)`` is the trainer's only construction path. The port
registers the three mask strategies; a strategy of the reference that is
not ported yet raises ``NotImplementedError`` naming its slice, and an
unknown name raises ``ValueError`` listing the valid ones.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.core import coordination

_BUILDERS: Dict[str, Callable] = {}

# the reference's other strategies, and the queue item that ports each
_NOT_PORTED = {
    "dynamic_backup": "ROADMAP Queue 1 item 7 (fault tolerance)",
    "async": "ROADMAP Queue 1 item 6 (event regimes)",
    "softsync": "ROADMAP Queue 1 item 6 (event regimes)",
    "staleness": "ROADMAP Queue 1 item 6 (event regimes)",
}


def register(name: str) -> Callable:
    """Decorator: register a builder(cfg) -> CoordinationStrategy."""

    def deco(fn: Callable) -> Callable:
        _BUILDERS[name] = fn
        return fn

    return deco


def available() -> List[str]:
    return sorted(_BUILDERS)


def supports_spmd(strategy: coordination.CoordinationStrategy) -> bool:
    """True when the strategy can run on the spmd engine: the mask
    strategies. (The reference's per-plugin opt-outs come with the
    event-regime slice, ROADMAP Queue 1 item 6.)"""
    return strategy.kind == "mask"


def get_strategy(agg_cfg) -> coordination.CoordinationStrategy:
    """Build the strategy named by ``agg_cfg.strategy``."""
    name = agg_cfg.strategy
    if name in _NOT_PORTED and name not in _BUILDERS:
        raise NotImplementedError(
            f"strategy {name!r} is not ported to repro_torch yet "
            f"({_NOT_PORTED[name]}); ported: {', '.join(available())}")
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
