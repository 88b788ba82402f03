"""Worker-latency sampling on the trainer's device: the device half of the
straggler simulator. Reference: ``src/repro/core/straggler_jax.py``.

Each numpy ``LatencyModel`` of ``core.straggler`` has a sampler here that
draws f32 arrivals with a ``torch.Generator`` on the device, so the
chunked trainer's device backend (``straggler_backend='device'``) plans a
whole chunk's masks on the card with no host round trip. The samplers are
distribution-equivalent to the numpy models (moments and quantiles; the
tests hold them at rel 0.05), not stream-equivalent: bit-exact replay
against the host simulator uses the ``host`` backend.

Determinism contract (the reference's): the arrivals of step ``s`` are a
pure function of ``(seed, s)``. Every step draws from its own generator,
seeded from :func:`mix_seed` ``(seed, ARRIVAL_TAG, s)``, so a run draws
the same arrivals however it is cut into chunks, and across a checkpoint
and resume. The card (Philox) and the CPU (MT19937) draw different
streams for the same seed.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.core.straggler import (DeterministicStragglers,
                                        LatencyModel, LogNormal,
                                        PaperCalibrated, Uniform)
from repro_torch.models.common import resolve_device

SampleFn = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]

# domain tags of the two per-step streams: worker arrivals here, the token
# batches in ``data.synthetic_lm.device_batch_fn``
ARRIVAL_TAG = 0x57A6
DATA_TAG = 0xDA7A

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix_seed(*parts: int) -> int:
    """A fixed 63-bit mix of integers (the port's ``fold_in``)."""
    h = 0
    for p in parts:
        h = _splitmix64(h ^ (int(p) & _MASK64))
    return h & ((1 << 63) - 1)


def step_generator(seed: int, tag: int, step: int,
                   device) -> torch.Generator:
    """The generator of one step's draws in the stream ``tag``."""
    return torch.Generator(device=device).manual_seed(
        mix_seed(seed, tag, step))


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def _exponential(gen, shape):
    return torch.empty(shape, device=gen.device,
                       dtype=torch.float32).exponential_(1.0, generator=gen)


def sample_paper_calibrated(model: PaperCalibrated, gen, shape):
    t = model.base + model.jitter * _exponential(gen, shape)
    straggle = _uniform(gen, shape) < model.p_tail
    t = t + straggle * (model.tail * _exponential(gen, shape))
    return torch.clamp_max(t, model.cap)


def sample_lognormal(model: LogNormal, gen, shape):
    z = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return model.median * torch.exp(model.sigma * z)


def sample_uniform(model: Uniform, gen, shape):
    return model.lo + (model.hi - model.lo) * _uniform(gen, shape)


def sample_deterministic_stragglers(model: DeterministicStragglers, gen,
                                    shape):
    t = model.base + model.jitter * _exponential(gen, shape)
    for w in model.slow_workers:
        t[..., w] *= model.slowdown
    return t


_SAMPLERS = {
    PaperCalibrated: sample_paper_calibrated,
    LogNormal: sample_lognormal,
    Uniform: sample_uniform,
    DeterministicStragglers: sample_deterministic_stragglers,
}


def register_sampler(model_cls, fn) -> None:
    """Extension point: fn(model, generator, shape) -> arrivals."""
    _SAMPLERS[model_cls] = fn


def sampler_for(model: LatencyModel) -> SampleFn:
    """Returns sample(generator, shape) -> arrivals for the numpy model."""
    for cls, fn in _SAMPLERS.items():
        if type(model) is cls:
            return lambda gen, shape: fn(model, gen, shape)
    raise NotImplementedError(
        f"no JAX sampler registered for {type(model).__name__}; "
        "use straggler_backend='host' or register_sampler()")


def _mark_dead(arr: torch.Tensor, dead) -> torch.Tensor:
    """``dead``: None, or a [W] bool (a tensor on ``arr``'s device, so the
    trainer's chunk stays free of host copies, or anything array-like)."""
    if dead is None:
        return arr
    dead = torch.as_tensor(dead, dtype=torch.bool, device=arr.device)
    return arr.masked_fill(dead, float("inf"))


def step_arrivals(model: LatencyModel, seed: int, step: int, workers: int,
                  dead=None, device=None) -> torch.Tensor:
    """Arrivals [W] of one step, from the generator of ``(seed, step)``;
    dead workers -> +inf. ``device`` None means the card."""
    gen = step_generator(seed, ARRIVAL_TAG, step, resolve_device(device))
    return _mark_dead(sampler_for(model)(gen, (workers,)), dead)


def chunk_arrivals(sample_fn: SampleFn, seed: int, steps: Sequence[int],
                   num_workers: int, dead=None,
                   device=None) -> torch.Tensor:
    """[K, W] arrivals of a chunk: row i from step ``steps[i]``'s own
    generator (so a chunk equals its steps drawn one by one), dead workers
    at +inf. A few launches a step and no host sync. ``device`` None means
    the card."""
    device = resolve_device(device)
    rows = [sample_fn(step_generator(seed, ARRIVAL_TAG, s, device),
                      (num_workers,)) for s in steps]
    return _mark_dead(torch.stack(rows), dead)

