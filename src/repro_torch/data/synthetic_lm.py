"""Deterministic synthetic LM token pipeline.
Reference: ``src/repro/data/synthetic_lm.py`` (the numpy parts, :25-158,
and ``chunk_batches`` / ``ChunkPrefetcher``, :123-229).

A learnable token stream — an affine Markov chain over the vocab mixed
with uniform noise — seeded per (worker, step), so every worker draws a
disjoint shard and the stream replays exactly from (seed, step). Batches
equal the reference's bit for bit. The chunked loop takes its K stacked
batches from ``chunk_batches`` through the ``ChunkPrefetcher``. The device
twin ``device_batch_fn`` (reference :88-120) draws the same chain and
noise with a ``torch.Generator`` on the device, for the device straggler
backend: the same distribution and per-(seed, step) determinism, not the
same stream.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_workers: int = 1
    seed: int = 0
    noise: float = 0.1       # probability of a uniform-random token
    order: int = 1           # Markov order of the deterministic skeleton


def _transition(vocab: int, seed: int):
    """A fixed permutation-like transition: next = (a*tok + b) % V."""
    rng = np.random.RandomState(seed)
    a = int(rng.randint(1, vocab - 1)) | 1      # odd => full cycle for pow2 V
    b = int(rng.randint(0, vocab))
    return a, b


@functools.lru_cache(maxsize=64)
def _chain_tables(vocab: int, seed: int, seq_len: int):
    """Closed form of the affine chain: tok_t = (a^t*s0 + b*g_t) mod V with
    g_t = sum_{i<t} a^i, precomputed per config."""
    a, b = _transition(vocab, seed)
    pow_a = np.empty(seq_len + 1, np.int64)
    geo = np.empty(seq_len + 1, np.int64)
    p, g = 1, 0
    for t in range(seq_len + 1):
        pow_a[t] = p
        geo[t] = g
        g = (g + p) % vocab
        p = (p * a) % vocab
    return pow_a, (b * geo) % vocab


def worker_batch(cfg: SyntheticLMConfig, worker: int, step: int) -> Dict[str, np.ndarray]:
    """The [B/W, S] shard of the global batch for `worker` at `step`."""
    per_worker = cfg.global_batch // cfg.num_workers
    pow_a, offset = _chain_tables(cfg.vocab_size, cfg.seed, cfg.seq_len)
    rng = np.random.RandomState(
        ((cfg.seed * 1_000_003 + step) * 4097 + worker) % (2 ** 32))
    start = rng.randint(0, cfg.vocab_size, size=(per_worker, 1))
    seq = (pow_a[None, :] * start + offset[None, :]) % cfg.vocab_size
    noise_mask = rng.rand(per_worker, cfg.seq_len + 1) < cfg.noise
    noise_toks = rng.randint(0, cfg.vocab_size, size=seq.shape)
    seq = np.where(noise_mask, noise_toks, seq).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def global_batch(cfg: SyntheticLMConfig, step: int) -> Dict[str, np.ndarray]:
    """Concatenation of all workers' shards: worker w owns rows
    [w*B/W, (w+1)*B/W), the blocking the backup mask indexes."""
    shards = [worker_batch(cfg, w, step) for w in range(cfg.num_workers)]
    return {k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]}


def device_batch_fn(cfg: SyntheticLMConfig, device=None):
    """The device twin of ``global_batch``: batch_fn(step) -> {tokens,
    labels} ``[B, S]`` int32 tensors on ``device``, drawn from the
    generator of ``(seed, DATA_TAG, step)`` (a stream apart from the
    arrivals'), with no host work but the launches. Same chain and noise
    rate as the numpy pipeline, not the same stream. ``device`` None means
    the card."""
    if cfg.vocab_size > 46340:   # pow_a * start must fit int32 (no x64)
        raise NotImplementedError(
            "device_batch_fn needs vocab_size <= 46340; use the host pipeline")
    import torch
    from repro_torch.core.straggler_device import DATA_TAG, step_generator
    from repro_torch.models.common import resolve_device
    device = resolve_device(device)
    pow_a_np, offset_np = _chain_tables(cfg.vocab_size, cfg.seed, cfg.seq_len)
    pow_a = torch.from_numpy(pow_a_np.astype(np.int32)).to(device)
    offset = torch.from_numpy(offset_np.astype(np.int32)).to(device)
    shape = (cfg.global_batch, cfg.seq_len + 1)

    def batch_fn(step: int):
        gen = step_generator(cfg.seed, DATA_TAG, step, device)
        start = torch.randint(0, cfg.vocab_size, (cfg.global_batch, 1),
                              generator=gen, device=device,
                              dtype=torch.int32)
        seq = (pow_a[None, :] * start + offset[None, :]) % cfg.vocab_size
        noise = torch.rand(shape, generator=gen, device=device) < cfg.noise
        noise_toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   device=device, dtype=torch.int32)
        seq = torch.where(noise, noise_toks, seq)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    return batch_fn


def chunk_batches(cfg: SyntheticLMConfig, start_step: int, k: int
                  ) -> Dict[str, np.ndarray]:
    """K stacked global batches [K, B, ...], bit-identical to k
    ``global_batch`` calls: one host->device transfer per chunk."""
    batches = [global_batch(cfg, s) for s in range(start_step, start_step + k)]
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def save(self) -> Dict:
        return {"step": self.step}

    @staticmethod
    def restore(d: Dict) -> "PipelineState":
        return PipelineState(step=int(d["step"]))


class SyntheticLMPipeline:
    """Stateful iterator with save/restore (checkpointable)."""

    def __init__(self, cfg: SyntheticLMConfig, state: Optional[PipelineState] = None):
        self.cfg = cfg
        self.state = state or PipelineState()

    def next(self) -> Dict[str, np.ndarray]:
        batch = global_batch(self.cfg, self.state.step)
        self.state.step += 1
        return batch


class ChunkPrefetcher:
    """Look-ahead chunk generation for the chunked trainer.

    After serving chunk [step, step+k) it builds up to ``depth`` upcoming
    chunks on background threads (depth 1 is double buffering), so host
    batch generation overlaps the device's work. Generation is pure in
    (cfg, step): a mispredicted boundary (a checkpoint, the last ragged
    chunk) falls back to building the chunk in the caller, and the served
    batches are the same at every depth. The caller's ``PipelineState``
    owns the position, never the threads. The threads run numpy only.
    """

    def __init__(self, cfg: SyntheticLMConfig, depth: int = 1):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0 (got {depth})")
        self.cfg = cfg
        self.depth = depth
        # in-flight speculations, oldest first: [(spec, thread, holder)]
        self._pending: list = []

    def _launch(self, step: int, k: int) -> None:
        holder: Dict = {}

        def work():
            holder["chunk"] = chunk_batches(self.cfg, step, k)

        th = threading.Thread(target=work, daemon=True,
                              name="repro-torch-chunk-prefetch")
        th.start()
        self._pending.append(((step, k), th, holder))

    def _take(self, step: int, k: int) -> Optional[Dict[str, np.ndarray]]:
        """Pop the speculation matching (step, k); reap stale ones."""
        chunk = None
        keep = []
        for spec, th, holder in self._pending:
            if spec == (step, k) and chunk is None:
                th.join()
                chunk = holder.get("chunk")
            elif spec[0] > step:
                keep.append((spec, th, holder))   # still ahead: may hit later
            else:
                th.join()                         # stale: reap and drop
        self._pending = keep
        return chunk

    def get(self, step: int, k: int, next_k: Optional[int] = None,
            next_specs: Optional[List[Tuple[int, int]]] = None
            ) -> Dict[str, np.ndarray]:
        """The stacked chunk for [step, step+k).

        ``next_specs`` predicts the following chunks as (step, k) pairs;
        the first ``depth`` of them not yet in flight are built on
        background threads. ``next_k`` is the depth-1 shorthand for
        ``next_specs=[(step + k, next_k)]``. None or empty: no
        speculation (the last chunk of a run)."""
        if next_specs is None:
            next_specs = [(step + k, next_k)] if next_k else []
        chunk = self._take(step, k)
        if chunk is None:
            chunk = chunk_batches(self.cfg, step, k)
        inflight = {spec for spec, _, _ in self._pending}
        for spec in next_specs[:max(self.depth, 0)]:
            if len(self._pending) >= self.depth:
                break
            if tuple(spec) not in inflight:
                self._launch(*spec)
        return chunk
