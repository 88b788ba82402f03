"""Shared benchmark plumbing: the tiny-LM problem, SGD, the time to a
target loss, the harness benches' timing and result file. Reference:
``benchmarks/common.py`` (``tiny_lm_config``, ``tiny_lm_problem``,
``sgd_update_fn``, ``time_to_threshold``, ``quick_mode``, ``write_bench``,
``_provenance``).

The port's benchmarks print their numbers and return the reference's
payloads. They write no ``BENCH_*.json``: a harness bench writes its
payload only to the path its caller passes (``--out PATH``,
:func:`write_out`), stamped with a ``provenance`` block that names the
commit, torch and the card (``nvidia-smi``'s name and power limit).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import replace
from repro_torch.core.coordination import make_grad_fn
from repro_torch.data.synthetic_lm import SyntheticLMConfig, worker_batch
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device

# the held-out stream: a worker id no run draws from, and its batches
HELDOUT_WORKER = 997
HELDOUT_BATCHES = 4

BENCH_SCHEMA_VERSION = 1
_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")


def quick_mode() -> bool:
    return os.environ.get("REPRO_BENCH_FULL", "0") not in ("1", "true")


def sync(device=None) -> None:
    """Wait for the card (the reference's ``block_until_ready``); nothing
    on the CPU."""
    if torch.device(device or "cpu").type == "cuda":
        torch.cuda.synchronize()


def best_of(items: Sequence, run: Callable[[Any], None], reps: int,
            device=None) -> List[float]:
    """The interleaved best-of-``reps`` timing of the reference's
    ``measure_all``: ``reps`` rounds of ``run(item)`` over every item in
    turn (so drift does not penalize whichever is measured last), each
    interval ending on the card (:func:`sync`); the least seconds per
    item."""
    best = [math.inf] * len(items)
    for _ in range(reps):
        for i, item in enumerate(items):
            t0 = time.perf_counter()
            run(item)
            sync(device)
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def card() -> Dict[str, Optional[str]]:
    """``nvidia-smi --query-gpu=name,power.limit``'s first card (None for
    each field where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"name": None, "power.limit": None}
    name, limit = (f.strip() for f in out.rsplit(",", 1))
    return {"name": name, "power.limit": limit}


def provenance(device) -> Dict[str, Any]:
    """{schema_version, git_sha, torch_version, device, name, power.limit}:
    the reference's block with torch and the card in place of
    ``jax_version`` / ``device_kind``. Outside a git checkout the sha
    records as "unknown"."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_ROOT,
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        sha = ""
    dev = torch.device(device)
    return {"schema_version": BENCH_SCHEMA_VERSION,
            "git_sha": sha or "unknown", "torch_version": torch.__version__,
            "device": str(dev),
            **(card() if dev.type == "cuda"
               else {"name": None, "power.limit": None})}


def write_out(path: Optional[str], payload: Dict, device) -> Optional[str]:
    """Write ``payload`` with its ``provenance`` to ``path`` (JSON); no
    path, no file. Returns the path written."""
    if not path:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(payload, provenance=provenance(device)), f, indent=2,
                  default=float)
    return path


def add_harness_args(ap) -> None:
    """The flags every harness bench takes besides the reference's:
    ``--device`` and ``--out``."""
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the payload and its provenance here as "
                         "JSON (nothing is written without it)")


def tiny_lm_config(vocab: int = 64):
    cfg = configs.get_smoke_config("qwen3-0.6b")
    return replace(cfg, vocab_size=vocab, num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_pad_multiple=16)


def stream_entropy(vocab: int, noise: float) -> float:
    """Nats per token of the synthetic Markov stream given its past: the
    lowest loss a model can reach. A label is the chain's next token with
    probability 1 - noise + noise / V, any other with noise / V."""
    hit = 1.0 - noise + noise / vocab
    return -hit * math.log(hit) - (vocab - 1) * (noise / vocab) * math.log(
        noise / vocab)


def heldout_eval(model, data_cfg: SyntheticLMConfig
                 ) -> Callable[[Mapping[str, torch.Tensor]], float]:
    """eval_fn(params) -> the mean loss of ``model`` at ``params`` over the
    held-out worker's ``HELDOUT_BATCHES`` batches of ``data_cfg``'s stream.
    ``params`` are copied into ``model`` unless they are its own."""
    dev = next(model.parameters()).device
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                worker_batch(data_cfg, HELDOUT_WORKER, i).items()}
               for i in range(HELDOUT_BATCHES)]
    own = dict(model.named_parameters())

    @torch.no_grad()
    def eval_fn(params: Mapping[str, torch.Tensor]) -> float:
        for k, p in own.items():
            if params[k] is not p:
                p.copy_(params[k])
        return float(np.mean([model.per_token_loss(b)[0].mean().cpu().numpy()
                              for b in batches]))

    return eval_fn


def tiny_lm_problem(vocab: int = 64, seq: int = 32, batch: int = 16,
                    workers: int = 1, seed: int = 0, noise: float = 0.2,
                    device=None):
    """Returns (model, params0, grad_fn, batch_fn, eval_fn) on ``device``
    (``None`` = the card).

    ``params0`` are the model's own parameters, drawn on the CPU from
    ``seed`` (so the card and the CPU start alike); grad_fn(params, batch)
    -> (loss, grads); batch_fn(worker, draw) -> batch; eval_fn(params) ->
    held-out loss. The functions load ``params`` into the model unless
    they are its own.
    """
    dev = resolve_device(device)
    cfg = tiny_lm_config(vocab)
    init = get_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    model = init if dev.type == "cpu" else get_model(cfg, device=dev)
    model.load_state_dict(init.state_dict())
    data_cfg = SyntheticLMConfig(vocab_size=vocab, seq_len=seq,
                                 global_batch=batch * workers,
                                 num_workers=workers, seed=seed, noise=noise)

    def batch_fn(worker: int, draw: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(dev)
                for k, v in worker_batch(data_cfg, worker, draw).items()}

    return (model, dict(model.named_parameters()), make_grad_fn(model),
            batch_fn, heldout_eval(model, data_cfg))


def sgd_update_fn(lr: float):
    """update(params, opt_state, grads, step) -> (params, opt_state):
    ``p - lr * g``, in place."""
    @torch.no_grad()
    def update(params, opt_state, grads, step):
        for k, p in params.items():
            p.sub_(lr * grads[k])
        return params, opt_state
    return update


def time_to_threshold(times: np.ndarray, losses: np.ndarray,
                      eps: float) -> Optional[float]:
    """First (smoothed) time the loss crosses below eps; None if never."""
    if len(losses) == 0:
        return None
    k = max(1, len(losses) // 50)
    smooth = np.convolve(losses, np.ones(k) / k, mode="same")
    idx = np.argmax(smooth <= eps)
    if smooth[idx] > eps:
        return None
    return float(times[idx])
