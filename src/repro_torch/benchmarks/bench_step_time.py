"""Step-time microbenchmark: wall time per train step for every
architecture's smoke config (the ``name,us_per_call`` contract).
Reference: ``benchmarks/bench_step_time.py`` (``_bench_arch``, ``run``).

Each arch's step is ``train/train_step.build_train_step`` (4 workers, 3
aggregated, SGD at 0.01) over a batch of 8 x 32 random tokens, with the
vlm's zero prefix embeddings and the encoder-decoder's zero frames; the
first step is the warmup, then ``iters`` steps are timed, the interval
ending with a ``torch.cuda.synchronize`` on the card. The model's weights
are drawn from seed 0, the batch from seed 1. Returns the reference's
payload (``{"step_time.<arch>": us}``); writes it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_step_time [--device cpu]
        [--quick]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.models import get_model
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import schedules
from repro_torch.train.train_step import build_train_step

WORKERS, AGGREGATED = 4, 3
BATCH, SEQ = 8, 32


def step_batch(cfg, device, seed: int = 1) -> Dict[str, torch.Tensor]:
    """The step's batch: random tokens and labels from ``seed``, a vlm's
    zero prefix embeddings, an encoder-decoder's zero frames."""
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                              generator=gen, device=device)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(
            (BATCH, cfg.num_prefix_embeds, cfg.d_model),
            dtype=dtype_of(cfg.dtype), device=device)
    if cfg.family == "audio":
        batch["encoder_frames"] = torch.zeros(
            (BATCH, cfg.encoder_seq_len, cfg.d_model),
            dtype=dtype_of(cfg.dtype), device=device)
    return batch


def _bench_arch(arch: str, iters: int, device, model=None,
                batch: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[float, float]:
    """(us a step, the warmup step's loss) of ``arch``'s smoke config;
    ``model`` / ``batch`` replace the seeded ones."""
    cfg = configs.get_smoke_config(arch)
    if model is None:
        model = get_model(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
    opt = opt_lib.sgd(schedules.constant(0.01))
    step = build_train_step(model, opt, num_workers=WORKERS,
                            n_aggregate=AGGREGATED)
    opt_state = opt.init(dict(model.named_parameters()))
    if batch is None:
        batch = step_batch(cfg, device)
    mask = torch.ones(WORKERS, dtype=torch.bool, device=device)
    scalars = opt.scalars(0)
    first = float(step(opt_state, None, scalars, batch, mask)["loss"])
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(opt_state, None, scalars, batch, mask)
    common.sync(device)
    return (time.perf_counter() - t0) * 1e6 / iters, first


def run(quick: bool = True, device=None) -> List[Tuple[str, float, str]]:
    """The harness contract: (name, us_per_call, derived)."""
    device = resolve_device(device)
    iters = 3 if quick else 20
    where = "CPU" if device.type == "cpu" else "card"
    return [(f"step_time.{arch}", _bench_arch(arch, iters, device)[0],
             f"smoke-config {where} train step")
            for arch in configs.list_archs()]


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 timed steps an arch (20 without)")
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run(args.quick, device)
    for row in rows:
        print(",".join(str(x) for x in row))
    payload = {name: us for name, us, _ in rows}
    common.write_out(args.out, payload, device)
    return payload


if __name__ == "__main__":
    main()
