"""Synthetic MNIST-like dataset for the paper's §2.1 staleness experiment.
Reference: ``src/repro/data/mnist_like.py`` (the whole module, numpy only:
datasets and batches equal the reference's bit for bit).

10 classes of 28x28 images: each class is a fixed random low-frequency
template; samples are template + small random rotation/zoom (the paper's
augmentation) + pixel noise. Linearly separable enough that the 4-layer
CNN reaches ~99% — leaving visible headroom for staleness degradation,
mirroring the paper's 0.36% -> 0.79% error inflation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MnistLikeConfig:
    num_train: int = 8192
    num_test: int = 2048
    image_size: int = 28
    num_classes: int = 10
    seed: int = 0
    noise: float = 0.35
    augment: bool = True     # paper: small rotations and zooms


def _templates(cfg: MnistLikeConfig) -> np.ndarray:
    rng = np.random.RandomState(cfg.seed)
    n = cfg.image_size
    # low-frequency templates: random 7x7 upsampled bilinearly
    coarse = rng.randn(cfg.num_classes, 7, 7)
    xi = np.linspace(0, 6, n)
    x0 = np.floor(xi).astype(int).clip(0, 5)
    fx = xi - x0
    up = (coarse[:, x0][:, :, x0] * (1 - fx)[None, :, None] * (1 - fx)[None, None, :]
          + coarse[:, x0 + 1][:, :, x0] * fx[None, :, None] * (1 - fx)[None, None, :]
          + coarse[:, x0][:, :, x0 + 1] * (1 - fx)[None, :, None] * fx[None, None, :]
          + coarse[:, x0 + 1][:, :, x0 + 1] * fx[None, :, None] * fx[None, None, :])
    return up.astype(np.float32)


def _augment(imgs: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Small rotations (±10 deg) and zooms (±8%) via affine resampling."""
    n, h, w = imgs.shape
    out = np.empty_like(imgs)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        th = rng.uniform(-0.17, 0.17)
        z = rng.uniform(0.92, 1.08)
        c, s = np.cos(th) / z, np.sin(th) / z
        sy = c * (yy - cy) - s * (xx - cx) + cy
        sx = s * (yy - cy) + c * (xx - cx) + cx
        y0 = np.clip(sy.astype(int), 0, h - 1)
        x0 = np.clip(sx.astype(int), 0, w - 1)
        out[i] = imgs[i, y0, x0]
    return out


def make_dataset(cfg: MnistLikeConfig) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    rng = np.random.RandomState(cfg.seed + 1)
    tpl = _templates(cfg)

    def sample(n: int, augment: bool):
        labels = rng.randint(0, cfg.num_classes, size=n)
        imgs = tpl[labels].copy()
        if augment and cfg.augment:
            imgs = _augment(imgs, rng)
        imgs += cfg.noise * rng.randn(*imgs.shape).astype(np.float32)
        return {"images": imgs[..., None].astype(np.float32),
                "labels": labels.astype(np.int32)}

    return sample(cfg.num_train, True), sample(cfg.num_test, False)


def batches(data: Dict[str, np.ndarray], batch_size: int, seed: int, steps: int):
    """Infinite shuffled batch iterator, deterministic in (seed, step)."""
    n = data["labels"].shape[0]
    for step in range(steps):
        rng = np.random.RandomState(seed * 7919 + step)
        idx = rng.randint(0, n, size=batch_size)
        yield {k: v[idx] for k, v in data.items()}
