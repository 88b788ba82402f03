"""The paper's §2.1 / Appendix A.1 model: a 4-layer 3x3 CNN with
max-pooling and weight normalization in every layer, for the staleness
experiments. Reference: ``src/repro/models/mnist_cnn.py``.

Weight norm (Salimans & Kingma): w = g * v / ||v||, per output channel.
The parameters keep the reference's layouts and names (``c1.v`` an HWIO
``[3, 3, c_in, c_out]`` kernel, ``fc.v`` ``[d_in, d_out]``), so
``models.convert.load_jax_params`` carries a JAX tree over as it is.
Images are NHWC ``[B, 28, 28, 1]`` as in the reference; the convolutions
run in NCHW (``F.conv2d``) and the features are flattened in NHWC order
before the dense layer, as the reference's reshape does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


def _wn_init(gen, shape, c_out: int, device) -> common.ParamTree:
    return common.ParamTree({
        "v": common.trunc_normal(gen, shape, 0.05, device=device),
        "g": torch.ones((c_out,), device=device),
        "b": torch.zeros((c_out,), device=device)})


def _wn_conv(p, x: torch.Tensor) -> torch.Tensor:
    """x: NCHW; ``p["v"]`` HWIO; 'SAME' padding, stride 1."""
    v = p["v"]
    norm = torch.sqrt(torch.sum(torch.square(v), dim=(0, 1, 2),
                                keepdim=True) + 1e-8)
    w = (p["g"] * v / norm).permute(3, 2, 0, 1)          # HWIO -> OIHW
    return F.conv2d(x, w, p["b"], padding="same")


def _wn_dense(p, x: torch.Tensor) -> torch.Tensor:
    v = p["v"]
    norm = torch.sqrt(torch.sum(torch.square(v), dim=0, keepdim=True) + 1e-8)
    return x @ (p["g"] * v / norm) + p["b"]


class MnistCNN(nn.Module):
    """Input: [B, 28, 28, 1] (NHWC); 10-way classifier. ``device=None``
    means the card; ``generator`` (on that device) draws the weights."""

    num_classes = 10

    def __init__(self, widths: Sequence[int] = (32, 32, 64, 64), *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(widths)
        self.device = common.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, gen: torch.Generator) -> "MnistCNN":
        """(Re)draw every parameter from ``gen`` (the reference's scheme;
        not its numbers)."""
        w, dev = self.widths, self.device
        self.c1 = _wn_init(gen, (3, 3, 1, w[0]), w[0], dev)
        self.c2 = _wn_init(gen, (3, 3, w[0], w[1]), w[1], dev)
        self.c3 = _wn_init(gen, (3, 3, w[1], w[2]), w[2], dev)
        self.c4 = _wn_init(gen, (3, 3, w[2], w[3]), w[3], dev)
        self.fc = _wn_init(gen, (7 * 7 * w[3], self.num_classes),
                           self.num_classes, dev)
        return self

    def forward(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, device=self.device).permute(0, 3, 1, 2)
        x = F.relu(_wn_conv(self.c1, x))
        x = F.relu(_wn_conv(self.c2, x))
        x = F.max_pool2d(x, 2, 2)                            # 28 -> 14
        x = F.relu(_wn_conv(self.c3, x))
        x = F.relu(_wn_conv(self.c4, x))
        x = F.max_pool2d(x, 2, 2)                            # 14 -> 7
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # NHWC order
        return _wn_dense(self.fc, x)

    def per_example_loss(self, batch) -> torch.Tensor:
        logits = self.forward(batch["images"])
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        return common.softmax_cross_entropy(logits, labels)

    def accuracy(self, batch) -> torch.Tensor:
        logits = self.forward(batch["images"])
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return torch.mean((torch.argmax(logits, -1) == labels).float())


def make(widths: Sequence[int] = (32, 32, 64, 64), *, device=None,
         generator: Optional[torch.Generator] = None) -> MnistCNN:
    return MnistCNN(widths, device=device, generator=generator)
