"""Mesh layouts for planning, as plain data (no process group, no device).
Reference: ``src/repro/launch/mesh.py`` (``make_production_mesh``, :74;
``make_host_mesh``, :81).

The reference builds ``jax`` meshes: the production 16 x 16 pod, its two-pod
2 x 16 x 16 with a leading ``'pod'`` axis, and small host meshes. Here a
layout is a name and its axis sizes; ``launch/dryrun.py`` plans a cell on
it. The ``'pod'`` axis folds into the data axes, as the reference's
``dp_axes`` does: the port's engine has the ``('data', 'model')`` mesh of
``distributed/mesh.py`` (rank r at data index r // M, model index r % M).

The card meshes are the one-node layouts ``D x M`` over 1, 2, 4 and 8
cards. The reference's XLA flag recipe (``enable_latency_hiding`` /
``set_platform``, :34-:64) has no PyTorch meaning and no counterpart; the
train CLI refuses ``--platform`` by name.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

CARD_COUNTS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A named mesh: ``axes`` and their ``shape`` (the reference's
    ``Mesh.axis_names`` and ``devices.shape``)."""

    name: str
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def data(self) -> int:
        """The data-parallel extent: ``'pod'`` x ``'data'``."""
        return self.sizes.get("pod", 1) * self.sizes.get("data", 1)

    @property
    def model(self) -> int:
        return self.sizes.get("model", 1)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 = 256 chips per pod; multi_pod adds a leading 2-pod axis."""
    if multi_pod:
        return MeshLayout("multi", (2, 16, 16), ("pod", "data", "model"))
    return MeshLayout("single", (16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshLayout:
    """A ``data x model`` mesh, named ``DxM``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1 (got {data} x {model})")
    return MeshLayout(f"{data}x{model}", (data, model), ("data", "model"))


def card_meshes() -> Tuple[MeshLayout, ...]:
    """Every ``D x M`` layout of one node's 1, 2, 4 or 8 cards, by card
    count, then from all-data to all-model."""
    return tuple(make_host_mesh(n // m, m) for n in CARD_COUNTS
                 for m in range(1, n + 1) if n % m == 0)


def mesh_by_name(name: str) -> MeshLayout:
    """``single``, ``multi`` or ``DxM``."""
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi")
    try:
        d, m = (int(x) for x in name.split("x"))
    except ValueError:
        raise ValueError(f"unknown mesh {name!r}: 'single', 'multi' or "
                         f"'DxM'") from None
    return make_host_mesh(d, m)
