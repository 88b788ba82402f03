"""Helpers shared by the ``test_torch_*.py`` parity suites.

Inputs are made with numpy from a seed and handed to both the JAX
reference and the PyTorch port; TF32 stays off so f32 matmuls on a card
are full f32.
"""
import numpy as np
import pytest
import torch
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def to_module(tree) -> nn.Module:
    """Nested dict of arrays (a JAX param subtree) -> ModuleDict /
    ParameterDict with the same keys, as f32 CPU parameters."""
    if all(not isinstance(v, dict) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.array(v, np.float32)),
                            requires_grad=False)
            for k, v in tree.items()})
    return nn.ModuleDict({k: to_module(v) for k, v in tree.items()})


def t2n(t: torch.Tensor) -> np.ndarray:
    """Torch tensor -> numpy, bf16/f16 widened to f32 exactly."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def j2n(a) -> np.ndarray:
    """JAX array -> numpy, bf16/f16 widened to f32 exactly."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind not in "biuf" or \
        a.dtype.itemsize < 4 and a.dtype.kind == "f" else a


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture
def fake_world_of_two():
    """A world of 2 ranks inside this process (torch's ``fake`` backend:
    collectives return at once), so that a ``mesh_model=2`` object can be
    built here; spawned runs are the rank files' (``torch_*_ranks.py``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        yield
    finally:
        mesh._mesh.clear()
        dist.destroy_process_group()


def ragged_table(seed, b, maxp, num_pages):
    """A ragged page table: slot 0 full, slot 1 half, slot 2 idle (all
    trash page), the rest random lengths; live ids distinct, never 0."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((b, maxp), np.int32)
    lens = [maxp, maxp // 2, 0] + list(rng.randint(0, maxp + 1, size=b - 3))
    pos = 0
    for i, n in enumerate(lens):
        tbl[i, :n] = ids[pos:pos + n]
        pos += n
    return tbl


def random_pool(seed, shape, quantized):
    """(payload, scales): an f32 pool, or an int8 pool with f16 scales."""
    rng = np.random.RandomState(seed)
    if quantized:
        payload = rng.randint(-127, 128, size=shape).astype(np.int8)
        scales = (rng.rand(*shape[:3]) * 0.1).astype(np.float16)
        return payload, scales
    return rng.randn(*shape).astype(np.float32), None


def qkv_inputs(seed, b, s, h, kv, d, dtype=np.float32, scale=0.5):
    """q [B, S, H, D], k/v [B, S, KV, D] (numpy, normal times ``scale``;
    at 1.0, the scale qk-norm gives, scores q.k/sqrt(D) have std ~1)."""
    rng = np.random.RandomState(seed)
    return tuple((scale * rng.randn(b, s, n, d)).astype(dtype)
                 for n in (h, kv, kv))


def port_config(obj):
    """A JAX config dataclass (any nesting) -> the port's class of the same
    name with the same field values, through the fields alone."""
    import dataclasses
    from repro_torch.configs import base as tbase
    if dataclasses.is_dataclass(obj):
        cls = getattr(tbase, type(obj).__name__)
        return cls(**{f.name: port_config(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj

