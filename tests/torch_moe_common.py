"""Helpers shared by the MoE parity suites (``test_torch_moe.py``,
``test_torch_moe_train.py``): the smoke config at a capacity factor, the
JAX ``init`` jitted once per architecture, one torch thread. Imports JAX:
for CPU tests only."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import transformer as jtransformer

ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under the parallel tier-1 run torch's default
    of a thread per core multiplies the time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def smoke_jcfg(capacity_factor=8.0, **kw):
    """The JAX smoke config at ``capacity_factor``, other fields ``kw``."""
    cfg = with_moe(jconfigs.get_smoke_config(ARCH),
                   capacity_factor=capacity_factor)
    return dataclasses.replace(cfg, **kw)


_INITS = {}


@pytest.fixture(autouse=True, scope="module")
def jitted_jax_init():
    """The JAX transformer's ``init`` jitted once per architecture (eager
    it takes seconds; the capacity factor and the remat policy change no
    parameter), for every JAX caller in the module: the trainers and the
    CLIs too. The same keys give the same parameters."""
    orig = jtransformer.TransformerLM.init

    def init(self, key):
        arch = dataclasses.replace(with_moe(self.cfg, capacity_factor=8.0),
                                   remat="none")
        if arch not in _INITS:
            _INITS[arch] = jax.jit(lambda k: orig(self, k))
        return _INITS[arch](key)

    mp = pytest.MonkeyPatch()
    mp.setattr(jtransformer.TransformerLM, "init", init)
    yield
    mp.undo()


def jax_params(jcfg, seed):
    """The JAX ``init`` of ``jcfg`` at ``seed``, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jget_model(jcfg).init(
        jax.random.PRNGKey(seed)))
