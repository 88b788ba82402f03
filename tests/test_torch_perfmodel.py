"""The port's analytic FLOP / HBM-byte model
(``repro_torch.analysis.perfmodel``) against ``repro.analysis.perfmodel``.

* ``cell_flops``: every arch of ``list_archs()`` x every shape of
  ``SHAPES_BY_NAME`` x remat none / full / dots, every field equal with
  ``==`` (plain host arithmetic in the reference's order).
* ``cell_bytes`` at (chips, model_shard) in {(1, 1), (4, 2), (256, 16)},
  ZeRO-1 on and off, every field equal with ``==``; ``_avg_kv`` and
  ``_cache_total_bytes`` too.
* The reference's ``tests/test_perfmodel.py`` invariants, on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_stub import given, settings, st

from repro import configs as jconfigs
from repro.analysis import perfmodel as jperf
from repro.configs.base import SHAPES_BY_NAME as JSHAPES

from repro_torch import configs
from repro_torch.analysis import perfmodel
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig, replace
from repro_torch.models import registry

ARCHS = configs.list_archs()
REMATS = ("none", "full", "dots")
MESHES = ((1, 1), (4, 2), (256, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_archs_and_shapes_are_the_reference_grid():
    assert ARCHS == jconfigs.list_archs()
    assert list(SHAPES_BY_NAME) == list(JSHAPES)
    for name, shape in SHAPES_BY_NAME.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("shape", list(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_flops_bit_equal(arch, shape, remat):
    got = perfmodel.cell_flops(configs.get_config(arch),
                               SHAPES_BY_NAME[shape], remat=remat)
    want = jperf.cell_flops(jconfigs.get_config(arch), JSHAPES[shape],
                            remat=remat)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape", list(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_bytes_bit_equal(arch, shape, mesh):
    chips, model_shard = mesh
    for zero1 in (True, False):
        for remat in ("none", "full"):
            kw = dict(chips=chips, model_shard=model_shard, zero1=zero1,
                      remat=remat)
            got = perfmodel.cell_bytes(configs.get_config(arch),
                                       SHAPES_BY_NAME[shape], **kw)
            want = jperf.cell_bytes(jconfigs.get_config(arch),
                                    JSHAPES[shape], **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert perfmodel._cache_total_bytes(
        configs.get_config(arch), SHAPES_BY_NAME[shape]) == \
        jperf._cache_total_bytes(jconfigs.get_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_the_reference(arch):
    from repro.models import registry as jregistry
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for active in (False, True):
        assert perfmodel._param_count(cfg, active_only=active) == \
            registry.param_count(cfg, active_only=active) == \
            jregistry.param_count(jcfg, active_only=active)


@pytest.mark.parametrize("seq,window", [(2, 0), (7, 3), (100, 100),
                                        (4096, 512), (4096, 0), (33, 1)])
def test_avg_kv_bit_equal(seq, window):
    assert perfmodel._avg_kv(seq, window) == jperf._avg_kv(seq, window)


# ---------------------------------------------------------------------------
# The reference's invariants (tests/test_perfmodel.py), on the port
# ---------------------------------------------------------------------------


@given(seq=st.integers(2, 4096), window=st.integers(0, 4096))
@settings(max_examples=50, deadline=None)
def test_avg_kv_bounds(seq, window):
    v = perfmodel._avg_kv(seq, window)
    assert 1.0 <= v <= (seq + 1) / 2 + 1e-9
    if 0 < window < seq:
        assert v <= window
    w = window if window > 0 else seq
    brute = np.mean([min(i + 1, w) for i in range(seq)])
    assert v == pytest.approx(brute, rel=1e-9)


def test_flops_scaling_relations():
    shape = SHAPES_BY_NAME["train_4k"]
    cfg = configs.get_config("qwen3-0.6b")
    f1 = perfmodel.cell_flops(cfg, shape)
    f2 = perfmodel.cell_flops(replace(cfg, num_layers=2 * cfg.num_layers),
                              shape)
    assert f2.fwd_layers == pytest.approx(2 * f1.fwd_layers, rel=1e-6)
    f_none = perfmodel.cell_flops(cfg, shape, remat="none")
    assert f1.train - f_none.train == pytest.approx(f1.fwd_layers, rel=1e-6)


def test_moe_flops_use_active_params():
    shape = SHAPES_BY_NAME["train_4k"]
    cfg = configs.get_config("qwen2-moe-a2.7b")
    f = perfmodel.cell_flops(cfg, shape)
    t = shape.global_batch * shape.seq_len
    active = registry.param_count(cfg, active_only=True)
    assert 2 * 0.4 * active * t < f.fwd_layers < 2.5 * active * t


def test_sliding_window_reduces_attention_flops():
    shape = SHAPES_BY_NAME["prefill_32k"]
    cfg = configs.get_config("gemma3-1b")
    assert perfmodel.cell_flops(cfg, shape).fwd < perfmodel.cell_flops(
        replace(cfg, sliding_window=0), shape).fwd


def test_decode_flops_scale_with_cache():
    cfg = configs.get_config("qwen3-0.6b")
    assert perfmodel.cell_flops(cfg, SHAPES_BY_NAME["decode_32k"]).decode > \
        perfmodel.cell_flops(cfg, ShapeConfig("d", 1024, 128, "decode")).decode


def test_bytes_model_sanity():
    shape = SHAPES_BY_NAME["train_4k"]
    cfg = configs.get_config("qwen3-0.6b")
    b = perfmodel.cell_bytes(cfg, shape, chips=256, model_shard=16)
    b_nozero = perfmodel.cell_bytes(cfg, shape, chips=256, model_shard=16,
                                    zero1=False)
    assert b.train < b_nozero.train
    assert b.fwd < b.train
    d32 = perfmodel.cell_bytes(cfg, SHAPES_BY_NAME["decode_32k"], chips=256,
                               model_shard=16)
    assert 0 < d32.cache_bytes < d32.decode


def test_cache_bytes_family_structure():
    d = SHAPES_BY_NAME["long_500k"]
    kw = dict(chips=256, model_shard=16)
    rwkv = perfmodel.cell_bytes(configs.get_config("rwkv6-1.6b"), d, **kw)
    gemma = perfmodel.cell_bytes(configs.get_config("gemma3-1b"), d, **kw)
    assert rwkv.cache_bytes < gemma.cache_bytes / 10
    ds = perfmodel.cell_bytes(configs.get_config("deepseek-v2-lite-16b"),
                              SHAPES_BY_NAME["decode_32k"], **kw)
    qw = perfmodel.cell_bytes(configs.get_config("qwen2-moe-a2.7b"),
                              SHAPES_BY_NAME["decode_32k"], **kw)
    assert ds.cache_bytes < qw.cache_bytes
