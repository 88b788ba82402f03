"""Port parity, layer by layer: repro_torch.models.{common, mlp, attention}
and repro_torch.configs against the JAX reference on the same numpy
inputs and weights (qwen3 smoke config, f32).

Tolerance: atol 1e-5 (rtol 1e-5) on f32 layers — both sides run the same
f32 algebra and differ only in summation order and transcendental
rounding. The int8 KV quantizer is compared bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp

from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttransformer
from repro.models import transformer as jtransformer
from torch_parity import t2n, to_module

ATOL = RTOL = 1e-5
ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def cfgs():
    return jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t2n(t), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_configs_match_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.resolved_head_dim, t.padded_vocab, t.q_per_kv) == \
        (j.resolved_head_dim, j.padded_vocab, j.q_per_kv)


def test_unported_arch_is_a_clear_key_error():
    """Every arch of the reference is ported, in its order; an unknown one
    is a ``KeyError`` naming it, as in the reference."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    with pytest.raises(KeyError, match="unknown arch 'whisper-large'"):
        tconfigs.get_config("whisper-large")
    with pytest.raises(KeyError, match="unknown arch 'whisper-large'"):
        jconfigs.get_config("whisper-large")


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_rmsnorm_matches(cfgs):
    x = _x(0, (2, 5, 64), 3.0)
    scale = _x(1, (64,)) + 1.0
    j = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    t = tcommon.rmsnorm(to_module({"scale": scale}), torch.from_numpy(x), 1e-6)
    _close(t, j)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = _x(2, (2, 7, 4, 16))
    pos = np.random.RandomState(3).randint(0, 600, size=(2, 7))
    j = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    t = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles reach ~600 rad, so sin/cos differ by a few f32 ulps of 600
    _close(t, j, atol=2e-4, rtol=1e-5)


def test_softcap_and_activations():
    x = _x(4, (3, 9), 20.0)
    _close(tcommon.softcap(torch.from_numpy(x), 30.0),
           jcommon.softcap(jnp.asarray(x), 30.0))
    assert torch.equal(tcommon.softcap(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))
    for name in ("gelu", "silu", "relu", "relu_sq", "swiglu"):
        _close(tcommon.activation(name)(torch.from_numpy(x)),
               jcommon.activation(name)(jnp.asarray(x)))


def test_mlp_matches(cfgs):
    jcfg, _ = cfgs
    p = jmlp.mlp_init(jax.random.PRNGKey(0), 64, 128, "swiglu")
    x = _x(5, (2, 3, 64))
    j = jmlp.mlp_apply(p, jnp.asarray(x), "swiglu")
    t = tmlp.mlp_apply(to_module(p), torch.from_numpy(x), "swiglu")
    _close(t, j)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_params(cfgs):
    jcfg, _ = cfgs
    p = jattn.gqa_init(jax.random.PRNGKey(1), jcfg)
    return p, to_module(p)


def test_project_qkv_matches(cfgs, attn_params):
    jcfg, tcfg = cfgs
    jp, tp = attn_params
    x = _x(6, (2, 6, 64))
    pos = np.broadcast_to(np.arange(3, 9), (2, 6)).copy()
    jq = jattn._project_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tq = tattn._project_qkv(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    for t, j in zip(tq, jq):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0),
                                            (4, 2.0)])
def test_gqa_attend_matches(cfgs, attn_params, window, softcap):
    jcfg, tcfg = cfgs
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=softcap)
    tcfg = dataclasses.replace(tcfg, attn_logit_softcap=softcap)
    jp, tp = attn_params
    x = _x(7, (2, 9, 64))
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    j = jattn.gqa_attend(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                         window=window)
    t = tattn.gqa_attend(tp, tcfg, torch.from_numpy(x),
                         torch.from_numpy(pos), window=window)
    _close(t, j)


@pytest.mark.parametrize("s_q,s_kv,causal,window,off", [
    (5, 5, True, 0, 0), (4, 9, True, 3, 5), (6, 6, False, 0, 0),
    (6, 6, False, 2, 0)])
def test_attention_mask_matches(s_q, s_kv, causal, window, off):
    j = jattn.make_attention_mask(s_q, s_kv, causal=causal, window=window,
                                  q_offset=off)
    t = tattn.make_attention_mask(s_q, s_kv, causal=causal, window=window,
                                  q_offset=off)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_expand_kv_matches():
    k = _x(8, (2, 3, 2, 4))
    for rep in (1, 2, 3):
        np.testing.assert_array_equal(
            tattn._expand_kv(torch.from_numpy(k), rep).numpy(),
            np.asarray(jattn._expand_kv(jnp.asarray(k), rep)))


def test_quantize_kv_bit_equal():
    """int8 payload and f16 scale bit-equal, including rounding ties:
    values at exact half steps exercise round-half-to-even on both sides,
    and the f16 cast of the scale happens after the payload is rounded."""
    x = _x(9, (3, 5, 2, 16)) * np.asarray([0.01, 1.0, 30.0],
                                          np.float32)[:, None, None, None]
    x[0, 0, 0, :4] = [0.0, 0.0, 0.0, 0.0]            # all-zero row: scale floor
    x[1, 0, 0, :] = np.arange(16, dtype=np.float32) - 7.5   # ties
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint16),
                                  np.asarray(js).view(np.uint16))
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        dq_t = tattn._dequantize_kv(tq, ts, dt_t)
        dq_j = jattn._dequantize_kv(jq, js, dt_j)
        np.testing.assert_array_equal(t2n(dq_t),
                                      np.asarray(dq_j).astype(np.float32))


# ---------------------------------------------------------------------------
# transformer helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,every", [(0, 0), (4, 0), (4, 3)])
def test_layer_windows_match(cfgs, window, every):
    jcfg, tcfg = cfgs
    kw = dict(num_layers=7, sliding_window=window, global_every=every)
    np.testing.assert_array_equal(
        ttransformer.layer_windows_np(dataclasses.replace(tcfg, **kw)),
        jtransformer.layer_windows_np(dataclasses.replace(jcfg, **kw)))
    assert ttransformer.segments(tcfg) == jtransformer.segments(jcfg)


def test_trunc_normal_is_two_sigma():
    gen = torch.Generator().manual_seed(0)
    t = tcommon.trunc_normal(gen, (20_000,), 0.5)
    assert float(t.abs().max()) <= 1.0 + 1e-6
    assert 0.40 < float(t.std()) < 0.46          # 0.5 * 0.8796 (2-sigma)
