"""The blocked online-softmax attention core against the JAX package, on
the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
``init`` (``torch_parity.to_module`` for a bare attention subtree). f32,
TF32 off (``torch_parity``), one intra-op thread.

* ``chunked_attention_core`` against the JAX function: causal, window,
  softcap, non-causal with more keys than queries, and ragged query and
  key lengths, with chunks of 8 and 5 so that a short S crosses blocks
  (atol 1e-5); and against the port's own dense attention.
* ``gqa_attend_chunked`` against the JAX function and against the port's
  ``gqa_attend`` (GQA, window, softcap), atol 1e-5.
* The switches above the threshold, lowered by a direct call: MLA's long
  path (nope and rope folded into one head dim, v padded and sliced back)
  against the JAX long path built from the JAX functions and against the
  JAX dense ``mla_attend``; the transformer block (gemma3's window and
  softcap) with both packages' thresholds lowered; hymba's and whisper's
  switches against their dense paths.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import get_model as jget_model
from repro.models import transformer as jtransformer
from repro.models import whisper as jwhisper

from repro_torch.models import attention as tattention
from repro_torch.models import get_model, load_jax_params
from repro_torch.models import transformer as ttransformer
from repro_torch.models import whisper as twhisper
from torch_moe_common import one_torch_thread  # noqa: F401
from torch_parity import port_config, t2n, to_module

TOL = 1e-5


def _qkv(seed, b, s, s_kv, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, n, h, d).astype(np.float32)
                 for n in (s, s_kv, s_kv))


CORE_CASES = {
    "causal": dict(s=21, s_kv=21, causal=True),
    "window": dict(s=21, s_kv=21, causal=True, window=6),
    "softcap": dict(s=21, s_kv=21, causal=True, softcap=2.0),
    "window_softcap_ragged": dict(s=19, s_kv=19, causal=True, window=4,
                                  softcap=1.5, q_chunk=5, kv_chunk=5),
    "cross_ragged_kv": dict(s=7, s_kv=23, causal=False),
    "cross_more_queries": dict(s=17, s_kv=9, causal=False, q_chunk=4,
                               kv_chunk=4),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_chunked_core_matches_jax(case):
    kw = dict(CORE_CASES[case])
    s, s_kv = kw.pop("s"), kw.pop("s_kv")
    kw.setdefault("q_chunk", 8)
    kw.setdefault("kv_chunk", 8)
    q, k, v = _qkv(3, 2, s, s_kv, 3, 16)
    want = jattention.chunked_attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattention.chunked_attention_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert got.shape == (2, s, 3, 16)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)
    # one block (chunks past S) gives the same attention
    whole = tattention.chunked_attention_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{**kw, "q_chunk": 2048, "kv_chunk": 2048})
    np.testing.assert_allclose(t2n(got), t2n(whole), rtol=0, atol=TOL)


def test_chunked_core_matches_dense_attention():
    """Causal with a window and a softcap: the blocked core equals the
    masked softmax over the whole [S, S] scores."""
    q, k, v = _qkv(4, 2, 30, 30, 2, 8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattention.chunked_attention_core(tq, tk, tv, window=7,
                                            softcap=3.0, q_chunk=8,
                                            kv_chunk=6)
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(8)
    scores = 3.0 * torch.tanh(scores / 3.0)
    mask = tattention.make_attention_mask(30, 30, window=7)
    probs = torch.softmax(scores.masked_fill(~mask, tattention.NEG_INF), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, tv)
    np.testing.assert_allclose(t2n(got), t2n(want), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# GQA through the core
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma():
    """gemma3's smoke config (GQA 4 / 1 heads, window 8, qk-norm) with a
    softcap, its attention params from the JAX init."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("gemma3-1b"),
                               attn_logit_softcap=2.0)
    params = jax.tree_util.tree_map(np.asarray, jattention.gqa_init(
        jax.random.PRNGKey(5), jcfg))
    return jcfg, port_config(jcfg), params, to_module(params)


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_attend_chunked_matches_jax_and_dense(gemma, window):
    jcfg, tcfg, params, module = gemma
    x = np.random.RandomState(6).randn(2, 27, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(27), (2, 27))
    want = jattention.gqa_attend_chunked(
        params, jcfg, jnp.asarray(x), jnp.asarray(pos), window=window,
        q_chunk=8, kv_chunk=8)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    got = tattention.gqa_attend_chunked(module, tcfg, tx, tpos,
                                        window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)
    dense = tattention.gqa_attend(module, tcfg, tx, tpos, window=window)
    np.testing.assert_allclose(t2n(got), t2n(dense), rtol=0, atol=TOL)


def test_transformer_block_switches_above_the_threshold(gemma, monkeypatch):
    """A block over more tokens than ``CHUNKED_ATTN_THRESHOLD`` (lowered to
    16 in both packages) runs the blocked core: the port's block equals
    the JAX block and the port's dense block."""
    jcfg, tcfg, _, _ = gemma
    jparams = jax.tree_util.tree_map(np.asarray, jtransformer.block_init(
        jax.random.PRNGKey(7), jcfg, "dense", jnp.float32))
    tblock = ttransformer.block_init(torch.Generator(), tcfg, "dense",
                                     torch.float32, "cpu")
    load = {k.replace("/", "."): v for k, v in _flat(jparams).items()}
    with torch.no_grad():
        for name, p in tblock.named_parameters():
            p.copy_(torch.from_numpy(np.array(load[name], np.float32)))
    x = np.random.RandomState(8).randn(1, 24, jcfg.d_model).astype(
        np.float32)
    pos = np.arange(24)[None]
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    with torch.no_grad():
        dense = ttransformer.block_apply(tblock, tcfg, tx, tpos, 5)
    monkeypatch.setattr(jtransformer, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(ttransformer, "CHUNKED_ATTN_THRESHOLD", 16)
    calls = []
    orig = tattention.gqa_attend_chunked
    monkeypatch.setattr(tattention, "gqa_attend_chunked",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    want, _ = jtransformer.block_apply(jparams, jcfg, "dense",
                                       jnp.asarray(x), jnp.asarray(pos), 5)
    with torch.no_grad():
        got = ttransformer.block_apply(tblock, tcfg, tx, tpos, 5)
    assert calls == [1]
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(got), t2n(dense), rtol=0, atol=TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


# ---------------------------------------------------------------------------
# MLA's long path
# ---------------------------------------------------------------------------


def _jax_mla_long(params, cfg, x, positions, **chunks):
    """The reference's branch above 8,192 tokens, from its own functions:
    ``_mla_qkv``, ``_mla_expand_kv``, the fold, the pad, the core."""
    b, s, _ = x.shape
    h, m = cfg.num_heads, cfg.mla
    q_nope, q_rope, c_kv, k_rope = jattention._mla_qkv(params, cfg, x,
                                                       positions)
    k_nope, v = jattention._mla_expand_kv(params, cfg, c_kv)
    qk = jnp.concatenate([q_nope, q_rope], axis=-1)
    kk = jnp.concatenate(
        [k_nope, jnp.broadcast_to(k_rope, (b, s, h, m.qk_rope_dim))], -1)
    d_qk = m.qk_nope_dim + m.qk_rope_dim
    v_pad = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, d_qk - m.v_head_dim)))
    out = jattention.chunked_attention_core(qk, kk, v_pad, causal=True,
                                            **chunks)[..., :m.v_head_dim]
    return out.reshape(b, s, -1) @ params["wo"]["w"]


@pytest.mark.parametrize("q_lora", [0, 16], ids=["q_full", "q_lora16"])
def test_mla_long_path_matches_jax(q_lora, monkeypatch):
    """``MLA_DENSE_MAX_LEN`` lowered to 8 and the core's chunks to 8: the
    port's long path over 21 tokens equals the JAX long path (its
    functions composed as its branch composes them) and the JAX dense
    ``mla_attend``."""
    base = jconfigs.get_smoke_config("deepseek-v2-lite-16b")
    jcfg = dataclasses.replace(base, mla=dataclasses.replace(
        base.mla, q_lora_rank=q_lora))
    tcfg = port_config(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jattention.mla_init(
        jax.random.PRNGKey(9), jcfg))
    module = to_module(params)
    x = np.random.RandomState(10).randn(2, 21, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(21), (2, 21))
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    monkeypatch.setattr(tattention, "MLA_DENSE_MAX_LEN", 8)
    monkeypatch.setattr(tattention, "chunked_attention_core", functools.partial(
        tattention.chunked_attention_core, q_chunk=8, kv_chunk=8))
    got = tattention.mla_attend(module, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    long_jax = _jax_mla_long(params, jcfg, jx, jpos, q_chunk=8, kv_chunk=8)
    dense_jax = jattention.mla_attend(params, jcfg, jx, jpos)
    np.testing.assert_allclose(t2n(got), np.asarray(long_jax), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(t2n(got), np.asarray(dense_jax), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# The switches of the hybrid and audio families
# ---------------------------------------------------------------------------


def test_hymba_forward_switches_above_the_threshold(monkeypatch):
    """Hymba's blocks over more tokens than the threshold (lowered to 8)
    attend through ``gqa_attend_chunked``, with the window: the logits
    equal the dense path's and the JAX forward's."""
    jcfg = jconfigs.get_smoke_config("hymba-1.5b")
    jmodel = jget_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(11)))
    tmodel = load_jax_params(get_model(port_config(jcfg), device="cpu"),
                             params)
    toks = np.random.RandomState(12).randint(0, jcfg.vocab_size, (2, 19))
    with torch.no_grad():
        dense = tmodel(torch.from_numpy(toks))
        monkeypatch.setattr(ttransformer, "CHUNKED_ATTN_THRESHOLD", 8)
        calls = []
        orig = tattention.gqa_attend_chunked
        monkeypatch.setattr(
            tattention, "gqa_attend_chunked",
            lambda *a, **k: calls.append(k["window"]) or orig(
                *a, **k, q_chunk=8, kv_chunk=8))
        got = tmodel(torch.from_numpy(toks))
    assert calls == [jcfg.sliding_window] * jcfg.num_layers
    want = jax.jit(jmodel.forward)(params, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(t2n(got), t2n(dense), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)


def test_whisper_attention_switches_above_the_threshold(monkeypatch):
    """Whisper's self and cross attention over more than
    ``CHUNK_THRESHOLD`` tokens (lowered to 8 in both packages) take the
    blocked core: the forward equals the JAX forward under the same
    threshold and the port's dense forward."""
    jcfg = jconfigs.get_smoke_config("whisper-tiny")
    jmodel = jget_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(13)))
    tmodel = load_jax_params(get_model(port_config(jcfg), device="cpu"),
                             params)
    rng = np.random.RandomState(14)
    toks = rng.randint(0, jcfg.vocab_size, (2, 12))
    frames = (0.5 * rng.randn(2, jcfg.encoder_seq_len, jcfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        dense = tmodel(torch.from_numpy(toks), torch.from_numpy(frames))
    monkeypatch.setattr(jwhisper, "CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(twhisper, "CHUNK_THRESHOLD", 8)
    calls = []
    orig = tattention.chunked_attention_core
    monkeypatch.setattr(tattention, "chunked_attention_core",
                        lambda *a, **k: calls.append(k["causal"]) or orig(
                            *a, **k))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks), torch.from_numpy(frames))
    # encoder self (16 frames), decoder self and cross (12 tokens)
    assert calls == [False] * jcfg.num_encoder_layers + \
        [True, False] * jcfg.num_layers
    want = jmodel.forward(params, jnp.asarray(toks, jnp.int32),
                          encoder_frames=jnp.asarray(frames))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(got), t2n(dense), rtol=0, atol=TOL)
