"""The toy serve path against the JAX package: contiguous-cache decode,
RWKV-6's carried state, ``train.serve_step`` and the ``--toy`` CLI.

* ``gqa_decode`` against the JAX one step for step (fp and int8 caches;
  no window, a window, a ring buffer written at ``len % size``): outputs
  and the cache contents.
* ``decode_step`` against JAX's on each dense smoke (qwen3, gemma3,
  minitron, command-r-plus), fp and int8 caches, from the same JAX
  parameters; gemma3 decodes 20 tokens past its window of 8.
* Stepped decode against ``forward`` at the reference's tolerance (2e-3;
  ``tests/test_serve.py``), gemma3 past its window; ``prefill`` against
  the last position of ``forward``.
* ``greedy_generate``'s tokens equal the JAX one's, bucketed and exact;
  ``bucketed_max_len`` equals the reference's.
* RWKV-6: ``init_cache``, ``decode_step`` (the carried state: logits and
  every state leaf) and ``prefill`` against JAX's.
* The ``--toy`` CLI's token rows equal the JAX CLI's for every ported
  arch, fp and int8, on the same prompt and parameters; its cross-flag
  errors are the reference's.

f32 tolerance 1e-4 (atol and rtol): both sides run the same f32 algebra
and differ in summation order and transcendental rounding; int8 caches
dequantize the same payload (the quantizer is bit-equal, layers test).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import serve as jcli
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.train import serve_step as jserve_step

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tcli
from repro_torch.models import attention as tattn
from repro_torch.models import get_model, load_jax_params
from repro_torch.train import serve_step as tserve_step
from torch_parity import t2n, to_module

TOL = 1e-4
DENSE = ["qwen3-0.6b", "gemma3-1b", "minitron-4b", "command-r-plus-104b"]
ARCHS = DENSE + ["rwkv6-1.6b"]
CACHES = {"fp": None, "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the parallel tier-1 run torch's default
    of a thread per core multiplies the time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX model, JAX params, the port's model on them)}."""
    out = {}
    for arch in ARCHS:
        jmodel = jget_model(jconfigs.get_smoke_config(arch))
        params = jmodel.init(jax.random.PRNGKey(0))
        tmodel = load_jax_params(
            get_model(tconfigs.get_smoke_config(arch), device="cpu"), params)
        out[arch] = (jmodel, params, tmodel)
    return out


def _tokens(vocab, b=2, s=12, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t2n(t), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# gqa_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("kind,size,window", [("full", 12, 0),
                                              ("window", 12, 4),
                                              ("ring", 5, 5)])
def test_gqa_decode_matches_jax(cache, kind, size, window):
    """Ten tokens through one layer's decode, with softcap: each step's
    output and the final cache (payload, scales) against JAX's; the ring
    buffer (size 5) wraps twice, written at ``len % size`` with no window
    mask, as ``_decode_block`` drives it."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-0.6b"),
                               attn_logit_softcap=20.0)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen3-0.6b"),
                               attn_logit_softcap=20.0)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jcfg)
    tp = to_module(jp)
    dtypes = CACHES[cache] or (jnp.float32, torch.float32)
    jc = jattn.gqa_init_cache(jcfg, 2, size, dtypes[0])
    tc = tattn.gqa_init_cache(tcfg, 2, size, dtypes[1])
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    ring = kind == "ring"
    xs = np.random.RandomState(4).randn(10, 2, 1, 64).astype(np.float32)
    for t, x in enumerate(xs):
        if not ring and t >= size:
            break
        kw = dict(window=0 if ring else window,
                  write_pos=t % size if ring else None)
        jo, jc = jattn.gqa_decode(jp, jcfg, jnp.asarray(x), jc,
                                  jnp.int32(t), **kw)
        with torch.no_grad():
            to, tc2 = tattn.gqa_decode(tp, tcfg, torch.from_numpy(x), tc,
                                       t, **kw)
        assert tc2 is tc                          # updated in place
        _close(to, jo)
    for name in jc:
        if name in ("k", "v") and cache == "int8":
            np.testing.assert_array_equal(t2n(tc[name]), np.asarray(jc[name]))
        else:
            _close(tc[name], np.asarray(jc[name], np.float32))


def test_gqa_decode_refuses_a_full_cache():
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    p = tattn.gqa_init(torch.Generator().manual_seed(0), cfg)
    cache = tattn.gqa_init_cache(cfg, 1, 4, torch.float32)
    with pytest.raises(ValueError, match="outside the cache"):
        tattn.gqa_decode(p, cfg, torch.zeros(1, 1, 64), cache, 4)


# ---------------------------------------------------------------------------
# decode_step, prefill
# ---------------------------------------------------------------------------


def _jax_stepped(jmodel, params, tokens, max_len, dtype=None):
    cache = jmodel.init_cache(tokens.shape[0], max_len, dtype)
    step = jax.jit(jmodel.decode_step)
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = step(params, jnp.asarray(tokens[:, i:i + 1]), cache)
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), cache


def _torch_stepped(tmodel, tokens, max_len, dtype=None):
    cache = tmodel.init_cache(tokens.shape[0], max_len, dtype)
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = tmodel.decode_step(
            torch.from_numpy(tokens[:, i:i + 1]), cache)
        outs.append(logits)
    return torch.stack(outs, dim=1), cache


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax(models, arch, cache):
    """Each step's logits and every layer's final cache against JAX's;
    gemma3 (window 8, global every 3) decodes 28 tokens into a 32-slot
    cache, its local layers' 8-slot ring buffers wrapping."""
    jmodel, params, tmodel = models[arch]
    s = 28 if arch == "gemma3-1b" else 12
    toks = _tokens(jmodel.cfg.vocab_size, s=s)
    dt = CACHES[cache]
    want, jcache = _jax_stepped(jmodel, params, toks, 32,
                                dt and dt[0])
    got, tcache = _torch_stepped(tmodel, toks, 32, dt and dt[1])
    _close(got, want)
    assert tcache["lens"] == int(jcache["lens"]) == s
    for tl, jl in zip(tcache["seg_dense"], jcache["seg_dense"]):
        assert set(tl) == set(jl)
        for name in jl:
            assert tuple(tl[name].shape) == jl[name].shape
            _close(tl[name], np.asarray(jl[name], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """The reference's equivalence (``tests/test_serve.py``): stepping
    ``decode_step`` reproduces ``forward``'s logits (2e-3)."""
    _, _, tmodel = models[arch]
    toks = _tokens(tmodel.cfg.vocab_size, s=12, seed=2)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(toks).long())
    stepped, _ = _torch_stepped(tmodel, toks, 12)
    np.testing.assert_allclose(t2n(stepped), t2n(full), atol=2e-3,
                               rtol=2e-3)


def test_gemma_ring_buffer_beyond_window(models):
    """20 tokens through the window of 8 (cache of 20 positions: the local
    layers' rings hold 8) against the full forward."""
    _, _, tmodel = models["gemma3-1b"]
    toks = _tokens(tmodel.cfg.vocab_size, b=1, s=20, seed=3)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(toks).long())
    stepped, cache = _torch_stepped(tmodel, toks, 20)
    sizes = [c["k"].shape[1] for c in cache["seg_dense"]]
    assert sizes == [8, 8, 20, 8, 8, 20]
    np.testing.assert_allclose(t2n(stepped), t2n(full), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_forward_last_position(models, arch):
    jmodel, params, tmodel = models[arch]
    toks = _tokens(tmodel.cfg.vocab_size, s=10, seed=4)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(toks).long())
        pre = tmodel.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(pre), t2n(full[:, -1]), atol=TOL,
                               rtol=TOL)
    _close(pre, jmodel.prefill(params, jnp.asarray(toks)))


# ---------------------------------------------------------------------------
# RWKV-6: the carried state
# ---------------------------------------------------------------------------


def test_rwkv_decode_carries_the_reference_state(models):
    """``init_cache`` (O(1) in S: the same leaves and shapes for any
    max_len), then 12 steps: each step's logits and, at the end, every
    layer's token-shift vectors and f32 wkv state against JAX's."""
    jmodel, params, tmodel = models["rwkv6-1.6b"]
    small, big = tmodel.init_cache(2, 8), tmodel.init_cache(2, 4096)
    jcache0 = jmodel.init_cache(2, 8)
    for ts, tb, js in zip(small["state"], big["state"], jcache0["state"]):
        for k in js:
            assert tuple(ts[k].shape) == tuple(tb[k].shape) == js[k].shape
            assert ts[k].dtype == (torch.float32)
    toks = _tokens(tmodel.cfg.vocab_size, s=12, seed=5)
    want, jcache = _jax_stepped(jmodel, params, toks, 8)
    got, tcache = _torch_stepped(tmodel, toks, 8)
    _close(got, want)
    assert tcache["lens"] == int(jcache["lens"]) == 12
    for ts, js in zip(tcache["state"], jcache["state"]):
        for k in ("att_x", "att_s", "ffn_x"):
            _close(ts[k], np.asarray(js[k]))


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need", [-1, 0, 1, 7, 8, 9, 16, 17, 100, 1000])
def test_bucketed_max_len_matches(need):
    if need <= 0:
        for fn in (jserve_step.bucketed_max_len,
                   tserve_step.bucketed_max_len):
            with pytest.raises(ValueError, match="positive"):
                fn(need)
        return
    for floor in (8, 4):
        assert tserve_step.bucketed_max_len(need, floor) == \
            jserve_step.bucketed_max_len(need, floor)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(models, arch, bucket):
    jmodel, params, tmodel = models[arch]
    prompt = _tokens(tmodel.cfg.vocab_size, s=5, seed=6)
    want = jserve_step.greedy_generate(jmodel, params, jnp.asarray(prompt),
                                       num_tokens=6, max_len=11,
                                       bucket=bucket)
    marks = []
    got = tserve_step.greedy_generate(tmodel, torch.from_numpy(prompt), 6,
                                      11, bucket=bucket, marks=marks)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(marks) == 3 and marks == sorted(marks)


def test_built_steps_call_the_model(models):
    _, _, tmodel = models["qwen3-0.6b"]
    toks = torch.from_numpy(_tokens(tmodel.cfg.vocab_size, s=6))
    with torch.no_grad():
        pre = tserve_step.build_prefill(tmodel)({"tokens": toks.long()})
        torch.testing.assert_close(pre, tmodel.prefill(toks.long()))
    cache = tmodel.init_cache(2, 8)
    logits, cache = tserve_step.build_decode_step(tmodel)(toks[:, :1], cache)
    assert tuple(logits.shape) == (2, tmodel.cfg.padded_vocab)
    assert cache["lens"] == 1


# ---------------------------------------------------------------------------
# The --toy CLI
# ---------------------------------------------------------------------------


_ROW = re.compile(r"^  (\[.*\])$", re.M)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_toy_cli_rows_match_jax_cli(arch, int8, capsys, monkeypatch):
    """Both CLIs on the same prompt (the port's numpy rule, handed to the
    JAX CLI's ``jax.random.randint``) and the same JAX parameters (loaded
    into the port's model): the header and the token rows match."""
    argv = ["--arch", arch, "--toy", "--batch", "2", "--prompt-len", "4",
            "--tokens", "5", "--seed", "3"] + (["--cache-int8"] if int8
                                               else [])
    cfg = tconfigs.get_smoke_config(arch)
    prompt = tcli.toy_prompt(3, 2, 4, cfg.vocab_size)
    assert prompt.shape == (2, 4) and (prompt < cfg.vocab_size).all()
    params = jget_model(jconfigs.get_smoke_config(arch)).init(
        jax.random.PRNGKey(3))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt, jnp.int32))
    jcli.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(tcli, "get_model", lambda c, device, generator:
                        load_jax_params(get_model(c, device=device), params))
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    cache = "int8" if int8 else cfg.dtype
    for out in (want, got):
        assert out.startswith(f"[serve] {arch} cache={cache} prefill ")
        assert "decode 5 toks x 2 seqs in" in out
    assert _ROW.findall(got) == _ROW.findall(want) and \
        len(_ROW.findall(got)) == 2


@pytest.mark.parametrize("argv,match", [
    (["--restore", "ck"], "--toy is the legacy static path"),
    (["--mesh-model", "2"], "--toy is the legacy static path"),
    (["--faults", "slowdown@1"], "--toy is the legacy static path"),
    (["--slo-p99-ms", "5"], "--slo-p99-ms has no --toy support"),
    (["--trace", "t.json"], "--trace has no --toy support"),
    (["--metrics", "m.jsonl"], "--metrics has no --toy support"),
    (["--replicas", "2"], "no --toy")])
def test_toy_cli_cross_flag_errors(argv, match):
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match=match):
            main(["--toy"] + argv)
