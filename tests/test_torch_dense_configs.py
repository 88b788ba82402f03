"""The dense configs (gemma3-1b, minitron-4b, command-r-plus-104b) against
the JAX package.

* Each ``CONFIG`` and ``smoke_config()`` equals the reference's dataclass
  field for field (and its derived head dim, padded vocabulary and GQA
  ratio).
* Smoke loss and gradients: the mean ``per_token_loss`` over the valid
  labels and its gradient for every parameter, from the same JAX
  parameters (``load_jax_params``), against ``jax.value_and_grad``: f32,
  atol 1e-5 (relative to each leaf's largest gradient) and rtol 1e-4.
  gemma3's smoke runs its sliding windows (8, global every 3) past the
  window with qk-norm, gelu and the embedding scale; minitron's relu_sq
  and its untied head; command-r-plus's swiglu with a tied head.
* The paged engine's greedy tokens equal the JAX engine's, fp and int8
  pools, on the same trace (prompts to 12 tokens, up to 8 new: gemma3's
  windows of 8 bind).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TraceConfig as JTraceConfig
from repro.serve import make_trace as jmake_trace

from repro_torch import configs as tconfigs
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from torch_parity import t2n

ARCHS = ["gemma3-1b", "minitron-4b", "command-r-plus-104b"]
ENGINE_KW = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the parallel tier-1 run torch's default
    of a thread per core multiplies the time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, getter):
    j = getattr(jconfigs, getter)(arch)
    t = getattr(tconfigs, getter)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.resolved_head_dim, t.padded_vocab, t.q_per_kv) == \
        (j.resolved_head_dim, j.padded_vocab, j.q_per_kv)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jmodel = jget_model(jconfigs.get_smoke_config(arch))
    params = jmodel.init(jax.random.PRNGKey(2))
    tmodel = load_jax_params(
        get_model(tconfigs.get_smoke_config(arch), device="cpu"), params)
    return arch, jmodel, params, tmodel


def _batch(vocab, b=2, s=20, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return {"tokens": toks, "labels": labels}


def test_smoke_loss_and_grads_match_jax(pair):
    arch, jmodel, params, tmodel = pair
    batch = _batch(jmodel.cfg.vocab_size)
    n = float((batch["labels"] >= 0).sum())

    def jloss(p):
        return jnp.sum(jmodel.per_token_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()})[0]) / n

    jl, jg = jax.value_and_grad(jloss)(params)
    tmodel.zero_grad()
    per_tok, aux = tmodel.per_token_loss(batch)
    tl = per_tok.sum() / n
    tl.backward()
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(
            t2n(got[k]), g, rtol=1e-4,
            atol=1e-5 * (np.abs(g).max() + 1e-6), err_msg=f"{arch} {k}")


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_paged_engine_tokens_match_jax(pair, int8):
    arch, jmodel, params, tmodel = pair
    kw = dict(num_requests=8, rate=2.0, prompt_len_min=2,
              prompt_len_max=12, max_new_min=2, max_new_max=8,
              vocab=jmodel.cfg.vocab_size, seed=5)
    want = JServeEngine(jmodel.cfg, params, cache_int8=int8,
                        **ENGINE_KW).run(jmake_trace(JTraceConfig(**kw)))
    got = ServeEngine(tmodel.cfg, tmodel, device="cpu", cache_int8=int8,
                      **ENGINE_KW).run(make_trace(TraceConfig(**kw)))
    assert got.tokens_by_rid() == want.tokens_by_rid()
    assert got.metrics["completed"] == want.metrics["completed"] == 8
    assert got.metrics["decode_steps"] == want.metrics["decode_steps"]
