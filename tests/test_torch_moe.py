"""The MoE family (``models/moe.py``, qwen2-moe-a2.7b) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
``init`` and cross by ``load_jax_params`` (or ``torch_parity.to_module``
for a bare MoE subtree). f32, TF32 off (``torch_parity``). Capacity
regimes: the smoke config's ``capacity_factor`` 8 never drops; 1.25 (the
full config's) drops; ``'ep'`` pads 6 experts to 16 (pad logits -1e30).

* ``route``: ``top_i`` equal (ties to the lower index, as
  ``jax.lax.top_k``), ``top_w``, ``probs`` and the aux loss within rtol
  1e-6; ``dispatch_indices``: ``pos`` and ``keep`` equal; ``moe_apply``:
  rtol 1e-5 / atol 1e-6.
* ``forward`` and ``per_token_loss`` with their gradients on the smoke
  config and a ``first_dense = 1`` variant (a dense segment, then MoE, at
  capacity 1.25): loss and aux rtol 1e-5, gradients rtol 1e-4 / atol 1e-5
  x each leaf's largest (the dense configs' test); logits within 1e-5.
  Remat full / dots, eager and under ``vmap(grad)``, against no remat:
  loss and aux bit-equal, gradients within rtol 1e-6 / atol 1e-7.
* ``decode_step`` against ``forward`` and JAX's ``decode_step``, and
  ``greedy_generate`` (fp and int8 caches) against JAX's: atol 1e-4
  (``test_torch_decode.py``'s), tokens equal.
* The paged ``ServeEngine``'s greedy tokens equal the JAX engine's, fp and
  int8 pools, in both capacity regimes (decode routes every slot, idle
  ones too; prefill the whole bucket).
The trainer, checkpoints, the CLIs and the ``mesh_model > 1`` refusal
are ``test_torch_moe_train.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TraceConfig as JTraceConfig
from repro.serve import make_trace as jmake_trace
from repro.train import serve_step as jserve_step

from repro_torch import configs as tconfigs
from repro_torch.distributed import spmd_engine as tspmd
from repro_torch.models import (TransformerLM, from_jax_tree, get_model,
                                load_jax_params, to_jax_tree)
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from repro_torch.train import serve_step as tserve_step
from torch_moe_common import (ARCH, jax_params, jitted_jax_init,  # noqa: F401
                              one_torch_thread, smoke_jcfg, with_moe)
from torch_parity import port_config, t2n, to_module

ROUTE_RTOL = 1e-6
MOE_RTOL, MOE_ATOL = 1e-5, 1e-6
# logits of unit scale after two layers and a 512-wide head: f32 rounding
# of ~1e-6, so an absolute bound (relative error blows up near 0)
LOGITS_TOL = 1e-5
DECODE_TOL = 1e-4
# (capacity_factor, partition_mode, num_experts) of the module cases
MOE_CASES = {"cf8": (8.0, "tp", 8), "cf1.25": (1.25, "tp", 8),
             "ep": (1.25, "ep", 6)}
ENGINE_KW = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")


def _pair(jcfg, seed=2):
    """(JAX model, JAX params as numpy, the port's model on them)."""
    params = jax_params(jcfg, seed)
    return jget_model(jcfg), params, load_jax_params(
        get_model(port_config(jcfg), device="cpu"), params)


@pytest.fixture(scope="module")
def pairs():
    """The smoke pair at capacity 8 and at 1.25."""
    return {cf: _pair(smoke_jcfg(cf)) for cf in (8.0, 1.25)}


# ---------------------------------------------------------------------------
# Config, registry, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    m = ("capacity_factor", "first_dense", "dense_d_ff", "partition_mode")
    assert [getattr(t.moe, f) for f in m] == [getattr(j.moe, f) for f in m]
    assert tconfigs.list_archs()[0] == ARCH


def test_param_count_and_router_dtype():
    """The full config's count (JAX ``eval_shape``) and ``moe_param_count``
    equal the reference's; the smoke model in bf16 holds the reference's
    leaf count, its router f32 and everything else bf16."""
    full = jconfigs.get_config(ARCH)
    assert jregistry.param_count(full) == 14_315_587_584
    assert jregistry.param_count(full, active_only=True) == 2_688_976_896
    for active in (False, True):
        assert tmoe.moe_param_count(port_config(full), active) == \
            jmoe.moe_param_count(full, active)
    smoke = jconfigs.get_smoke_config(ARCH)
    model = get_model(port_config(dataclasses.replace(smoke,
                                                      dtype="bfloat16")),
                      device="cpu")
    assert model.kinds == ["moe", "moe"]
    named = dict(model.named_parameters())
    assert sum(p.numel() for p in named.values()) == \
        jregistry.param_count(smoke)
    for name, p in named.items():
        want = torch.float32 if name.endswith("router.w") else torch.bfloat16
        assert p.dtype == want, name
    assert named["layers.1.moe.w_down.w"].shape == (8, 44, 64)


# ---------------------------------------------------------------------------
# route, dispatch_indices, moe_apply
# ---------------------------------------------------------------------------


def _moe_case(case):
    cf, mode, e = MOE_CASES[case]
    return with_moe(jconfigs.get_smoke_config(ARCH), capacity_factor=cf,
                     partition_mode=mode, num_experts=e)


@pytest.fixture(scope="module", params=list(MOE_CASES))
def moe_case(request):
    jcfg = _moe_case(request.param)
    params = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(4), jcfg))
    x = np.random.RandomState(5).randn(24, jcfg.d_model).astype(np.float32)
    return request.param, jcfg, params, x


def test_route_matches_jax(moe_case):
    case, jcfg, params, x = moe_case
    m = jcfg.moe
    want = jax.jit(jmoe.route, static_argnums=(2, 3))(
        params["router"], jnp.asarray(x), m.num_experts, m.top_k)
    got = tmoe.route(to_module(params["router"]), torch.from_numpy(x),
                     m.num_experts, m.top_k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=ROUTE_RTOL,
                                   atol=0)
    if case == "ep":                     # the padded experts are never picked
        assert got[1].max() < m.num_experts and got[2].shape[1] == 16


def test_route_ties_pick_the_lower_index():
    """A zero router gives every token uniform probabilities: both
    packages pick experts 0..k-1."""
    jcfg = _moe_case("cf8")
    router = {"w": np.zeros((jcfg.d_model, 8), np.float32)}
    x = np.random.RandomState(0).randn(5, jcfg.d_model).astype(np.float32)
    want = jmoe.route(router, jnp.asarray(x), 8, 2)[1]
    got = tmoe.route(to_module(router), torch.from_numpy(x), 8, 2)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == [0, 1]).all()


def test_dispatch_indices_match_jax(moe_case):
    case, jcfg, params, x = moe_case
    m = jcfg.moe
    top_i = np.asarray(jmoe.route(params["router"], jnp.asarray(x),
                                  m.num_experts, m.top_k)[1])
    e = params["w_gate"]["w"].shape[0]
    cap = tmoe.capacity(m.capacity_factor, x.shape[0], m.top_k, e)
    assert cap == int(max(1, m.capacity_factor * x.shape[0] * m.top_k / e))
    want = jmoe.dispatch_indices(jnp.asarray(top_i), e, cap)
    got = tmoe.dispatch_indices(torch.tensor(top_i).long(), e, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    drops = int((~got[1]).sum())
    assert (drops == 0) == (case == "cf8"), drops


def test_moe_apply_matches_jax(moe_case):
    case, jcfg, params, x = moe_case
    cf = jcfg.moe.capacity_factor
    want = jax.jit(lambda p, xx: jmoe.moe_apply(p, jcfg, xx, cf))(
        params, jnp.asarray(x))
    got = tmoe.moe_apply(to_module(params), port_config(jcfg),
                         torch.from_numpy(x), cf)
    np.testing.assert_allclose(t2n(got[0]), np.asarray(want[0]),
                               rtol=MOE_RTOL, atol=MOE_ATOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]),
                               rtol=MOE_RTOL)


# ---------------------------------------------------------------------------
# The model: forward, loss and gradients, remat, the converter
# ---------------------------------------------------------------------------


def _variant(name):
    if name == "smoke":
        return smoke_jcfg(8.0)
    # a dense segment, then MoE, at the full config's capacity
    return dataclasses.replace(
        with_moe(smoke_jcfg(1.25), first_dense=1, dense_d_ff=96), num_layers=3)


def _batch(vocab, b=2, s=20, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("variant", ["smoke", "first_dense"])
def test_loss_and_grads_match_jax(variant):
    jcfg = _variant(variant)
    jmodel, params, tmodel = _pair(jcfg)
    batch = _batch(jcfg.vocab_size)
    n = float((batch["labels"] >= 0).sum())

    def jloss(p):
        per_tok, aux = jmodel.per_token_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.sum(per_tok) / n + aux, aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    per_tok, aux = tmodel.per_token_loss(batch)
    tl = per_tok.sum() / n + aux
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=MOE_RTOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux),
                               rtol=MOE_RTOL)
    assert float(aux.detach()) > 0
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(
            t2n(got[k]), g, rtol=1e-4,
            atol=1e-5 * (np.abs(g).max() + 1e-6), err_msg=f"{variant} {k}")
    logits = tmodel(torch.from_numpy(batch["tokens"]).long())
    np.testing.assert_allclose(
        t2n(logits), np.asarray(jax.jit(jmodel.forward)(
            params, jnp.asarray(batch["tokens"]))),
        rtol=LOGITS_TOL, atol=LOGITS_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_through_moe_layers_equals_no_remat(remat):
    """Remat 'full' (``common.Remat``, the layer's (x, aux) pair) and
    'dots' through the dense and MoE layers of the ``first_dense`` variant,
    eagerly and under the spmd engine's ``vmap(grad)``: loss, aux and
    gradients equal the run without remat (the reference's remat changes
    no value, so no JAX compile is needed here)."""
    base = port_config(_variant("first_dense"))
    batch = _batch(base.vocab_size)
    runs = {}
    for policy in ("none", remat):
        model = get_model(dataclasses.replace(base, remat=policy),
                          device="cpu",
                          generator=torch.Generator().manual_seed(1))
        per_tok, aux = model.per_token_loss(batch)
        (per_tok.sum() + aux).backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        shards = {k: torch.from_numpy(v).long().reshape(2, 1, -1)
                  for k, v in batch.items()}
        params = {f"model.{k}": v.detach()
                  for k, v in model.named_parameters()}
        vgrads, (_, (_, vaux)) = tspmd.make_batched_grads(model)(params,
                                                                 shards)
        runs[policy] = (per_tok.detach(), aux.detach(), grads, vgrads, vaux)
    want, got = runs["none"], runs[remat]
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[4], want[4])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in want[2]:
        torch.testing.assert_close(got[2][k], want[2][k], rtol=1e-6,
                                   atol=1e-7, msg=k)
        torch.testing.assert_close(got[3][f"model.{k}"],
                                   want[3][f"model.{k}"], rtol=1e-6,
                                   atol=1e-7, msg=k)


def test_converter_roundtrips_segments_and_names_a_bad_leaf():
    """``seg_dense`` + ``seg_moe`` cross to ``layers.0`` (dense) and
    ``layers.1-2`` (MoE) and back to the reference's tree."""
    _, params, tmodel = _pair(_variant("first_dense"))
    named = {k: v.detach() for k, v in tmodel.named_parameters()}
    assert tmodel.kinds == ["dense", "moe", "moe"]
    assert "layers.0.mlp.w_up.w" in named and \
        named["layers.2.moe.w_gate.w"].shape == (8, 64, 44)
    tree = to_jax_tree(named)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for path, leaf in from_jax_tree(params).items():
        np.testing.assert_array_equal(named[path].numpy(), leaf)
    np.testing.assert_array_equal(tree["seg_moe"]["moe"]["router"]["w"],
                                  params["seg_moe"]["moe"]["router"]["w"])
    bad = jax.tree_util.tree_map(lambda t: t, params)
    bad["seg_moe"]["moe"]["router"]["w"] = \
        bad["seg_moe"]["moe"]["router"]["w"][:, :, :4]
    with pytest.raises(ValueError, match=r"layers\.1\.moe\.router\.w"):
        load_jax_params(TransformerLM(tmodel.cfg, device="cpu"), bad)


def test_moe_family_without_experts_runs_dense_segments():
    """A ``'moe'`` config with ``num_experts = 0`` is the dense model."""
    cfg = with_moe(tconfigs.get_smoke_config(ARCH), num_experts=0)
    model = get_model(cfg, device="cpu")
    assert ttransformer.segments(cfg) == [("dense", 2, 0)]
    assert model.kinds == ["dense", "dense"]
    _, aux = model.per_token_loss(_batch(cfg.vocab_size, s=6))
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# Decode over contiguous caches, the toy path
# ---------------------------------------------------------------------------


def test_decode_step_matches_forward_and_jax(pairs):
    jmodel, params, tmodel = pairs[8.0]
    toks = np.random.RandomState(1).randint(
        0, jmodel.cfg.vocab_size, (2, 10)).astype(np.int32)
    full = t2n(tmodel(torch.from_numpy(toks).long()))
    cache = tmodel.init_cache(2, 16)
    jcache = jmodel.init_cache(2, 16)
    assert sorted(cache) == sorted(jcache) == ["lens", "seg_moe"]
    jstep = jax.jit(jmodel.decode_step)
    for i in range(toks.shape[1]):
        logits, cache = tmodel.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                           cache)
        jlogits, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]),
                                jcache)
        np.testing.assert_allclose(t2n(logits), full[:, i], atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        np.testing.assert_allclose(t2n(logits), np.asarray(jlogits),
                                   atol=DECODE_TOL, rtol=DECODE_TOL)


class _JaxToy:
    """The JAX model as the reference's ``greedy_generate`` drives it, its
    decode step jitted once, with fp or int8 caches."""

    def __init__(self, model, cache_dtype=None):
        self.model, self.cache_dtype = model, cache_dtype
        self.decode_step = jax.jit(model.decode_step)

    def init_cache(self, batch, max_len):
        return self.model.init_cache(batch, max_len, dtype=self.cache_dtype)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_greedy_generate_matches_jax(pairs, int8):
    """Capacity 1.25: the toy path's decode drops as the reference's."""
    jmodel, params, tmodel = pairs[1.25]
    prompt = np.random.RandomState(2).randint(
        0, jmodel.cfg.vocab_size, (3, 5)).astype(np.int32)
    want = jserve_step.greedy_generate(
        _JaxToy(jmodel, jnp.int8 if int8 else None), params,
        jnp.asarray(prompt), 6, 12)
    got = tserve_step.greedy_generate(
        tmodel, torch.from_numpy(prompt), 6, 12,
        cache_dtype=torch.int8 if int8 else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["cf8", "cf1.25"])
def test_paged_engine_tokens_match_jax(pairs, cf, int8):
    jmodel, params, tmodel = pairs[cf]
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


