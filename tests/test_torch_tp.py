"""Tensor parallelism over the spmd engine's ``'model'`` axis, against the
JAX engine, on the CPU.

* Host logic, bit-equal to ``repro.distributed.sharding``: ``tp_plan`` and
  ``tp_local_model_cfg`` on every arch's smoke and full config at mesh_model
  1-16 and on the reference test's tiny cases (``tests/test_tp_sharding.py``:
  all groups divisible, partial plans, bias, indivisible ffn/vocab, an
  untied head, a derived head_dim); the split dimension of every leaf, on
  the reference's paths and on the port's names, against
  ``tp_param_specs`` / ``tp_state_specs`` (momentum, rmsprop_momentum,
  adam, sgd and EMA state).
* Over spawned gloo ranks (``tests/torch_tp_ranks.py``, one torch thread
  each), one spawn per mesh shape running every case:
  - at mesh 1 x 2: ``psum_fwd``, ``psum_bwd``, ``sharded_embed`` and
    ``sharded_cross_entropy``, values and gradients, each also under
    ``torch.func.vmap(grad)``, against the unsharded JAX ``common.embed``
    / ``softmax_cross_entropy`` (and the sums they stand for) on the same
    numpy inputs, atol 1e-6; rwkv6's smoke config, which has no TP plan:
    a warning, and the same result as mesh 1 x 1;
  - at mesh 1 x 2 and 2 x 2, on the reference TP test's tiny config
    (``tests/test_spmd_engine.py``'s ``_PARITY_CODE``): full_sync 8,
    backup 6 + 2 and timeout 8 at ``grad_batch`` 1 and 0, and backup with
    global-norm clipping, against the JAX sim Trainer from the JAX init
    (params, EMA and losses within rtol 2e-4 / atol 2e-5, ``sim_time`` and
    ``selected`` equal); the state really split (the local ``wq``, the
    momentum and the EMA of ``embed.embedding`` hold 1/M of the full
    leaf) and the replicated leaves bit-identical across a model group;
    the resume through a chunk, and the TP checkpoint restored in the JAX
    Trainer and in a one-card port run.
* The CLI at ``--mesh-model 2``, ``--mesh-data 2 --mesh-model 2`` and
  ``--grad-batch 0 --mesh-model 2`` against the one-card CLI from one
  step-0 checkpoint.
"""
import dataclasses
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import ema as jema
from repro.core.straggler import Uniform as JUniform
from repro.distributed import sharding as jsharding
from repro.models import common as jcommon
from repro.models import get_model as jget_model
from repro.optim import optimizers as jopt
from repro.optim import schedules as jschedules
from repro.train import loop as jloop

from repro_torch.core import ema as tema
from repro_torch.core.straggler import Uniform
from repro_torch.distributed import mesh
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import train as tcli
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tschedules
from repro_torch.train import loop as tloop
import torch_tp_ranks as ranks
from torch_parity import port_config

RTOL, ATOL = 2e-4, 2e-5
STEPS = 8
STRATEGIES = (("full_sync", 8, 0), ("backup", 6, 2), ("timeout", 8, 0))
GRAD_BATCHES = (1, 0)
CLIP = 0.05
RANK_TIMEOUT_S = 120.0
FG_SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the spawned ranks: under the parallel
    tier-1 run torch's default of a thread per core multiplies the time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Host logic: plans, local configs and split dimensions against the JAX
# package
# ---------------------------------------------------------------------------


def _tiny(**kw):
    """The reference tests' tiny qwen3 (``test_tp_sharding._tiny``)."""
    base = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64, vocab_pad_multiple=16)
    base.update(kw)
    return jbase.replace(jconfigs.get_smoke_config("qwen3-0.6b"), **base)


TINY_CASES = {
    "divisible": (dict(), 2),
    "kv_heads_indivisible": (dict(num_heads=4, num_kv_heads=1), 2),
    "odd_heads": (dict(num_heads=3, num_kv_heads=3), 2),
    "bias": (dict(use_bias=True), 2),
    "ffn_indivisible": (dict(d_ff=66), 4),
    "vocab_indivisible": (dict(vocab_size=60, vocab_pad_multiple=4), 16),
    "untied_head": (dict(tie_embeddings=False), 2),
    "derived_head_dim": (dict(head_dim=0), 2),
}


def _same_plan(tplan, jplan):
    assert (tplan.size, tplan.attn, tplan.ffn, tplan.vocab, tplan.any) == \
        (jplan.size, jplan.attn, jplan.ffn, jplan.vocab, jplan.any)


def _check_plan_and_local_cfg(jcfg, m):
    jplan = jsharding.tp_plan(jcfg, m)
    tcfg = None if jcfg is None else port_config(jcfg)
    tplan = tsharding.tp_plan(tcfg, m)
    _same_plan(tplan, jplan)
    if jcfg is not None:
        assert tsharding.tp_local_model_cfg(tcfg, tplan) == \
            port_config(jsharding.tp_local_model_cfg(jcfg, jplan))
    return tplan


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_plan_and_local_cfg_match_jax_on_every_arch(arch):
    for jcfg in (jconfigs.get_smoke_config(arch), jconfigs.get_config(arch)):
        for m in (1, 2, 4, 8, 16):
            _check_plan_and_local_cfg(jcfg, m)


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_plan_and_local_cfg_match_jax(case):
    kw, m = TINY_CASES[case]
    plan = _check_plan_and_local_cfg(_tiny(**kw), m)
    if case == "divisible":
        assert plan.attn and plan.ffn and plan.vocab
    _check_plan_and_local_cfg(None, 4)


def _dim(spec) -> "int | None":
    """The reference's PartitionSpec as the port's split dimension."""
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_dims(spec_tree):
    """{reference path: split dimension} of a tree of PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path(p): _dim(s) for p, s in leaves}


def _port_name_dims(jax_dims):
    """The reference's per-path split dimensions on the port's names: a
    stacked ``seg_dense/<path>`` leaf unstacks into ``layers.<i>.<path>``
    one dimension lower."""
    out = {}
    for path, dim in jax_dims.items():
        head, _, rest = path.partition("/")
        if head == "seg_dense":
            out[f"layers.*.{rest.replace('/', '.')}"] = \
                None if dim is None else dim - 1
        else:
            out[path.replace("/", ".")] = dim
    return out


def _wild(name: str) -> str:
    return re.sub(r"^layers\.\d+\.", "layers.*.", name)


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_param_specs_match_jax(case):
    kw, m = TINY_CASES[case]
    jcfg = _tiny(**kw)
    jplan = jsharding.tp_plan(jcfg, m)
    tplan = tsharding.tp_plan(port_config(jcfg), m)
    shapes = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    want = _jax_dims(jsharding.tp_param_specs(jplan, shapes))
    # the port's rules on the reference's own paths and stacked shapes
    flat = {_path(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert tsharding.tp_param_specs(tplan, flat) == want
    # ... and on the port's parameter names and unstacked shapes
    model = get_model(port_config(jcfg), device="cpu")
    got = tsharding.tp_param_specs(tplan, dict(model.named_parameters()))
    assert {_wild(k): v for k, v in got.items()} == _port_name_dims(want)
    if case == "divisible":
        assert got["layers.0.attn.wq.w"] == 1 and got["embed.embedding"] == 0
    if case == "untied_head":
        assert got["lm_head.w"] == 1


@pytest.mark.parametrize("path,shape,plan", [
    ("seg_dense/attn/wq/w", (1, 32, 30), dict(size=4, attn=True)),
    ("whatever/scalar", (), dict(size=4, attn=True)),
    ("embed/embedding", (60, 32), dict(size=16, vocab=True)),
    ("x_head/w", (32, 64), dict(size=2, vocab=True)),
    ("final_norm/scale", (32,), dict(size=2, attn=True, ffn=True,
                                     vocab=True)),
])
def test_param_spec_guards_match_jax(path, shape, plan):
    want = _dim(jsharding.tp_param_spec(path, shape,
                                        jsharding.TPPlan(**plan)))
    assert tsharding.tp_param_spec(path, shape,
                                   tsharding.TPPlan(**plan)) == want


@pytest.mark.parametrize("name", ["momentum", "rmsprop_momentum", "adam",
                                  "sgd", "ema"])
def test_state_specs_match_jax(name):
    jcfg = _tiny()
    jplan = jsharding.tp_plan(jcfg, 2)
    tplan = tsharding.tp_plan(port_config(jcfg), 2)
    params_t = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    model = get_model(port_config(jcfg), device="cpu")
    named = dict(model.named_parameters())
    if name == "ema":
        jstate = jax.eval_shape(jema.init, params_t)
        tstate = tema.init(named.items())
    else:
        jstate = jax.eval_shape(
            getattr(jopt, name)(jschedules.constant(0.1)).init, params_t)
        tstate = getattr(topt, name)(tschedules.constant(0.1)).init(named)
    want = _jax_dims(jsharding.tp_state_specs(jplan, jstate))
    # the reference's flattened state paths (optimizer prefix and all)
    flat = {_path(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert tsharding.tp_state_specs(tplan, flat) == want
    # the port's state dicts, keyed like the parameters
    got = tsharding.tp_state_specs(tplan, tstate)
    if name == "ema":
        assert {_wild(k): v for k, v in got.items()} == \
            _port_name_dims(want)
        return
    assert sorted(got) == sorted(jstate)
    for key, sub in got.items():
        sub_want = {p.partition("/")[2]: d for p, d in want.items()
                    if p.partition("/")[0] == key}
        assert {_wild(k): v for k, v in sub.items()} == \
            _port_name_dims(sub_want)


# ---------------------------------------------------------------------------
# Spawned meshes
# ---------------------------------------------------------------------------


def _tiny_model_cfg(arch="qwen3-0.6b"):
    cfg = jconfigs.get_smoke_config(arch)
    if arch == "qwen3-0.6b":
        cfg = _tiny()
    return jbase.replace(cfg, remat="full")


def _jcfg(strategy, workers, backups, directory, *, backend="spmd",
          mesh=(1, 1), grad_batch=0, chunk=3, every=0, clip=0.0,
          arch="qwen3-0.6b"):
    """The reference TP test's config (``_PARITY_CODE``'s ``cfg``)."""
    return jbase.TrainConfig(
        model=_tiny_model_cfg(arch),
        shape=jbase.ShapeConfig("t", 16, 16, "train"),
        aggregation=jbase.AggregationConfig(
            strategy=strategy, num_workers=workers, backup_workers=backups,
            deadline_s=0.5),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.99,
                                        clip_global_norm=clip),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, mesh_data=mesh[0],
                                        mesh_model=mesh[1],
                                        grad_batch=grad_batch),
        seed=0, total_steps=STEPS, log_every=1, chunk_size=chunk)


def _tcfg(jcfg):
    cfg = port_config(jcfg)
    # the JAX config's use_kernel=True is the CUDA kernel here, which the
    # CPU refuses; None takes the plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return {arch: _np_tree(jget_model(_tiny_model_cfg(arch)).init(
        jax.random.PRNGKey(0))) for arch in ("qwen3-0.6b", "rwkv6-1.6b")}


def _jax_run(jcfg, steps=STEPS):
    tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
    tr.init_state()
    return tr.run(steps)


@pytest.fixture(scope="module")
def jax_sim(tmp_path_factory):
    """The JAX sim Trainer's run of each strategy, and of backup with
    clipping: what every TP run here is held to."""
    root = tmp_path_factory.mktemp("jax_sim")
    out = {s: _jax_run(_jcfg(s, w, b, root / s, backend="sim"))
           for s, w, b in STRATEGIES}
    out["backup_clip"] = _jax_run(_jcfg("backup", 6, 2, root / "clip",
                                        backend="sim", clip=CLIP))
    return out


MESHES = {"mesh1x2": (1, 2), "mesh2x2": (2, 2)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def tp_run(request, tmp_path_factory, jax_params):
    """One spawn of the mesh's gloo ranks (``torch_tp_ranks.tp_rank``)
    running every case; every rank's results."""
    shape = MESHES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    runs = {f"{s}_gb{gb}": (_tcfg(_jcfg(s, w, b, root / f"{s}{gb}",
                                        mesh=shape, grad_batch=gb)), STEPS)
            for s, w, b in STRATEGIES for gb in GRAD_BATCHES}
    runs["backup_clip"] = (_tcfg(_jcfg("backup", 6, 2, root / "clip",
                                       mesh=shape, clip=CLIP)), STEPS)
    resume = _tcfg(_jcfg("backup", 6, 2, root / "resume", mesh=shape,
                         chunk=2, every=3))
    one_by_two = shape == (1, 2)
    rwkv = (_tcfg(_jcfg("backup", 6, 2, root / "rwkv", mesh=shape,
                        arch="rwkv6-1.6b")), 4) if one_by_two else None
    mesh.spawn(ranks.tp_rank, shape[0], "cpu",
               args=(str(root), jax_params, runs, resume, 3, STEPS,
                     FG_SEED if one_by_two else None, rwkv),
               mesh_model=shape[1], threads=1, timeout_s=RANK_TIMEOUT_S)
    return dict(shape=shape, root=root,
                ranks=[torch.load(root / f"rank{r}.pt", weights_only=False)
                       for r in range(shape[0] * shape[1])])


def _np(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close_state(got, want_params, want_ema):
    for part, want in (("params", want_params), ("ema", want_ema)):
        have = got[part]
        want = from_jax_tree(want)
        assert sorted(have) == sorted(want)
        for k, v in have.items():
            np.testing.assert_allclose(_np(v), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part} {k}")


def _close_run(got, want):
    assert got["sim_time"] == want.sim_time
    assert [m["selected"] for m in got["metrics"]] == \
        [m["selected"] for m in want.metrics]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want.metrics],
                               rtol=RTOL, atol=ATOL)
    _close_state(got, want.params, want.ema)


# -- the f/g functions --------------------------------------------------------


def _jax_embed(table, ids):
    return jcommon.embed({"embedding": table}, ids)


def _jax_ce(logits, labels):
    return jcommon.softmax_cross_entropy(logits, labels, ranks.VALID_VOCAB)


@pytest.mark.parametrize("tp_run", ["mesh1x2"], indirect=True)
@pytest.mark.parametrize("fn", ["psum_fwd", "psum_bwd", "embed", "ce"])
def test_f_g_functions_match_jax(tp_run, fn):
    a = ranks.fg_inputs(FG_SEED)
    size = tp_run["shape"][1]
    v = a["table"].shape[0] // size
    for r, rk in enumerate(tp_run["ranks"]):
        got = rk["fg"]
        idx = rk["model_index"]
        rows = slice(idx * v, (idx + 1) * v)
        total = sum(range(1, size + 1))          # sum of (index + 1)
        if fn == "psum_fwd":
            want = (a["x"] * total, a["cot"], a["cots"] * (idx + 1),
                    a["xs"] * total)
        elif fn == "psum_bwd":
            want = (a["x"], a["cot"] * total, a["cots"] * total, a["xs"])
        else:
            f, x, xs, c, cs, extra, extras, cut = {
                "embed": (_jax_embed, a["table"], a["tables"], a["cot"],
                          a["cots"], a["ids"], a["idss"],
                          lambda g: g[..., rows, :]),
                "ce": (_jax_ce, a["logits"], a["logitss"], a["ce_cot"],
                       a["ce_cots"], a["labels"], a["labelss"],
                       lambda g: g[..., rows])}[fn]
            y, pull = jax.vjp(lambda t: f(t, extra), x)

            def one(t, ct, e):
                out, back = jax.vjp(lambda u: f(u, e), t)
                return back(ct)[0], out

            gs, ys = jax.vmap(one)(xs, cs, extras)
            want = (y, cut(pull(c)[0]), cut(gs), ys)
        have = (*got[fn], *got[f"{fn}_vmap"])
        for i, (h, w) in enumerate(zip(have, want)):
            np.testing.assert_allclose(_np(h), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=f"rank {r} {i}")


# -- the trainer --------------------------------------------------------------


@pytest.mark.parametrize("grad_batch", GRAD_BATCHES)
@pytest.mark.parametrize("strategy", [s for s, _, _ in STRATEGIES])
def test_tp_trainer_matches_jax(tp_run, jax_sim, strategy, grad_batch):
    for rk in tp_run["ranks"]:
        _close_run(rk[f"{strategy}_gb{grad_batch}"], jax_sim[strategy])


def test_tp_clipping_matches_jax(tp_run, jax_sim):
    for rk in tp_run["ranks"]:
        _close_run(rk["backup_clip"], jax_sim["backup_clip"])


def test_tp_state_is_split_and_replicas_agree(tp_run):
    d, m = tp_run["shape"]
    by_model_group = {}
    for rk in tp_run["ranks"]:
        by_model_group.setdefault(rk["data_index"], []).append(rk)
        got = rk["backup_gb0"]
        full = {k: tuple(v.shape) for k, v in got["params"].items()}
        wq, emb = "layers.0.attn.wq.w", "embed.embedding"
        assert got["local_shapes"][wq] == (full[wq][0], full[wq][1] // m)
        assert got["local_shapes"][emb] == (full[emb][0] // m, full[emb][1])
        assert got["opt_shapes"]["m"][emb] == (full[emb][0] // m,
                                               full[emb][1])
        assert got["ema_shapes"][emb] == (full[emb][0] // m, full[emb][1])
        assert got["dims"][wq] == 1 and got["dims"][emb] == 0
        assert got["replicated"] and all(
            got["dims"][k] is None for k in got["replicated"])
    assert sorted(by_model_group) == list(range(d))
    first = tp_run["ranks"][0]["backup_gb0"]
    for group in by_model_group.values():
        assert len(group) == m
        for rk in group:
            got = rk["backup_gb0"]
            for k, v in group[0]["backup_gb0"]["replicated"].items():
                assert torch.equal(got["replicated"][k], v), k
            # every rank's gathered parameters are the same tensors
            for k, v in first["params"].items():
                assert torch.equal(got["params"][k], v), k
            assert got["metrics"] == first["metrics"]


def test_tp_resume_through_chunk(tp_run, jax_sim):
    for rk in tp_run["ranks"]:
        assert rk["resume_step"] == 3
        _close_state(rk["resume"], jax_sim["backup"].params,
                     jax_sim["backup"].ema)
        assert rk["resume"]["sim_time"] == jax_sim["backup"].sim_time


def test_tp_checkpoint_restores_in_jax_and_on_one_card(tp_run, jax_sim,
                                                       tmp_path):
    """The checkpoint rank 0 wrote at step 3 (the resumed run saved step 8
    after it: restore 3 explicitly), continued to step 8 by the JAX
    Trainer and by the port on one card, lands on the JAX sim run."""
    want = jax_sim["backup"]
    d = tmp_path / "ck"
    shutil.copytree(tp_run["root"] / "resume", d)
    jcfg = _jcfg("backup", 6, 2, d, chunk=2)
    tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
    tr.restore_checkpoint(3)
    assert tr.step == 3
    res = tr.run(STEPS - 3)
    assert res.sim_time == want.sim_time
    _close_state({"params": from_jax_tree(res.params),
                  "ema": from_jax_tree(res.ema)}, want.params, want.ema)
    one = tloop.Trainer(_tcfg(jcfg), latency=Uniform(1.0, 2.0), device="cpu")
    one.reset_optimizer_state()
    one.restore_checkpoint(3)
    assert one.step == 3
    res = one.run(STEPS - 3)
    assert res.sim_time == want.sim_time
    _close_state({"params": res.params, "ema": res.ema}, want.params,
                 want.ema)


@pytest.mark.parametrize("tp_run", ["mesh1x2"], indirect=True)
def test_tp_rwkv_without_plan_warns_and_equals_one_card(tp_run, jax_params,
                                                        tmp_path):
    cfg = _tcfg(_jcfg("backup", 6, 2, tmp_path / "one",
                      arch="rwkv6-1.6b"))
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    load_jax_params(tr.model, jax_params["rwkv6-1.6b"])
    tr.reset_optimizer_state()
    want = tr.run(4)
    for rk in tp_run["ranks"]:
        assert any("no parameter group is shardable" in w
                   for w in rk["rwkv_warnings"])
        got = rk["rwkv"]
        assert not got["dims"]
        assert got["metrics"] == want.metrics
        for k, v in want.params.items():
            assert torch.equal(got["params"][k], v.detach()), k


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")
_CLI = ["--smoke", "--steps", "4", "--seq", "8", "--batch-per-worker", "1",
        "--strategy", "backup", "--workers", "3", "--backups", "1",
        "--optimizer", "momentum", "--lr", "0.05", "--ckpt-every", "0",
        "--execution", "spmd", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--mesh-model", "2"],
    ["--mesh-data", "2", "--mesh-model", "2"],
    ["--grad-batch", "0", "--mesh-model", "2"],
], ids=["model2", "data2_model2", "grad_batch0_model2"])
def test_cli_mesh_model_matches_one_card(tmp_path, capfd, extra):
    """The CLI over a 'model' axis (spawned gloo ranks; rank 0 prints)
    prints the one-card CLI's lines, both resuming one step-0 checkpoint
    (the smoke qwen3's heads, width and vocabulary all divide by 2)."""
    start = tmp_path / "start"
    tcli.main(_CLI + ["--steps", "0", "--ckpt", str(start)])
    capfd.readouterr()
    lines = {}
    for tag, flags in (("one", []), ("mesh", extra)):
        shutil.copytree(start, tmp_path / tag)
        tcli.main(_CLI + flags + ["--resume", "--ckpt", str(tmp_path / tag)])
        out = capfd.readouterr().out
        assert "resumed at step 0" in out
        lines[tag] = _LINE.findall(out)
    assert len(lines["one"]) == 1 and len(lines["mesh"]) == 1
    for got, want in zip(lines["mesh"], lines["one"]):
        assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
        assert abs(float(got[1]) - float(want[1])) <= 2e-4
