"""The spmd engine's batched worker gradients and its ``'data'`` axis over
ranks, against the JAX engine, on the CPU.

The reference's own parity set (``tests/test_spmd_engine.py``: the
single-device mesh against sim, the ``grad_batch`` paths, the mesh parity
matrix and its resume through a chunk) at its tiny qwen3 config (1 layer,
d_model 32, vocab 64; momentum, EMA 0.99, ``Uniform(1, 2)`` stragglers,
chunks of 3), the port starting from the JAX init (``load_jax_params``):

* ``grad_batch`` 0, 1 and 2 for full_sync 8, backup 6 + 2 and timeout 8
  (remat "full") against the JAX sim Trainer, and for backup against the
  JAX spmd Trainer at mesh 1 x 1 with the same ``grad_batch``; rwkv6's
  smoke config at ``grad_batch`` 0 and 2 against the JAX sim Trainer:
  params, EMA and losses within rtol 2e-4 / atol 2e-5, ``sim_time`` and
  ``selected`` exact.
* ``common.Remat`` under ``vmap(grad)`` (the engine's batched gradients,
  remat "full", "dots" and the chunked cross entropy) against the
  per-worker ``torch.autograd.grad`` loop without remat; the wkv6 kernels'
  ``vmap`` rule with the launchers replaced by plain functions of the same
  signature: one launch for all workers, B folded, ``du`` per worker.
* ``mesh_data`` 2 and 4 over spawned gloo ranks (one torch thread each):
  ``reduce_then_psum`` over the ranks (buckets 0 and 5000, a tail) against
  the JAX ``ref_masked_mean`` of the whole stack within 1e-6, with one
  all-reduce per bucket and the tail in the last; the three strategies
  with every rank's parameters bit-identical and rank 0 against the JAX
  sim Trainer; the resume through a chunk (checkpoint at step 3 with
  chunk 2, restore, continue to step 8); the mesh checkpoint restored and
  continued in the JAX Trainer.
* The CLI: ``--execution spmd`` at ``--grad-batch 0`` and at
  ``--mesh-data 2 --device cpu`` print the JAX CLI's lines (from one
  shared step-0 checkpoint) within 2e-4.
"""
import dataclasses
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core.straggler import Uniform as JUniform
from repro.distributed import spmd_engine as jspmd
from repro.kernels import bucketed_reduce as jbucketed
from repro.launch import train as jcli
from repro.models import get_model as jget_model
from repro.train import loop as jloop

from repro_torch.core.straggler import Uniform
from repro_torch.distributed import mesh
from repro_torch.distributed import spmd_engine as tspmd
from repro_torch.kernels import rwkv6_scan
from repro_torch.launch import train as tcli
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import transformer as ttransformer
from repro_torch.train import loop as tloop
import torch_mesh_ranks as ranks
from torch_parity import port_config

RTOL, ATOL = 2e-4, 2e-5
STEPS = 8
STRATEGIES = (("full_sync", 8, 0), ("backup", 6, 2), ("timeout", 8, 0))
RANK_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the spawned ranks take one each too): under the
    parallel tier-1 run, torch's default of one thread per core in every
    worker multiplies the time several-fold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny_model_cfg(arch="qwen3-0.6b"):
    cfg = jconfigs.get_smoke_config(arch)
    if arch == "qwen3-0.6b":
        cfg = jbase.replace(cfg, num_layers=1, d_model=32, num_heads=2,
                            num_kv_heads=2, head_dim=16, d_ff=64,
                            vocab_size=64, vocab_pad_multiple=16)
    return jbase.replace(cfg, remat="full")


def _jcfg(backend, strategy, workers, backups, directory, *, grad_batch=0,
          mesh_data=1, chunk=3, every=0, arch="qwen3-0.6b"):
    """The reference test's config (``_PARITY_CODE``'s ``cfg``)."""
    return jbase.TrainConfig(
        model=_tiny_model_cfg(arch),
        shape=jbase.ShapeConfig("t", 16, 16, "train"),
        aggregation=jbase.AggregationConfig(
            strategy=strategy, num_workers=workers, backup_workers=backups,
            deadline_s=0.5),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, mesh_data=mesh_data,
                                        grad_batch=grad_batch),
        seed=0, total_steps=STEPS, log_every=1, chunk_size=chunk)


def _tcfg(jcfg):
    cfg = port_config(jcfg)
    # the JAX config's use_kernel=True means the CUDA kernel here, which the
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


def _port_run(cfg, params, steps=STEPS):
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    load_jax_params(tr.model, params)
    tr.reset_optimizer_state()
    return tr.run(steps)


@pytest.fixture(scope="module")
def jax_sim(tmp_path_factory):
    """The JAX sim Trainer's run of each strategy (the reference every
    port run here is held to)."""
    root = tmp_path_factory.mktemp("jax_sim")
    return {s: _jax_run(_jcfg("sim", s, w, b, root / s))
            for s, w, b in STRATEGIES}


def _np(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close_state(got, want_params, want_ema):
    for part, want in (("params", want_params), ("ema", want_ema)):
        have = got[part] if isinstance(got, dict) else getattr(got, part)
        want = from_jax_tree(want)
        assert sorted(have) == sorted(want)
        for k, v in have.items():
            np.testing.assert_allclose(_np(v), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part} {k}")


def _close_run(got, want):
    """Port run (a TrainResult or a rank's dict) against a JAX run."""
    metrics = got["metrics"] if isinstance(got, dict) else got.metrics
    sim_time = got["sim_time"] if isinstance(got, dict) else got.sim_time
    assert sim_time == want.sim_time
    assert [m["selected"] for m in metrics] == \
        [m["selected"] for m in want.metrics]
    assert [m["sim_time"] for m in metrics] == \
        [m["sim_time"] for m in want.metrics]
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               [m["loss"] for m in want.metrics],
                               rtol=RTOL, atol=ATOL)
    _close_state(got, want.params, want.ema)


# ---------------------------------------------------------------------------
# Batched worker gradients at mesh 1 x 1
# ---------------------------------------------------------------------------


def test_validate_grad_batch_matches_the_reference():
    for gb, w in ((0, 4), (1, 4), (2, 4), (6, 6), (0, 1)):
        assert tspmd.validate_grad_batch(gb, w) == \
            jspmd.validate_grad_batch(gb, w)
    for gb, w in ((4, 6), (8, 4), (3, 8)):
        with pytest.raises(ValueError) as want:
            jspmd.validate_grad_batch(gb, w)
        with pytest.raises(ValueError) as got:
            tspmd.validate_grad_batch(gb, w)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="non-negative"):
        tspmd.validate_grad_batch(-1, 4)


@pytest.mark.parametrize("grad_batch", [0, 1, 2])
@pytest.mark.parametrize("strategy,workers,backups", STRATEGIES,
                         ids=[s for s, _, _ in STRATEGIES])
def test_batched_grads_match_jax(tmp_path, jax_params, jax_sim, strategy,
                                 workers, backups, grad_batch):
    jcfg = _jcfg("spmd", strategy, workers, backups, tmp_path / "t",
                 grad_batch=grad_batch)
    got = _port_run(_tcfg(jcfg), jax_params["qwen3-0.6b"])
    _close_run(got, jax_sim[strategy])
    if strategy == "backup":
        _close_run(got, _jax_run(jbase.replace(
            jcfg, checkpoint=jbase.CheckpointConfig(
                directory=str(tmp_path / "j"), every_steps=0))))


def test_batched_grads_rwkv_match_jax(tmp_path, jax_params):
    want = _jax_run(_jcfg("sim", "backup", 6, 2, tmp_path / "j",
                          arch="rwkv6-1.6b"), steps=4)
    for gb in (0, 2):
        got = _port_run(_tcfg(_jcfg("spmd", "backup", 6, 2, tmp_path / "t",
                                    grad_batch=gb, arch="rwkv6-1.6b")),
                        jax_params["rwkv6-1.6b"], steps=4)
        _close_run(got, want)


@pytest.mark.parametrize("remat,chunked", [("full", False), ("dots", False),
                                           ("full", True)])
def test_remat_under_vmap_matches_the_worker_loop(monkeypatch, remat,
                                                  chunked):
    """``make_batched_grads`` (vmap of grad over the worker loss, through
    ``common.Remat``) against each worker's ``torch.autograd.grad`` with
    remat "none"."""
    if chunked:       # the tiny vocab x seq is far below the real switch
        monkeypatch.setattr(ttransformer, "CHUNKED_CE_THRESHOLD", 0)
    base = port_config(_tiny_model_cfg())
    gen = torch.Generator().manual_seed(3)
    model = get_model(dataclasses.replace(base, remat=remat), device="cpu",
                      generator=gen)
    plain = get_model(dataclasses.replace(base, remat="none"), device="cpu")
    plain.load_state_dict(model.state_dict())
    rng = np.random.RandomState(4)
    batch = {k: torch.from_numpy(rng.randint(0, 64, (4, 2, 16)))
             for k in ("tokens", "labels")}
    batch["labels"][1, 0, :5] = -1
    params = dict(model.named_parameters())
    grads, (total, (mean_loss, _)) = tspmd.make_batched_grads(model)(
        {f"model.{k}": v.detach() for k, v in params.items()}, batch)
    loss = tspmd.make_worker_loss(plain)
    for w in range(4):
        t, m, _ = loss({k: v[w] for k, v in batch.items()})
        want = torch.autograd.grad(t, list(plain.parameters()))
        torch.testing.assert_close(mean_loss[w], m.detach(), rtol=1e-6,
                                   atol=1e-6)
        for (name, _), g in zip(plain.named_parameters(), want):
            torch.testing.assert_close(grads[f"model.{name}"][w], g,
                                       rtol=1e-5, atol=1e-6, msg=name)


def _plain_kernels(monkeypatch, log):
    """The wkv6 launchers as plain functions of the same signature (the
    forward through ``wkv6_plain``, the backward through its autograd, each
    row's ``du`` in chunk 0 of ``du_part``), logging the shapes they get."""
    def forward(r, k, v, w, u, *, save_states=True):
        log.append(("fwd", r.shape[0], save_states))
        out, final = rwkv6_scan.wkv6_plain(r, k, v, w, u)
        b, s, h, d = r.shape
        states = torch.zeros((b, h, -(-s // rwkv6_scan.CHUNK), d, d))
        return out, final, states if save_states else None

    def backward(r, k, v, w, u, states, dout, dfinal=None):
        log.append(("bwd", r.shape[0]))
        leaves = [t.detach().float().requires_grad_() for t in (r, k, v, w)]
        rows = []
        with torch.enable_grad():
            for b in range(r.shape[0]):
                ub = u.detach().float().requires_grad_()
                out, final = rwkv6_scan.wkv6_plain(
                    *(t[b:b + 1] for t in leaves), ub)
                loss = (out * dout[b:b + 1]).sum()
                if dfinal is not None:
                    loss = loss + (final * dfinal[b:b + 1]).sum()
                loss.backward()
                rows.append(ub.grad)
        b, s, h, d = r.shape
        du_part = torch.zeros((b, h, -(-s // rwkv6_scan.CHUNK), d))
        du_part[:, :, 0] = torch.stack(rows)
        return (*(t.grad for t in leaves), du_part)

    monkeypatch.setattr(rwkv6_scan, "wkv6_forward", forward)
    monkeypatch.setattr(rwkv6_scan, "wkv6_backward_parts", backward)
    monkeypatch.setattr(        # the model's wkv through WKV6, on the CPU
        trwkv6, "wkv_chunked",
        lambda r, k, v, w, u, state=None, *a, **kw: rwkv6_scan.wkv6(
            r, k, v, w, u))


def test_wkv6_vmap_rule_folds_workers(monkeypatch):
    log = []
    _plain_kernels(monkeypatch, log)
    cfg = port_config(jbase.replace(jconfigs.get_smoke_config("rwkv6-1.6b"),
                                    remat="full"))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 2, 24)))
             for k in ("tokens", "labels")}
    params = dict(model.named_parameters())
    loss = tspmd.make_worker_loss(model)
    want = []
    for w in range(4):
        t, _, _ = loss({k: v[w] for k, v in batch.items()})
        want.append(torch.autograd.grad(t, list(params.values())))
    layers = cfg.num_layers
    # one worker at a time: per worker and layer, a first pass without
    # states, the recompute with them, one backward
    assert log == ([("fwd", 2, False)] * layers
                   + [("fwd", 2, True), ("bwd", 2)] * layers) * 4
    del log[:]
    grads, _ = tspmd.make_batched_grads(model)(
        {f"model.{k}": v.detach() for k, v in params.items()}, batch)
    # vmapped: the same launches once for the four workers, B = 4 x 2
    assert log == ([("fwd", 8, False)] * layers
                   + [("fwd", 8, True), ("bwd", 8)] * layers)
    for i, name in enumerate(params):
        got = grads[f"model.{name}"]
        ref = torch.stack([g[i] for g in want])
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=name)
    u = [n for n in params if n.endswith("att.u")]
    assert u and all(not torch.equal(grads[f"model.{n}"][0],
                                     grads[f"model.{n}"][1]) for n in u)


# ---------------------------------------------------------------------------
# The 'data' axis over spawned gloo ranks
# ---------------------------------------------------------------------------

REDUCE_CASES = [(seed, 8, 12345, bucket, 6)
                for seed, bucket in ((0, 0), (1, 5000), (2, 12345))]


@pytest.fixture(scope="module", params=[2, 4], ids=["mesh2", "mesh4"])
def mesh_run(request, tmp_path_factory, jax_params):
    """One spawn of ``mesh_data`` gloo ranks (``torch_mesh_ranks.
    mesh_rank``): the reduce cases, the three strategies at the default
    ``grad_batch`` and the resume through a chunk; every rank's results."""
    k = request.param
    root = tmp_path_factory.mktemp(f"mesh{k}")
    runs = {s: (_tcfg(_jcfg("spmd", s, w, b, root / s, mesh_data=k)), STEPS)
            for s, w, b in STRATEGIES}
    resume = _tcfg(_jcfg("spmd", "backup", 6, 2, root / "resume",
                         mesh_data=k, chunk=2, every=3))
    mesh.spawn(ranks.mesh_rank, k, "cpu",
               args=(str(root), jax_params["qwen3-0.6b"], REDUCE_CASES, runs,
                     resume, 3, STEPS), threads=1, timeout_s=RANK_TIMEOUT_S)
    return dict(k=k, root=root, ranks=[torch.load(root / f"rank{r}.pt")
                                       for r in range(k)])


def test_reduce_then_psum_over_ranks(mesh_run):
    k = mesh_run["k"]
    for case, got in zip(REDUCE_CASES, mesh_run["ranks"][0]["reduce"]):
        seed, w, p, bucket, n = case
        grads, mask, tail = ranks.stack_case(seed, w, p)
        want = np.asarray(jbucketed.ref_masked_mean(grads, mask, n))
        np.testing.assert_allclose(got["red"].numpy(), want, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["tail"].numpy(),
                                   tail * k * (k + 1) / 2, rtol=1e-6)
        # one all-reduce per bucket, the tail riding the last
        sizes = [hi - lo for lo, hi in jbucketed.bucket_bounds(p, bucket)]
        sizes[-1] += 2
        assert got["sizes"] == sizes
        for other in mesh_run["ranks"][1:]:
            match = other["reduce"][REDUCE_CASES.index(case)]
            assert torch.equal(match["red"], got["red"])


@pytest.mark.parametrize("strategy", [s for s, _, _ in STRATEGIES])
def test_mesh_ranks_bit_identical_and_match_jax(mesh_run, jax_sim,
                                                strategy):
    first = mesh_run["ranks"][0][strategy]
    for other in mesh_run["ranks"][1:]:
        for part in ("params", "ema"):
            for name, v in first[part].items():
                assert torch.equal(other[strategy][part][name], v), name
        assert other[strategy]["metrics"] == first["metrics"]
    _close_run(first, jax_sim[strategy])


def test_mesh_resume_through_chunk(mesh_run, jax_sim):
    for r in mesh_run["ranks"]:
        assert r["resume_step"] == 3
        _close_state(r["resume"], jax_sim["backup"].params,
                     jax_sim["backup"].ema)
        assert r["resume"]["sim_time"] == jax_sim["backup"].sim_time


@pytest.mark.parametrize("mesh_run", [2], indirect=True, ids=["mesh2"])
def test_mesh_checkpoint_restores_in_jax(mesh_run, jax_sim, tmp_path):
    """The checkpoint rank 0 wrote at step 3 (after the resumed run's
    save at step 8: restore step 3 explicitly) continues in the JAX
    Trainer to the JAX sim run's state."""
    d = tmp_path / "ck"
    shutil.copytree(mesh_run["root"] / "resume", d)
    jcfg = _jcfg("spmd", "backup", 6, 2, d, chunk=2, every=0)
    tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
    tr.restore_checkpoint(3)
    assert tr.step == 3
    res = tr.run(STEPS - 3)
    want = jax_sim["backup"]
    assert res.sim_time == want.sim_time
    _close_state({"params": from_jax_tree(res.params),
                  "ema": from_jax_tree(res.ema)}, want.params, want.ema)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")


def test_cli_grad_batch_and_mesh_data_match_jax_cli(tmp_path, capfd):
    """``--execution spmd`` with the reference's default ``--grad-batch``
    0, the port at ``--grad-batch 0`` and at ``--mesh-data 2`` (two
    spawned gloo ranks; rank 0 prints), all resuming one step-0 checkpoint
    of the JAX init, so that every run starts from the same state."""
    argv = ["--smoke", "--steps", "6", "--seq", "8", "--batch-per-worker",
            "1", "--strategy", "backup", "--workers", "3", "--backups", "1",
            "--optimizer", "momentum", "--lr", "0.05", "--ckpt-every", "0",
            "--execution", "spmd", "--resume"]
    start = tmp_path / "start"            # the JAX init, at step 0
    jcli.main([a for a in argv if a != "--resume"]
              + ["--steps", "0", "--ckpt", str(start)])
    capfd.readouterr()
    lines = {}
    for tag, main, extra in (
            ("jax", jcli.main, ["--grad-batch", "0"]),
            ("torch", tcli.main, ["--grad-batch", "0", "--device", "cpu"]),
            ("mesh", tcli.main, ["--mesh-data", "2", "--device", "cpu"])):
        shutil.copytree(start, tmp_path / tag)
        main(argv + extra + ["--ckpt", str(tmp_path / tag)])
        out = capfd.readouterr().out
        assert "resumed at step 0" in out
        lines[tag] = _LINE.findall(out)
    assert len(lines["jax"]) == 1
    for tag in ("torch", "mesh"):
        assert len(lines[tag]) == 1, tag
        for got, want in zip(lines[tag], lines["jax"]):
            assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
            assert abs(float(got[1]) - float(want[1])) <= 2e-4, tag
