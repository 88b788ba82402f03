"""The port's TransformerLM against the JAX reference, weight transfer, the
device rule of the entry points, and the port's import boundary.

* ``forward`` / ``prefill`` logits on the reference's own params carried
  across by ``load_jax_params`` (qwen3 smoke, f32; plus a variant with
  sliding windows and a logit softcap). atol/rtol 1e-4: two layers of the
  same f32 algebra, summed in another order, on logits of order 1.
* ``load_jax_params`` raises on missing / extra leaves and shape mismatch.
* Without CUDA an entry point raises unless ``device="cpu"`` is passed.
* Nothing under ``src/repro_torch/`` nor ``chip_smoke.py`` imports ``jax``
  or ``repro``: an AST scan, and a fresh interpreter that imports every
  port module and then inspects ``sys.modules``.
"""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jget_model

import repro_torch
from repro_torch import configs as tconfigs
from repro_torch.models import TransformerLM, get_model, load_jax_params
from torch_parity import t2n

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "qwen3-0.6b"
TOL = 1e-4

VARIANTS = {
    "qwen3_smoke": {},
    "window_softcap": dict(sliding_window=3, global_every=2,
                           attn_logit_softcap=20.0),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), **kw)
    jmodel = jget_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(TransformerLM(tcfg, device="cpu"), params)
    return jmodel, params, tmodel


def _tokens(vocab, b=2, s=11, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s)).astype(
        np.int32)


def test_forward_logits_match(pair):
    jmodel, params, tmodel = pair
    toks = _tokens(jmodel.cfg.vocab_size)
    j = jmodel.forward(params, jnp.asarray(toks))
    t = tmodel(torch.from_numpy(toks).long())
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t2n(t), np.asarray(j), atol=TOL, rtol=TOL)


def test_prefill_logits_match(pair):
    jmodel, params, tmodel = pair
    toks = _tokens(jmodel.cfg.vocab_size, s=7, seed=1)
    j = jmodel.prefill(params, jnp.asarray(toks))
    t = tmodel.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(t), np.asarray(j), atol=TOL, rtol=TOL)


def test_tied_output_weights_are_the_embedding(pair):
    _, params, tmodel = pair
    out_w = tmodel._output_weights()
    assert out_w.data_ptr() == tmodel.embed["embedding"].data_ptr()
    np.testing.assert_array_equal(
        t2n(out_w), np.asarray(params["embed"]["embedding"]).T)


# ---------------------------------------------------------------------------
# load_jax_params
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_params():
    cfg = jconfigs.get_smoke_config(ARCH)
    params = jget_model(cfg).init(jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, params)


def _model():
    return TransformerLM(tconfigs.get_smoke_config(ARCH), device="cpu")


def test_load_unstacks_layers(smoke_params):
    m = load_jax_params(_model(), smoke_params)
    wq = smoke_params["seg_dense"]["attn"]["wq"]["w"]
    for i, layer in enumerate(m.layers):
        np.testing.assert_array_equal(t2n(layer["attn"]["wq"]["w"]), wq[i])


@pytest.mark.parametrize("mutation,match", [
    ("missing", "missing"), ("extra", "extra"), ("shape", "shape")])
def test_load_rejects_mismatched_tree(smoke_params, mutation, match):
    tree = jax.tree_util.tree_map(lambda a: a, smoke_params)   # deep copy
    if mutation == "missing":
        del tree["seg_dense"]["attn"]["q_norm"]
    elif mutation == "extra":
        tree["lm_head"] = {"w": np.zeros((64, 512), np.float32)}
    else:
        tree["final_norm"]["scale"] = np.ones((63,), np.float32)
    with pytest.raises(ValueError, match=match):
        load_jax_params(_model(), tree)


def test_seeded_init_is_reproducible_on_cpu():
    cfg = tconfigs.get_smoke_config(ARCH)
    a = get_model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    b = get_model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# Device rule: the card unless the CPU is asked for
# ---------------------------------------------------------------------------


def test_model_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(cfg, device="cuda")
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


def test_unported_family_raises():
    """An unknown family raises the reference's ``ValueError``."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              family="speech")
    with pytest.raises(ValueError,
                       match="^unknown model family: speech$"):
        get_model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# Import boundary
# ---------------------------------------------------------------------------


def _port_files():
    pkg = os.path.dirname(repro_torch.__file__)
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_never_imports_jax_or_repro_ast():
    files = _port_files()
    names = {os.path.relpath(f, ROOT) for f in files}
    assert len(files) > 40
    assert {"src/repro_torch/train/loop.py",
            "src/repro_torch/kernels/backup_reduce.py",
            "src/repro_torch/distributed/spmd_engine.py"} <= names
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_port_never_imports_jax_or_repro_runtime():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert {"repro_torch.serve.engine", "repro_torch.train.loop",
            "repro_torch.train.checkpoint", "repro_torch.launch.train",
            "repro_torch.kernels.backup_reduce",
            "repro_torch.kernels.bucketed_reduce",
            "repro_torch.distributed.spmd_engine", "repro_torch.optim",
            "repro_torch.data.synthetic_lm", "repro_torch.core.events"} <= \
        set(mods)
