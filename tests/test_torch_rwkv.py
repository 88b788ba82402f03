"""The port's RWKV-6 family (rwkv6-1.6b) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
model's ``init`` and cross by ``load_jax_params``. Smoke config (f32, 2
layers, d_model 64, head dim 16). On the CPU the wkv runs the kernels'
plain twin (``kernels/rwkv6_scan.wkv6_plain``); the kernels themselves are
held to it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

* (a) ``wkv6_plain`` against the Pallas kernel in interpret mode
  (``repro.kernels.ops.wkv6``) and ``ref.reference_wkv6`` at the reference
  test's shapes: rtol 1e-4, atol 1e-4 x max|ref| (the reference's own).
* (b) ragged S against ``rwkv6.wkv_chunked`` and ``wkv_scan``, output and
  final state: rtol 1e-5, atol 1e-5 x max|ref| (the same f32 algorithm).
* (c) dr, dk, dv, dw, du of the plain twin against
  ``jax.vjp(rwkv6.wkv_chunked)`` on a seeded cotangent: rtol 1e-4, atol
  1e-4 x max|grad| (dw = d log w / w amplifies rounding where w is small).
* (c') the wkv6 backward kernels' two-pass decomposition, stated here in
  plain PyTorch (pass 1 scans dS back through the chunks and keeps the dS
  leaving each; pass 2 forms every chunk's gradients from its inputs, its
  incoming state and that dS alone), in f64 and f32, against
  ``jax.vjp(rwkv6.wkv_chunked)`` with and without a final-state
  cotangent: rtol 1e-4, atol 1e-4 x max|grad| (the reference computes in
  f32).
* (c'') the wkv6 forward kernel's decomposition, stated here in plain
  PyTorch (the state's value columns in slices of 8, 16 or 32, each
  carried through the chunks alone, the decays (products of w), scores and
  bonus recomputed for every slice), in f64 and f32: output and final
  state against
  ``rwkv6.wkv_chunked``, every chunk's incoming state against the final
  states of ``wkv6_plain`` on the whole-chunk prefixes, rtol 1e-5, atol
  1e-5 x max|ref|.
* (c''') the remat plumbing, with the kernels replaced by CPU stand-ins:
  under ``common.Remat`` (remat "full") the
  first pass of ``WKV6`` writes no chunk states, the recompute does, the
  backward gets the real ones and the gradients equal a run without
  checkpoint (bit for bit; through ``RWKVLM``, remat "full" and "dots"
  against "none"); a backward handed the placeholder raises.
* (d) time mix, channel mix and the block against JAX: atol 1e-5.
* (e) ``RWKVLM`` logits, ``per_token_loss`` and its gradients against
  ``jax.value_and_grad``, remat "none", "full" and "dots": atol 1e-5.
* (f) ``run_experiment``, backup 6 + 2, 4 steps, ``sim`` and ``spmd``,
  against the JAX trainer: masks and ``sim_time`` equal, losses within
  rtol 1e-5, params and EMA within atol 1e-5 (``test_torch_train.py``'s).
* (g) checkpoints resume across packages both ways (atol 1e-5).
* (h) the training CLI runs ``--arch rwkv6-1.6b --smoke --device cpu``.
* (i) the converter round-trips the ``blocks`` tree and names a bad leaf.
* (j) the serve entry points (``init_cache``, ``decode_step``, ``prefill``)
  against JAX's (atol 1e-5); the full suite is ``test_torch_decode.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")


import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import get_model as jget_model
from repro.models import registry as jregistry
from repro.models import rwkv6 as jrwkv6
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.kernels import rwkv6_scan
from repro_torch.launch import train as tcli
from repro_torch.models import (RWKVLM, common as tcommon, from_jax_tree,
                                get_model, load_jax_params, to_jax_tree)
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from torch_parity import port_config

ARCH = "rwkv6-1.6b"
ATOL = 1e-5


def _wkv_inputs(b, s, h, d, seed):
    """r/k/v [B, S, H, D] ~ 0.5 N(0, 1); w = exp(-exp(clip(N - 1, -8,
    1.6))), the model's decay range; u [H, D] (the reference test's)."""
    rng = np.random.RandomState(seed)
    r, k, v = ((0.5 * rng.randn(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w_log = np.clip(rng.randn(b, s, h, d) - 1.0, -8.0, 1.6)
    w = np.exp(-np.exp(w_log)).astype(np.float32)
    u = (0.5 * rng.randn(h, d)).astype(np.float32)
    return r, k, v, w, u


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * (np.abs(want).max() + 1e-6),
                               err_msg=what)


# ---------------------------------------------------------------------------
# (a)-(c) the wkv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,d", [(64, 16), (128, 32)])
def test_plain_wkv_matches_pallas_kernel_and_oracle(s, d):
    args = _wkv_inputs(2, s, 2, d, seed=s + d)
    out, _ = rwkv6_scan.wkv6_plain(*map(torch.from_numpy, args))
    pallas = jops.wkv6(*map(jnp.asarray, args), chunk=16)
    oracle, _ = jref.reference_wkv6(
        *(jnp.asarray(t).transpose(0, 2, 1, 3) for t in args[:4]),
        jnp.asarray(args[4]))
    _close(out.numpy(), pallas, 1e-4, "vs Pallas (interpret)")
    _close(out.numpy(), oracle.transpose(0, 2, 1, 3), 1e-4, "vs oracle")


@pytest.mark.parametrize("s", [40, 100])
def test_ragged_wkv_matches_chunked_and_scan(s):
    args = _wkv_inputs(2, s, 3, 16, seed=s)
    targs = list(map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    for tfn, jfn in ((trwkv6.wkv_chunked, jrwkv6.wkv_chunked),
                     (trwkv6.wkv_scan, jrwkv6.wkv_scan)):
        out, state = tfn(*targs)
        jout, jstate = jfn(*jargs)
        _close(out.numpy(), jout, 1e-5, f"{tfn.__name__} out")
        _close(state.numpy(), jstate, 1e-5, f"{tfn.__name__} state")
    # the model's CPU route is the plain twin
    out, _ = trwkv6.wkv_chunked(*targs)
    _close(out.numpy(), rwkv6_scan.wkv6_plain(*targs)[0].numpy(), 0.0)


@pytest.mark.parametrize("s", [64, 40])
def test_plain_wkv_grads_match_jax_vjp(s):
    args = _wkv_inputs(2, s, 2, 16, seed=7 + s)
    cot = np.random.RandomState(8).randn(2, s, 2, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jrwkv6.wkv_chunked(*a)[0],
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out, _ = rwkv6_scan.wkv6_plain(*targs)
    out.backward(torch.from_numpy(cot))
    for name, t, g in zip(("dr", "dk", "dv", "dw", "du"), targs, want):
        _close(t.grad.numpy(), g, 1e-4, name)


def _wkv_two_pass_backward(r, k, v, w, u, dout, dfinal, chunk=16):
    """The wkv6 backward kernels' decomposition in plain PyTorch, in the
    inputs' dtype: pass 1 carries dS back through the chunks and keeps the
    dS leaving each one; pass 2 is chunk-local (all chunks at once), from a
    chunk's rows, its incoming state and its outgoing dS. Returns
    (dr, dk, dv, dw [B, S, H, D], du [H, D])."""
    b, s, h, d = r.shape
    n = -(-s // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - s)
    r, k, v, dout = (torch.nn.functional.pad(t, pad) for t in (r, k, v, dout))
    w = torch.nn.functional.pad(w, pad, value=1.0)

    def chunks(t):                                    # [B, H, n, C, D]
        return t.reshape(b, n, chunk, h, d).permute(0, 3, 1, 2, 4)

    r, k, v, w, do = (chunks(t) for t in (r, k, v, w, dout))
    uc = u[None, :, None, None, :]
    lw = torch.log(torch.clamp_min(w, 1e-30))
    acc = torch.cumsum(lw, dim=3)
    a_last = acc[..., -1:, :]
    ri, kj, kd = r * torch.exp(acc - lw), k * torch.exp(-acc), \
        k * torch.exp(a_last - acc)
    a = torch.exp(a_last[..., 0, :])                  # [B, H, n, D]
    # the forward's saved incoming states
    st, states = torch.zeros((b, h, d, d), dtype=r.dtype), []
    for c in range(n):
        states.append(st)
        st = a[:, :, c, :, None] * st + kd[:, :, c].transpose(-1, -2) @ v[:, :, c]
    states = torch.stack(states, dim=2)
    # pass 1: the dS leaving every chunk
    ds = torch.zeros_like(st) if dfinal is None else dfinal
    ds_all = [None] * n
    for c in reversed(range(n)):
        ds_all[c] = ds
        ds = a[:, :, c, :, None] * ds + ri[:, :, c].transpose(-1, -2) @ do[:, :, c]
    ds_all = torch.stack(ds_all, dim=2)
    # pass 2
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    sc = torch.where(tri, ri @ kj.transpose(-1, -2), 0.0)
    dsc = torch.where(tri, do @ v.transpose(-1, -2), 0.0)
    bonus, dbonus = (r * uc * k).sum(-1), (do * v).sum(-1)
    dri = dsc @ kj + do @ states.transpose(-1, -2)
    dkj = dsc.transpose(-1, -2) @ ri
    dkd = v @ ds_all.transpose(-1, -2)
    dv = (sc.transpose(-1, -2) @ do + bonus[..., None] * do + kd @ ds_all)
    g_ex = dri * ri
    term = g_ex - dkj * kj - dkd * kd
    suffix = torch.flip(torch.cumsum(torch.flip(term, [3]), 3), [3])
    g_last = (states * ds_all).sum(-1) * a + (dkd * kd).sum(3)
    g_lw = suffix - g_ex + g_last[..., None, :]
    dr = dri * torch.exp(acc - lw) + dbonus[..., None] * uc * k
    dk = (dkj * torch.exp(-acc) + dkd * torch.exp(a_last - acc)
          + dbonus[..., None] * uc * r)
    dw = torch.where(w > 1e-30, g_lw / w, 0.0)
    du = (dbonus[..., None] * r * k).sum(3).sum(dim=(0, 2))

    def unchunk(t):
        return t.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, d)[:, :s]

    return (*(unchunk(t) for t in (dr, dk, dv, dw)), du)


@functools.lru_cache(maxsize=None)
def _wkv_vjp_case(s, d, dfinal):
    """Inputs, cotangents and jax.vjp(rwkv6.wkv_chunked)'s gradients."""
    args = _wkv_inputs(2, s, 2, d, seed=3 * s + d)
    rng = np.random.RandomState(s + d)
    cot = rng.randn(2, s, 2, d).astype(np.float32)
    cot_state = (rng.randn(2, 2, d, d).astype(np.float32) if dfinal
                 else np.zeros((2, 2, d, d), np.float32))
    _, vjp = jax.vjp(jrwkv6.wkv_chunked, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(cot), jnp.asarray(cot_state)))
    return args, cot, cot_state if dfinal else None, [np.asarray(g)
                                                      for g in want]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dfinal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 16, 40, 100])
def test_two_pass_wkv_backward_matches_jax_vjp(s, d, dfinal, dtype):
    args, cot, cot_state, want = _wkv_vjp_case(s, d, dfinal)
    got = _wkv_two_pass_backward(
        *(torch.from_numpy(a).to(dtype) for a in args),
        torch.from_numpy(cot).to(dtype),
        None if cot_state is None else torch.from_numpy(cot_state).to(dtype))
    for name, g, ref in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        _close(g.numpy(), ref, 1e-4, name)


def _wkv_column_slices(r, k, v, w, u, width, chunk=16):
    """The wkv6 forward kernel's decomposition in plain PyTorch, in the
    inputs' dtype: the state's value columns in slices of ``width``, each
    carried through the chunks on its own, the chunk's decays (products of
    w), scores and bonus recomputed for every slice. Returns (out [B, S, H, D],
    final state [B, H, D, D], every chunk's incoming state
    [B, H, n_chunks, D, D])."""
    b, s, h, d = r.shape
    width = min(width, d)                     # a slice is at most the head
    n = -(-s // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - s)
    r, k, v = (torch.nn.functional.pad(t, pad) for t in (r, k, v))
    w = torch.nn.functional.pad(w, pad, value=1.0)

    def chunks(t):                                    # [B, H, n, C, D]
        return t.reshape(b, n, chunk, h, d).permute(0, 3, 1, 2, 4)

    r, k, v, w = (chunks(t) for t in (r, k, v, w))
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    out = torch.zeros_like(v)
    states = torch.zeros((b, h, n, d, d), dtype=r.dtype)
    final = torch.zeros((b, h, d, d), dtype=r.dtype)
    for e0 in range(0, d, width):
        cols = slice(e0, e0 + width)
        st = torch.zeros((b, h, d, width), dtype=r.dtype)
        for c in range(n):
            rc, kc, wc = r[:, :, c], k[:, :, c], w[:, :, c]
            vc = v[:, :, c, :, cols]
            wc = torch.clamp_min(wc, 1e-30)
            incl = torch.cumprod(wc, dim=2)
            a_last = incl[:, :, -1:]
            ri, kj = rc * incl / wc, kc / incl
            kd = kj * a_last
            sc = (torch.where(below, ri @ kj.transpose(-1, -2), 0.0)
                  + torch.diag_embed((rc * u[None, :, None, :] * kc).sum(-1)))
            states[:, :, c, :, cols] = st
            out[:, :, c, :, cols] = ri @ st + sc @ vc
            st = a_last[:, :, 0, :, None] * st + kd.transpose(-1, -2) @ vc
        final[..., cols] = st
    out = out.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, d)[:, :s]
    return out, final, states


@functools.lru_cache(maxsize=None)
def _wkv_forward_case(s, d):
    """Inputs, ``rwkv6.wkv_chunked``'s output and final state, and every
    chunk's incoming state: the plain twin's final state on each
    whole-chunk prefix (zero for the first chunk)."""
    args = _wkv_inputs(2, s, 2, d, seed=5 * s + d)
    out, final = jrwkv6.wkv_chunked(*map(jnp.asarray, args))
    targs = list(map(torch.from_numpy, args))
    states = [torch.zeros((2, 2, d, d))] + [
        rwkv6_scan.wkv6_plain(*(t[:, :16 * c] for t in targs[:4]),
                              targs[4])[1] for c in range(1, -(-s // 16))]
    return (args, np.asarray(out), np.asarray(final),
            torch.stack(states, dim=2).numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 16, 40, 100])
def test_column_slice_wkv_forward_matches_jax(s, d, width, dtype):
    args, want_out, want_final, want_states = _wkv_forward_case(s, d)
    out, final, states = _wkv_column_slices(
        *(torch.from_numpy(a).to(dtype) for a in args), width)
    _close(out.numpy(), want_out, 1e-5, "out")
    _close(final.numpy(), want_final, 1e-5, "final state")
    _close(states.numpy(), want_states, 1e-5, "chunk states")


def _stand_in_kernels(monkeypatch, log):
    """Replace the wkv6 kernels with CPU stand-ins that log what they are
    asked for: the forward (the column-slice decomposition) logs
    ``save_states``; the backward (the plain twin's autograd) logs whether
    the states it got have a zero stride and equal the recomputed ones."""
    def forward(r, k, v, w, u, *, save_states=True):
        log.append(("fwd", save_states))
        out, final, states = _wkv_column_slices(r, k, v, w, u, 16)
        return out, final, states if save_states else None

    def backward(r, k, v, w, u, states, dout, dfinal=None):
        real = _wkv_column_slices(r, k, v, w, u, 16)[2]
        log.append(("bwd", 0 in states.stride(), torch.equal(states, real)))
        return _plain_backward_parts(r, k, v, w, u, dout, dfinal)

    monkeypatch.setattr(rwkv6_scan, "wkv6_forward", forward)
    monkeypatch.setattr(rwkv6_scan, "wkv6_backward_parts", backward)


def _plain_backward_parts(r, k, v, w, u, dout, dfinal):
    """The backward kernels' outputs from the plain twin's autograd:
    (dr, dk, dv, dw, du_part [B, H, n_chunks, D]), each row's du in its
    chunk 0 (the kernels spread it over the chunks; the sums agree)."""
    leaves = [t.detach().float().requires_grad_() for t in (r, k, v, w)]
    du_rows = []
    with torch.enable_grad():       # a backward runs without grad mode
        for b in range(r.shape[0]):
            ub = u.detach().float().requires_grad_()
            out, final = rwkv6_scan.wkv6_plain(
                *(t[b:b + 1] for t in leaves), ub)
            loss = (out * dout[b:b + 1]).sum()
            if dfinal is not None:
                loss = loss + (final * dfinal[b:b + 1]).sum()
            loss.backward()
            du_rows.append(ub.grad)
    b, s, h, d = r.shape
    du_part = torch.zeros((b, h, -(-s // rwkv6_scan.CHUNK), d))
    du_part[:, :, 0] = torch.stack(du_rows)
    return (*(t.grad for t in leaves), du_part)


def _wkv_out(*args):
    return rwkv6_scan.wkv6(*args)[0]


def test_remat_first_pass_writes_no_wkv_states(monkeypatch):
    log = []
    _stand_in_kernels(monkeypatch, log)
    args = _wkv_inputs(2, 40, 2, 16, seed=11)
    cot = torch.from_numpy(
        np.random.RandomState(12).randn(2, 40, 2, 16).astype(np.float32))
    grads = {}
    for remat in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        if remat:           # as RWKVLM.forward calls it
            out = tcommon.Remat.apply(_wkv_out, *leaves)
        else:
            out = _wkv_out(*leaves)
        out.backward(cot)
        grads[remat] = [t.grad for t in leaves]
    # without remat one forward writes the states; with it a first pass
    # writes none, the recompute does, and each backward gets real states
    assert log == [("fwd", True), ("bwd", False, True),
                   ("fwd", False), ("fwd", True), ("bwd", False, True)]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_wkv_backward_refuses_the_placeholder(monkeypatch):
    _stand_in_kernels(monkeypatch, [])
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in _wkv_inputs(1, 20, 1, 16, seed=13)]
    with rwkv6_scan.states_discarded():
        out = _wkv_out(*leaves)
    with pytest.raises(RuntimeError, match="placeholder"):
        out.sum().backward()


def test_rwkv_model_remat_writes_wkv_states_once(monkeypatch):
    log = []
    _stand_in_kernels(monkeypatch, log)
    monkeypatch.setattr(        # the model's wkv through WKV6, on the CPU
        trwkv6, "wkv_chunked",
        lambda r, k, v, w, u, state=None, *a, **kw: rwkv6_scan.wkv6(
            r, k, v, w, u))
    cfg = tconfigs.get_smoke_config(ARCH)
    toks, labels = _loss_inputs(cfg.vocab_size)
    weights, runs = None, {}
    for remat in ("none", "full", "dots"):
        model = RWKVLM(dataclasses.replace(cfg, remat=remat), device="cpu")
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        del log[:]
        per_tok, _ = model.per_token_loss({"tokens": toks, "labels": labels})
        per_tok.mean().backward()
        runs[remat] = (per_tok.detach(), dict(model.named_parameters()),
                       list(log))
    layers = cfg.num_layers
    assert [e for e in runs["none"][2] if e[0] == "fwd"] == \
        [("fwd", True)] * layers
    for remat in ("full", "dots"):
        assert [e for e in runs[remat][2] if e[0] == "fwd"] == \
            [("fwd", False)] * layers + [("fwd", True)] * layers
    for _, _, run_log in runs.values():
        assert [e for e in run_log if e[0] == "bwd"] == \
            [("bwd", False, True)] * layers
    for remat in ("full", "dots"):
        assert torch.equal(runs["none"][0], runs[remat][0])
        for name, p in runs[remat][1].items():
            assert torch.equal(p.grad, runs["none"][1][name].grad), name


def test_kernel_wrapper_refuses_cpu_tensors():
    args = list(map(torch.from_numpy, _wkv_inputs(1, 16, 1, 16, seed=0)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_scan.wkv6(*args)
    with pytest.raises(ValueError, match=r"u must be \[H, D\]"):
        rwkv6_scan.wkv6(*args[:4], args[4][:, :8])


# ---------------------------------------------------------------------------
# (d) layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """(JAX config, JAX params, port model holding the same params); the
    trainer runs below start from the same params."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0))
    model = load_jax_params(RWKVLM(port_config(jcfg), device="cpu"), params)
    return jcfg, params, model


def test_layernorm_matches():
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(3, 5, 24) + 1.0).astype(np.float32)
    p = {"scale": rng.randn(24).astype(np.float32),
         "bias": rng.randn(24).astype(np.float32)}
    tp = tcommon.layernorm_init(24)
    with torch.no_grad():
        for k, v in p.items():
            tp[k].copy_(torch.from_numpy(v))
    got = tcommon.layernorm(tp, torch.from_numpy(x))
    want = jcommon.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("part", ["time_mix", "time_mix_step",
                                  "channel_mix", "block"])
def test_layers_match(smoke, part):
    jcfg, params, model = smoke
    tcfg = port_config(jcfg)
    p0 = jax.tree_util.tree_map(lambda t: t[0], params["blocks"])
    tp = model.blocks[0]
    s = 1 if part == "time_mix_step" else 20
    rng = np.random.RandomState(4)
    x = rng.randn(2, s, 64).astype(np.float32)
    x_prev = rng.randn(2, 64).astype(np.float32)
    state = (0.3 * rng.randn(2, 4, 16, 16)).astype(np.float32)
    tx, tprev, tstate = map(torch.from_numpy, (x, x_prev, state))
    jx, jprev, jstate = map(jnp.asarray, (x, x_prev, state))
    with torch.no_grad():
        if part.startswith("time_mix"):
            got, (gx, gs) = trwkv6.time_mix_apply(tp["att"], tcfg, tx, tprev,
                                                  tstate)
            want, (wx, ws) = jrwkv6.time_mix_apply(p0["att"], jcfg, jx, jprev,
                                                   jstate)
            extras = [(gx, wx), (gs, ws)]
        elif part == "channel_mix":
            got, gx = trwkv6.channel_mix_apply(tp["ffn"], tx, tprev)
            want, wx = jrwkv6.channel_mix_apply(p0["ffn"], jx, jprev)
            extras = [(gx, wx)]
        else:
            # the zero block state of each package, then a random one
            extras = []
            for bs, jbs in (
                    (trwkv6.rwkv_init_block_state(tcfg, 2),
                     jrwkv6.rwkv_init_block_state(jcfg, 2)),
                    ({"att_x": tprev, "att_s": tstate, "ffn_x": -tprev},
                     {"att_x": jprev, "att_s": jstate, "ffn_x": -jprev})):
                for key in bs:
                    assert tuple(bs[key].shape) == tuple(jbs[key].shape)
                got, gst = trwkv6.rwkv_block_apply(tp, tcfg, tx, bs)
                want, wst = jrwkv6.rwkv_block_apply(p0, jcfg, jx, jbs)
                extras += [(gst[k], wst[k]) for k in bs] + [(got, want)]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    for g, w in extras:
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


# ---------------------------------------------------------------------------
# (e) the model, its loss and gradients
# ---------------------------------------------------------------------------


def _loss_inputs(vocab, b=3, s=20, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return toks, labels


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_model_loss_and_grads_match(smoke, remat):
    jcfg, params, _ = smoke
    jcfg = dataclasses.replace(jcfg, remat=remat)
    jmodel = jget_model(jcfg)
    toks, labels = _loss_inputs(jcfg.vocab_size)
    valid = jnp.asarray(labels >= 0, jnp.float32)

    def f(p):
        per_tok, _ = jmodel.per_token_loss(
            p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        return jnp.sum(per_tok * valid) / jnp.sum(valid), per_tok

    (jval, jper_tok), jgrads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    tmodel = load_jax_params(RWKVLM(port_config(jcfg), device="cpu"), params)
    if remat == "none":                   # remat does not change the logits
        with torch.no_grad():
            logits = tmodel(torch.from_numpy(toks).long())
        np.testing.assert_allclose(
            logits.numpy(), jax.jit(jmodel.forward)(params, jnp.asarray(toks)),
            atol=ATOL)
    per_tok, aux = tmodel.per_token_loss({"tokens": toks, "labels": labels})
    tvalid = torch.from_numpy(labels >= 0).float()
    val = torch.sum(per_tok * tvalid) / torch.sum(tvalid)
    val.backward()
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(per_tok.detach().numpy(), jper_tok, atol=ATOL)
    jgrads = from_jax_tree(jgrads)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# (f), (g) the trainer on both backends, checkpoints across packages
# ---------------------------------------------------------------------------


def _jax_cfg(backend, directory, *, steps=4, every=0):
    return jbase.TrainConfig(
        model=dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                  remat="full"),
        shape=jbase.ShapeConfig("t", 16, 2 * 8, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=6,
                                            backup_workers=2),
        # eps 1e-3 for the reason test_torch_train.py gives
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=1),
        seed=0, total_steps=steps, log_every=1)


def _port_cfg(jcfg):
    cfg = port_config(jcfg)
    # use_kernel=True asks for the backup_reduce CUDA kernel; the port's
    # auto rule (None) takes its plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, smoke):
    """Four-step runs per (package, backend) from the JAX init (seed 0, as
    the JAX trainer's); the sim runs checkpoint at steps 2 and 4."""
    jax_params = smoke[1]
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, jax_params)
        self.reset_optimizer_state()

    root = tmp_path_factory.mktemp("rwkv_train")
    out = {"root": root}
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        for backend in ("sim", "spmd"):
            every = 2 if backend == "sim" else 0
            out["jax", backend] = jloop.run_experiment(
                _jax_cfg(backend, root / f"jax_{backend}", every=every))
            out["torch", backend] = tloop.run_experiment(_port_cfg(
                _jax_cfg(backend, root / f"torch_{backend}", every=every)),
                device="cpu")
    finally:
        mp.undo()
    return out


def _assert_state_close(params, ema, jparams, jema):
    """Port-named params and EMA (tensors or arrays) against the JAX
    run's."""
    for got, want in ((params, jparams), (ema, jema)):
        want = from_jax_tree(want)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            v = v.detach().numpy() if isinstance(v, torch.Tensor) else v
            np.testing.assert_allclose(np.asarray(v), np.asarray(want[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_run_experiment_matches_jax(runs, backend):
    jres, tres = runs["jax", backend], runs["torch", backend]
    assert tres.steps == jres.steps == 4
    for key in ("selected", "sim_time", "lr"):
        assert [m[key] for m in tres.metrics] == \
            [m[key] for m in jres.metrics]
    assert tres.sim_time == jres.sim_time
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics], rtol=1e-5)
    _assert_state_close(tres.params, tres.ema, jres.params, jres.ema)


def test_jax_checkpoint_resumes_in_the_port(runs):
    jdir = runs["root"] / "jax_sim"
    tr = tloop.Trainer(_port_cfg(_jax_cfg("sim", jdir)), device="cpu")
    tr.reset_optimizer_state()
    tr.restore_checkpoint(2)
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert tr.step == 4 and res.sim_time == jres.sim_time
    _assert_state_close(res.params, res.ema, jres.params, jres.ema)


def test_port_checkpoint_resumes_in_jax(runs):
    tdir = runs["root"] / "torch_sim"
    assert tckpt.available_steps(str(tdir)) == [2, 4]
    tr = jloop.Trainer(_jax_cfg("sim", tdir))
    tr.restore_checkpoint(2)
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert res.sim_time == jres.sim_time
    _assert_state_close(from_jax_tree(res.params), from_jax_tree(res.ema),
                        jres.params, jres.ema)


# ---------------------------------------------------------------------------
# (h) CLI, (i) converter, config and registry, (j) refusals
# ---------------------------------------------------------------------------


def test_cli_trains_rwkv_on_cpu(tmp_path, capsys):
    tcli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
               "--seq", "8", "--batch-per-worker", "1", "--workers", "3",
               "--backups", "1", "--ckpt", str(tmp_path),
               "--execution", "spmd"])
    out = capsys.readouterr().out
    assert "[train] step     2 loss" in out and "done: 2 steps" in out
    assert tckpt.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_and_param_count_match_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if getter == "get_smoke_config":     # the full model is built on the card
        model = get_model(t, device="cpu")
        assert isinstance(model, RWKVLM)
        assert sum(p.numel() for p in model.parameters()) == \
            jregistry.param_count(j)
    else:
        assert jregistry.param_count(j) == 1_584_095_232


def test_converter_roundtrips_blocks_and_names_a_bad_leaf(smoke):
    _, params, model = smoke
    named = dict(model.named_parameters())
    assert named["blocks.1.att.u"].shape == (4, 16)
    tree = to_jax_tree({k: v.detach() for k, v in named.items()})
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for path, leaf in from_jax_tree(params).items():
        np.testing.assert_array_equal(named[path].detach().numpy(), leaf)
    np.testing.assert_array_equal(tree["blocks"]["att"]["u"],
                                  params["blocks"]["att"]["u"])
    bad = jax.tree_util.tree_map(lambda t: t, params)
    bad["blocks"]["att"]["u"] = bad["blocks"]["att"]["u"][:, :, :8]
    with pytest.raises(ValueError, match=r"blocks\.0\.att\.u"):
        load_jax_params(RWKVLM(model.cfg, device="cpu"), bad)
    with pytest.raises(ValueError, match=r"blocks\.\*\.att\.u: layers"):
        to_jax_tree({"blocks.1.att.u": named["blocks.1.att.u"]})


@pytest.mark.parametrize("call", ["decode_step", "prefill", "init_cache"])
def test_refused_by_name(smoke, call):
    """The serve surfaces once refused by name run, against JAX's on the
    same params (atol 1e-5): ``init_cache`` (the zero state, its leaves
    and shapes), ``decode_step`` (4 steps: logits and the carried state)
    and ``prefill`` (the last position's logits)."""
    jcfg, params, model = smoke
    jmodel = jget_model(jcfg)
    toks, _ = _loss_inputs(jcfg.vocab_size, b=2, s=4)
    if call == "init_cache":
        got, want = model.init_cache(2, 8), jmodel.init_cache(2, 8)
        assert got["lens"] == int(want["lens"]) == 0
        for g, w in zip(got["state"], want["state"]):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    elif call == "decode_step":
        cache, jcache = model.init_cache(2, 8), jmodel.init_cache(2, 8)
        for i in range(4):
            logits, cache = model.decode_step(
                torch.from_numpy(toks[:, i:i + 1]), cache)
            jlogits, jcache = jmodel.decode_step(
                params, jnp.asarray(toks[:, i:i + 1]), jcache)
            _close(logits, jlogits, 1e-5, "decode logits")
        for g, w in zip(cache["state"], jcache["state"]):
            for k in w:
                _close(g[k], w[k], 1e-5, f"state {k}")
        assert cache["lens"] == 4
    else:
        with torch.no_grad():
            got = model.prefill(torch.from_numpy(toks).long())
        _close(got, jmodel.prefill(params, jnp.asarray(toks)), 1e-5,
               "prefill")
