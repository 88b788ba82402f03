"""Chunked RWKV-6 wkv recurrence (data-dependent decay), forward and backward.
Reference: ``src/repro/kernels/rwkv6_scan.py`` (``wkv6_chunked`` /
``_wkv_kernel``, the TPU kernel this module's CUDA kernels replace), as the
reference model runs it: through its jnp twin
``src/repro/models/rwkv6.py`` (``wkv_chunked``), differentiated by XLA.
Oracle: ``kernels/ref.reference_wkv6``.

``wkv6(r, k, v, w, u)`` with r/k/v/w ``[B, S, H, D]`` and u ``[H, D]``
returns ``(out [B, S, H, D] f32, final state [B, H, D, D] f32)`` from a
zero state, in chunks of 16:

* :func:`wkv6` runs the hand-written kernels ``csrc/rwkv6_scan.cu``
  (head dims 16, 32, 64; r/k/v f32 or bf16; w and u f32; any S, a ragged
  last chunk masked) on CUDA tensors and raises on anything else:
  :func:`wkv6_forward` launches one kernel (the state's columns split over
  blocks), :func:`wkv6_backward` two (the dS scan, then the chunk-local
  gradients), and :class:`WKV6` / :class:`WKV6Backward` bind them as
  ``autograd.Function`` classes that ``torch.func`` goes through: under
  ``vmap`` the vmapped rows (the spmd engine's workers) fold into B, one
  launch for all of them, and ``du`` comes back per row. The forward
  writes every chunk's incoming state for the backward only when a
  backward may follow (:func:`wants_states`): not in the first pass of a
  remat block, nor under :func:`states_discarded` (the first pass of remat
  'dots', a selective checkpoint whose saved tensors are thrown away).
* :func:`wkv6_plain` is the same chunked form in plain PyTorch (autograd
  gives its backward), which the kernels are held to on the card.

The model's ``rwkv6.wkv_chunked`` chooses between the two: the plain
version for CPU tensors or ``use_kernel=False``, else the kernels.

``launches_fwd`` counts forward launches, ``launches_fwd_states`` those of
them that wrote the chunk states, and ``launches_bwd`` backward calls, each
of which launches the backward's two kernels (and nothing else counts). A
call recorded in a CUDA-graph capture counts once per replay
(``kernels.counters``).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

CHUNK = 16
HEAD_DIMS = (16, 32, 64)
FWD_SLICE = 32    # state columns a forward block carries, at most D
                  # (kFwdSlice in csrc/rwkv6_scan.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches_fwd = 0
launches_fwd_states = 0
launches_bwd = 0
_lib = None
_discard_states = False


def wkv6_plain(r, k, v, w, u, state: Optional[torch.Tensor] = None,
               chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch, f32: the reference's ``wkv_chunked`` (intra-chunk
    attention form + inter-chunk state; S padded to a whole chunk with
    r = k = v = 0, w = 1). Returns (out [B, S, H, D], final state)."""
    b, s, h, d = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    if state is None:
        state = torch.zeros((b, h, d, d), dtype=torch.float32,
                            device=r.device)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)

    def chunks(t):                                   # [n, B, H, C, D]
        return t.reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)

    rs, ks, vs, ws = (chunks(t) for t in (r, k, v, w))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rs[i], ks[i], vs[i], ws[i]
        logw = torch.log(torch.clamp_min(wc, 1e-30))
        acc = torch.cumsum(logw, dim=2)                      # inclusive
        acc_ex = acc - logw                                  # exclusive
        ri = rc * torch.exp(acc_ex)
        kj = kc * torch.exp(-acc)
        scores = torch.einsum("bhtd,bhjd->bhtj", ri, kj)
        scores = torch.where(tri, scores, torch.zeros_like(scores))
        bonus = torch.einsum("bhtd,bhtd->bht", rc * u[None, :, None, :], kc)
        out = torch.einsum("bhtj,bhjd->bhtd", scores, vc)
        out = out + bonus[..., None] * vc
        out = out + torch.einsum("bhtd,bhde->bhte", ri, state)
        a_all = torch.exp(acc[:, :, -1:, :])
        k_dec = kc * torch.exp(acc[:, :, -1:, :] - acc)
        state = (a_all[:, :, 0, :, None] * state
                 + torch.einsum("bhjd,bhje->bhde", k_dec, vc))
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, d)
    return out[:, :s], state


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w must share one [B, S, H, D] shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be [H, D] = {tuple(r.shape[2:])}, got "
                         f"{tuple(u.shape)}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("r, k, v, w and u must be on one device")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("rwkv6_scan")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_fwd.argtypes = [i32] + [vp] * 9 + [i32] * 4 + [vp]
        lib.wkv6_fwd.restype = i32
        lib.wkv6_bwd.argtypes = [i32] + [vp] * 15 + [i32] * 5 + [vp]
        lib.wkv6_bwd.restype = i32
        lib.wkv6_error_string.argtypes = [i32]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_args(r, k, v, w, u):
    """Validate CUDA inputs for the kernels; returns (dtype code, strides)."""
    if r.device.type != "cuda":
        raise ValueError(f"the wkv6 kernels run on CUDA tensors, not "
                         f"{r.device}; the CPU takes wkv6_plain")
    d = r.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernels take "
                         f"{HEAD_DIMS}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE:
        raise ValueError(f"r/k/v must share one of {list(_DTYPE_CODE)}, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w and u must be f32, got {w.dtype}, {u.dtype}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)) or not u.is_contiguous():
        raise ValueError("r/k/v/w need a unit-stride head_dim axis and u "
                         "must be contiguous")
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (r, k, v, w) for i in range(3)])
    return _DTYPE_CODE[r.dtype], strides


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.wkv6_error_string(err).decode()}")


def wkv6_forward(r, k, v, w, u, *, save_states: bool = True):
    """Launch the forward kernel on CUDA tensors: (out [B, S, H, D] f32,
    final state [B, H, D, D] f32, every chunk's incoming state
    [B, H, n_chunks, D, D] f32 or None when ``save_states`` is false).
    The kernel loads 16-byte rows: r/k/v/w whose rows do not start 16-byte
    aligned are refused."""
    global launches_fwd, launches_fwd_states
    _check(r, k, v, w, u)
    code, strides = _kernel_args(r, k, v, w, u)
    if any(t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                    for i in range(3))
           for t in (r, k, v, w)):
        raise ValueError("the wkv6 forward loads 16-byte rows: the base "
                         "pointers of r, k, v and w must be 16-byte aligned "
                         "and their b, s and h strides multiples of 16 bytes")
    b, s, h, d = r.shape
    dev = r.device
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    final = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, -(-s // CHUNK), d, d), dtype=torch.float32,
                         device=dev) if save_states else None
    if b * s * h == 0:
        return out, final.zero_(), states
    lib = _load()
    err = lib.wkv6_fwd(code, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), strides, out.data_ptr(),
                       None if states is None else states.data_ptr(),
                       final.data_ptr(), b, s, h, d, _build.stream_ptr(dev))
    _raise_on(lib, err, "wkv6 forward")
    launches_fwd += 1
    if save_states:
        launches_fwd_states += 1
    return out, final, states


@contextlib.contextmanager
def states_discarded():
    """Under this, :func:`wkv6` writes no chunk states and saves a
    zero-stride placeholder of their shape in their place: for a forward
    whose saved tensors are thrown away, as the first pass of a
    non-reentrant checkpoint's are (its recompute saves the real ones).
    The backward raises if it is handed the placeholder."""
    global _discard_states
    before, _discard_states = _discard_states, True
    try:
        yield
    finally:
        _discard_states = before


def backward_passes(r, k, v, w, u, states, dout, dfinal=None):
    """The backward's two kernels as two calls on shared buffers: pass 1
    (the dS scan, which writes the dS leaving every chunk to a scratch
    ``[B, H, n_chunks, D, D]`` f32) and pass 2 (the chunk-local gradients
    from it). Returns ``(pass1, pass2, (dr, dk, dv, dw, du_part))``; each
    call launches its kernel and counts nothing. :func:`wkv6_backward` runs
    both; timing each alone is the other use."""
    code, strides = _kernel_args(r, k, v, w, u)
    b, s, h, d = r.shape
    dev = r.device
    nc = -(-s // CHUNK)
    grads = [torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
             for _ in range(4)]
    du_part = torch.empty((b, h, nc, d), dtype=torch.float32, device=dev)
    ds_all = torch.empty((b, h, nc, d, d), dtype=torch.float32, device=dev)
    dout = dout.float().contiguous()
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    lib = _load()

    def launch(passes: int) -> None:
        err = lib.wkv6_bwd(code, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), strides,
                           dout.data_ptr(),
                           None if dfinal is None else dfinal.data_ptr(),
                           states.data_ptr(), ds_all.data_ptr(),
                           *(g.data_ptr() for g in grads), du_part.data_ptr(),
                           b, s, h, d, passes, _build.stream_ptr(dev))
        _raise_on(lib, err, "wkv6 backward")

    return (lambda: launch(1)), (lambda: launch(2)), (*grads, du_part)


def wkv6_backward_parts(r, k, v, w, u, states, dout, dfinal=None):
    """Launch the backward's two kernels: from the forward's inputs and
    ``states`` and the output's (and, when given, the final state's)
    gradient, the f32 gradients (dr, dk, dv, dw [B, S, H, D]) and ``du``
    per row and chunk (``du_part`` [B, H, n_chunks, D]): its sum over rows
    and chunks is ``du``."""
    global launches_bwd
    b, s, h, d = r.shape
    if b * s * h == 0:
        _kernel_args(r, k, v, w, u)
        return (*(torch.empty((b, s, h, d), dtype=torch.float32,
                              device=r.device) for _ in range(4)),
                torch.zeros((b, h, -(-s // CHUNK), d), dtype=torch.float32,
                            device=r.device))
    pass1, pass2, grads = backward_passes(r, k, v, w, u, states, dout,
                                          dfinal)
    pass1()
    pass2()
    launches_bwd += 1
    return grads


def wkv6_backward(r, k, v, w, u, states, dout, dfinal=None):
    """:func:`wkv6_backward_parts` with ``du`` [H, D] summed over the rows
    and the chunks in a fixed order (deterministic)."""
    *grads, du_part = wkv6_backward_parts(r, k, v, w, u, states, dout,
                                          dfinal)
    return (*grads, du_part.sum(dim=(0, 2)))


def wants_states(*inputs: torch.Tensor) -> bool:
    """Whether a forward on ``inputs`` must write the chunk states: when a
    backward may follow (grad mode on and an input requires grad; also
    under ``torch.func`` transforms) and not under
    :func:`states_discarded`. The first pass of a
    ``models.common.Remat`` block runs without grad mode, so it writes
    none; the recompute in its backward does."""
    return (torch.is_grad_enabled() and not _discard_states
            and any(t.requires_grad for t in inputs))


def _fold(t, dim, n: int):
    """A vmapped tensor (its vmapped dim ``dim``, or None when it is shared)
    with the ``n`` vmapped rows folded into the batch axis B."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def _unfold(t, n: int):
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


def _shared_u(in_dims) -> None:
    if in_dims[4] is not None:
        raise NotImplementedError(
            "the wkv6 kernels' vmap rule folds the vmapped rows into B and "
            "takes one u for all of them; a vmapped u is not supported")


class WKV6(torch.autograd.Function):
    """The kernels as an autograd op, ``apply(r, k, v, w, u,
    save_states)``: the forward returns (out, final state, chunk states),
    the chunk states a non-differentiable output (a zero-stride
    placeholder of their shape unless ``save_states``), saved for the
    backward with r/k/v/w/u. The backward is :class:`WKV6Backward`. Under
    ``torch.func.vmap`` (the spmd engine's batched worker gradients) the
    vmapped rows fold into B: one launch for all of them."""

    @staticmethod
    def forward(r, k, v, w, u, save_states):
        out, final, states = wkv6_forward(r, k, v, w, u,
                                          save_states=save_states)
        if states is None:
            b, s, h, d = r.shape
            states = torch.empty((), dtype=torch.float32,
                                 device=r.device).expand(
                                     b, h, -(-s // CHUNK), d, d)
        return out, final, states

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs[:5], output[2])

    @staticmethod
    def backward(ctx, dout, dfinal, _dstates):
        return (*WKV6Backward.apply(*ctx.saved_tensors, dout, dfinal),
                None)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, save_states):
        _shared_u(in_dims)
        n = info.batch_size
        folded = [_fold(t, d, n) for t, d in zip((r, k, v, w), in_dims)]
        outs = WKV6.apply(*folded, u, save_states)
        return tuple(_unfold(t, n) for t in outs), (0, 0, 0)


def _backward(r, k, v, w, u, states, dout, dfinal):
    """The backward kernels' gradients, dr/dk/dv in the inputs' dtypes,
    with ``du_part`` [B, H, n_chunks, D]."""
    if states.stride(-1) == 0:
        raise RuntimeError(
            "wkv6 backward handed the placeholder of a forward that wrote "
            "no chunk states (no gradient was wanted then, or it ran under "
            "states_discarded())")
    if dout is None:
        dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    dr, dk, dv, dw, du_part = wkv6_backward_parts(r, k, v, w, u, states,
                                                  dout, dfinal)
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du_part


class WKV6Backward(torch.autograd.Function):
    """The backward kernels as a function of (r, k, v, w, u, states, dout,
    dfinal) -> (dr, dk, dv, dw, du [H, D]). Its vmap rule folds the
    vmapped rows into B for one launch and returns ``du`` per vmapped row
    (each row's sum of ``du_part`` over its own B rows and the chunks):
    ``u`` is shared across workers, its gradient is each worker's own. It
    has no backward of its own (no double backward through the kernels)."""

    @staticmethod
    def forward(r, k, v, w, u, states, dout, dfinal):
        *grads, du_part = _backward(r, k, v, w, u, states, dout, dfinal)
        return (*grads, du_part.sum(dim=(0, 2)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the wkv6 backward kernels have no "
                                  "backward (double backward)")

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, states, dout, dfinal):
        _shared_u(in_dims)
        n = info.batch_size
        args = [_fold(t, d, n) for t, d in zip(
            (r, k, v, w, None, states, dout, dfinal), in_dims)]
        *grads, du_part = _backward(*args[:4], u, *args[5:])
        du = du_part.reshape(n, -1, *du_part.shape[1:]).sum(dim=(1, 3))
        return (*(_unfold(g, n) for g in grads), du), (0,) * 5


def wkv6(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' wkv from a zero state: r/k/v/w [B, S, H, D], u [H, D]
    on CUDA -> (out [B, S, H, D] f32, final state [B, H, D, D] f32). The
    chunk states are written when :func:`wants_states` says a backward may
    follow."""
    out, final, _ = WKV6.apply(r, k, v, w, u,
                               wants_states(r, k, v, w, u))
    return out, final
