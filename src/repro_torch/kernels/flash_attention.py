"""Flash attention forward: causal + sliding window + GQA + tanh softcap.
Reference: ``src/repro/kernels/flash_attention.py`` (``flash_attention``,
the TPU kernel this module's CUDA kernel replaces; its public wrapper
``ops.flash_attention_bshd`` takes the ``[B, S, H, D]`` layout used here)
and ``ref.reference_attention`` (the oracle).

``flash_attention(q, k, v)`` with q ``[B, S, H, D]`` and k/v ``[B, S, KV, D]``
returns ``[B, S, H, D]`` in q's dtype: softmax over keys of
``softcap(q k^T / sqrt(D))`` under the mask ``0 <= qpos - kpos`` (causal)
and ``qpos - kpos < window`` (window > 0), KV head ``h // (H // KV)``,
f32 accumulation. Prefill routes every layer's attention through it.

* CUDA tensors go to the hand-written kernels ``csrc/flash_attention.cu``
  (head dims 16, 32, 64, 128 and 256; any S) or raise: bf16 to the tensor-core
  kernels, which read 16-byte rows (base pointers and the b, s, h strides
  of q, k and v must be multiples of 8 elements), f32 to the f32 one. bf16
  at head dim 256 takes the Hopper kernel (wgmma, TMA), whose grid
  :func:`split_plan` lays out: each (q tile, head, batch)'s key band cut
  over a cluster of blocks, their partials merged in the cluster.
* CPU tensors go to :func:`flash_attention_plain`, the same function in
  plain PyTorch (full f32 softmax), which the kernel is held to on the card.
  :func:`flash_attention_split_plain` is the split computation in plain
  PyTorch, for the tests.
* ``use_kernel=False`` selects the plain version on either device.

``launches`` counts kernel launches (and nothing else); a launch recorded
in a CUDA-graph capture counts once per replay (``kernels.counters``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

launches = 0

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_GRID_YZ_MAX = 65535
_TMA_STRIDE_MAX = 1 << 40          # bytes, a TMA tensor map's strides
BQ = BK = 64                       # the kernels' query and key tiles
MAX_CLUSTER = 8                    # blocks a cluster (the portable limit)
# the most clusters of 1, 2, 4 and 8 blocks of the head-dim-256 kernel that
# an H100 80GB HBM3 runs at once (cudaOccupancyMaxActiveClusters; two
# blocks an SM); on the card the wrapper asks the card instead
H100_CAPACITY = (264, 132, 62, 30)
LOG2E = 1.4426950408889634
_lib = None
_capacities = {}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch, f32 math: q [B, S, H, D], k/v [B, S, KV, D] ->
    [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


class SplitPlan(NamedTuple):
    """The bf16 head-dim-256 kernel's grid: each (q tile, head, batch)'s
    key band is cut into ``clusters`` chunks of at most ``tiles`` key
    tiles, one block a chunk, the chunks of one band a thread-block
    cluster; ``blocks`` in all."""
    clusters: int
    tiles: int
    blocks: int


def band_tiles(qt: int, s: int, causal: bool, window: int) -> Tuple[int, int]:
    """(first key tile, number of key tiles) that q tile ``qt`` sees: the
    causal edge on the right, the window on the left, rounded out to whole
    tiles (as the kernels' loop bounds)."""
    q0 = qt * BQ
    k_end = min(q0 + BQ, s) if causal else s
    k_begin = (max(0, q0 - window + 1) // BK) * BK if window > 0 else 0
    return k_begin // BK, -(-(k_end - k_begin) // BK)


@functools.lru_cache(maxsize=256)
def split_plan(s: int, h: int, b: int, causal: bool, window: int,
               capacity: Tuple[int, ...] = H100_CAPACITY) -> SplitPlan:
    """The split for ``s`` rows, ``h`` heads, batch ``b``: the cluster grows
    by twos (to ``MAX_CLUSTER``, and to the widest band's tiles) while the
    card still runs all (q tile, head, batch) clusters at once
    (``capacity[i]``: the most clusters of 2^i blocks at a time); each
    block then takes at most ``ceil(widest band / clusters)`` tiles."""
    nq = -(-s // BQ)
    groups = nq * h * b
    widest = max(band_tiles(qt, s, causal, window)[1] for qt in range(nq))
    c = 1
    while (2 * c <= min(MAX_CLUSTER, widest)
           and groups <= capacity[(2 * c).bit_length() - 1]):
        c *= 2
    return SplitPlan(c, -(-widest // c), groups * c)


def split_chunks(plan: SplitPlan, qt: int, s: int, causal: bool,
                 window: int) -> List[Tuple[int, int]]:
    """Key tiles ``[first, end)`` of each block of q tile ``qt``'s cluster,
    in rank order: rank r takes tiles ``r T .. r T + T - 1`` of the band,
    and a rank past the band an empty range."""
    first, n = band_tiles(qt, s, causal, window)
    t = plan.tiles
    return [(first + min(n, r * t), first + min(n, r * t + t))
            for r in range(plan.clusters)]


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0, softcap: float = 0.0,
                                plan: SplitPlan = None) -> torch.Tensor:
    """The head-dim-256 kernel's split in plain PyTorch, f32 math: the
    scores in log2 units; per chunk of ``plan`` (``split_plan`` by
    default) a partial row max m, sum l and unnormalised output O over the
    chunk's keys (m = -inf, l = 0, O = 0 where the chunk holds none of a
    row's keys); the partials merged in rank order as the cluster merges
    them: O / max(l, 1e-30) with weights 2^(m - max m). For the tests; the
    main path never calls it."""
    b, s, h, d = q.shape
    if plan is None:
        plan = split_plan(s, h, b, causal, window)
    rep = h // k.shape[2]
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    if softcap > 0:
        x = softcap * torch.tanh(x / softcap)
    x = x * LOG2E
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    # the rank whose chunk holds each (query, key); -1 outside the band
    rank = torch.full((s, s), -1, device=q.device)
    for qt in range(-(-s // BQ)):
        for r, (lo, hi) in enumerate(split_chunks(plan, qt, s, causal,
                                                  window)):
            rank[qt * BQ:(qt + 1) * BQ, lo * BK:hi * BK] = r
    parts = []
    for r in range(plan.clusters):
        xr = x.masked_fill(~(mask & (rank == r)), -math.inf)
        m = xr.amax(dim=-1)
        p = torch.exp2(xr - torch.where(m == -math.inf, 0.0, m)[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhqk,bkhd->bhqd", p, vf)))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    top = torch.where(top == -math.inf, 0.0, top)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, o in parts:                       # rank order
        w = torch.exp2(m - top)
        num = num + w[..., None] * o
        den = den + w * l
    out = num / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [B, S, H, D] and k/v one [B, S, KV, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q/k/v must share one of {list(_DTYPE_CODE)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """Causal / windowed / softcapped GQA attention in [B, S, H, D]."""
    _check(q, k, v)
    if not use_kernel or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return _flash_cuda(q, k, v, causal, int(window), float(softcap))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = (
            [i32, vp, vp, vp, vp, i32, i32, i32, i32, i32] + [i64] * 9
            + [i32, i32, ctypes.c_float, ctypes.c_float, i32, i32, vp])
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_cluster_capacity.argtypes = [
            i32, ctypes.POINTER(i32)]
        lib.flash_attention_cluster_capacity.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _capacity(lib, device) -> Tuple[int, ...]:
    """``split_plan``'s capacity on this card, asked once a device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _capacities:
        caps = []
        with torch.cuda.device(idx):
            for c in (1, 2, 4, 8):
                n = ctypes.c_int(0)
                err = lib.flash_attention_cluster_capacity(c, ctypes.byref(n))
                if err:
                    raise RuntimeError(
                        f"flash_attention cluster capacity: "
                        f"{lib.flash_attention_error_string(err).decode()}")
                caps.append(n.value)
        _capacities[idx] = tuple(caps)
    return _capacities[idx]


def _flash_cuda(q, k, v, causal: bool, window: int, softcap: float,
                capacity: Tuple[int, ...] = None) -> torch.Tensor:
    """The kernel call; ``capacity`` (the tests' hook) replaces the card's
    in ``split_plan`` at head dim 256."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernel runs on CUDA tensors, "
                         f"not {q.device}")
    b, s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes "
                         f"{_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous last (head_dim) axis")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))
            for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel reads 16-byte rows: the base "
                         "pointers of q, k and v must be 16-byte aligned and "
                         "their b, s and h strides multiples of 8 elements")
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel grid's "
                         f"{_GRID_YZ_MAX}")
    hopper = q.dtype == torch.bfloat16 and d == 256
    if hopper and any(t.stride(i) * t.element_size() >= _TMA_STRIDE_MAX
                      for t in (q, k, v) for i in range(3)):
        raise ValueError("the head_dim 256 kernel reads q/k/v through TMA "
                         "tensor maps, whose b, s and h strides must stay "
                         "below 2^40 bytes")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _load()
    split = (1, 1)
    if hopper:
        split = split_plan(s, h, b, causal, window,
                           capacity or _capacity(lib, q.device))[:2]
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    err = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, k.shape[2], d, *strides, int(causal), window,
        1.0 / math.sqrt(d), softcap, *split, _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out
