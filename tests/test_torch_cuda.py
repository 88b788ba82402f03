"""The port's CUDA kernels and serve path on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one (decided in the
``cuda_device`` fixture, at run time). The file imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

* Each kernel against its plain version on the same CUDA tensors: page
  gather (fp copy and int8 dequant, f32 and bf16 out) bit-exact; flash
  attention on unit-variance q/k/v (the scale qk-norm gives: scores with
  std ~1) at atol/rtol 1e-4 in f32 (summation order only) and atol 4e-3 /
  rtol 8e-3 in bf16 (one output rounding, < 2^-7 relative), over ragged S,
  window and a softcap of 2 that binds, head dims 16 to 256. Each call
  adds exactly one launch. The bf16 tensor-core kernels also at every head
  dim (16, 32, 64, 128: mma.sync; 256: the wgmma / TMA kernel with the key
  band split over a cluster), S in {1, 15, 64, 65, 100, 512, 1000} and GQA
  ratios 1, 2, 4, with
  window 64 + softcap 2 and with ``causal=False``; on bf16 slices of one
  packed projection; and a bf16 view whose rows are not 16-byte aligned
  raises ``ValueError``. At head dim 256 besides: S in {63, 129} at batch 2
  and GQA 1 / 2 / 4, S 4096 non-causal (the card's plan, one block looping
  over 64 key tiles, and a capacity that forces clusters of 8 blocks of 8
  tiles each), strided views, and two calls on the same inputs bit-equal.
* The card's ``ServeEngine`` (kernels) gives the CPU port's greedy tokens
  (which ``tests/test_torch_serve.py`` holds to the JAX engine).
* ``backup_reduce``: the kernel equals its plain version bit for bit over
  W in {2, 3, 8} (and 1, below), P in {1, 3, 4097, 65536}, masks all-zero, all-one and
  mixed, on both the float4 path and the scalar path (ragged P, a base
  off 16 bytes, a bucket sliced out of a wider stack); it refuses CPU
  tensors and counts one launch per call.
* Two training steps of the smoke model on the card (spmd backend, the
  kernel) against the same two steps of the CPU port: atol 1e-5 (f32).
* The wkv6 kernels (``rwkv6_scan``) against the plain twin on the same
  CUDA tensors, D in {16, 32, 64}, S in {1, 16, 40, 256}, f32 and bf16
  r/k/v: the forward's f32 output within atol 1e-4 x max|out|; the
  backward's f32 gradients (dr, dk, dv, dw, du; with a final-state
  gradient too) against the plain twin's autograd within 1e-4 x max|grad|
  (dw 5e-4: d log w / w amplifies rounding where w is small), also at
  S in {17, 1000} (a ragged second chunk; 63 chunks), and two backward
  calls on the same inputs give bit-equal gradients; through
  autograd one forward and one backward launch, gradients in the inputs'
  dtypes; a CUDA call the kernels cannot take raises. The forward without
  chunk states gives the bit-equal output and final state, the chunk
  states equal the plain twin's (the final states of the whole-chunk
  prefixes) within 1e-5 x max|S|, repeated forwards are bit-equal, rows
  not 16-byte aligned are refused, and the forward agrees with the plain
  twin on every visible card.
* ``RWKVLM`` (rwkv6 smoke, f32) on the card, through the kernels, against
  the CPU port: logits and per-token loss within atol 1e-5, gradients
  within atol 1e-5, with remat "full" (2 forward launches per layer, one
  of them writing chunk states); and remat "full" against "none" on the
  card: the same launches of the backward, one state-writing forward per
  layer in both, loss and gradients within atol 1e-5.
* CUDA graphs: the chunked trainer (one captured step replayed) against
  the eager per-step loop, qwen3 and rwkv6 smoke, ``sim`` and ``spmd``:
  parameters, optimizer state, EMA and metrics bit-equal; a graph
  captured before ``init_state`` or ``reset_optimizer_state`` is captured
  anew, never replayed on the old tensors, and a restore keeps it; the
  launch counters count replays (the eager loop's counts); graph decode
  gives the eager decode's greedy tokens, fp and int8, with one capture.
* The device straggler backend: a chunk's batches, arrivals and masks
  drawn on the card, then the step graph replayed, against the same
  inputs through the eager step (bit-equal state and metrics), and chunks
  of 4 + 4 against one of 8 (bit-equal). A rescale inside a graph run
  (crashes past the backup pool, 8 -> 4 workers on the spmd engine): the
  old graph is released and a new one captured, the run bit-equal to the
  eager per-step run on the card, the recovery log the CPU port's.
* The event regimes' chunked path (one captured graph per branch: an
  arrival that applies the update, one that only buffers) against the
  per-arrival loop on the card: async, softsync and staleness on qwen3
  smoke, async on rwkv6 smoke, parameters, optimizer state, EMA, metrics
  and the workers' read copies bit-equal; every worker arrives although
  the capture saw one (the worker index is a device tensor); each branch
  replays as often as the plan names it; the event run on the card agrees
  with the CPU port (atol 1e-5, f32).
* The spmd engine's batched worker gradients on the card: through the
  wkv6 kernels' ``vmap`` rule (rwkv6 smoke, f32, remat "full") the
  gradients of 4 workers equal one worker at a time (rtol 1e-4, atol
  1e-5) with one forward pair and one backward per layer for all of them;
  ``grad_batch`` 0 and 2 through the CUDA graph bit-equal to the eager
  loop at the same ``grad_batch``. With at least 2 cards, 2 NCCL ranks
  (``mesh.spawn``; the all-reduce captured in the step graph) give
  bit-identical parameters on both ranks, within atol 1e-5 of one card
  holding every worker.
* Tensor parallelism at mesh 1 x 2 on the card: 2 NCCL ranks with 2
  cards (chunks of 3, the model group's all-reduces captured), else 2
  gloo ranks sharing the one card (chunk 1); the parameters gathered over
  the model group within atol 1e-5 of one card, the replicated leaves
  bit-identical on both ranks.
* Telemetry and the router: a traced, metered graph run (sim and spmd)
  bit-equal to the untraced one, its chunk spans holding their waits;
  three router replicas each capture one decode graph over their own pool
  and serve the eager engine's tokens through a crash; ``backup_reduce``
  on one worker's ``[1, P]`` (a rank of a shrunk data axis) equals its
  plain version.
* The MoE family (qwen2-moe smoke, f32, capacity 8 and 1.25): the card's
  paged engine (graph and eager decode) and ``greedy_generate`` give the
  CPU port's tokens, fp and int8; its batched graph chunks equal the
  eager steps at ``grad_batch`` 0 and 2 (above, with qwen3 and rwkv6).
* Tensor-parallel decode (``ServeEngine(mesh_model=2)``, NCCL with 2
  cards, gloo sharing one) serves the one-card engine's tokens, fp and
  int8 pools; the toy path (``greedy_generate``) on the card gives the CPU
  port's tokens; RWKV ``prefill`` through the wkv6 kernel matches the
  stepped decode's carried state (atol 1e-4, f32).
* The hybrid and audio families (f32 smoke): hymba's and whisper's toy
  paths (whisper's cross cache primed from frames) give the CPU port's
  tokens, fp and int8; hymba's batched graph chunks equal its eager steps
  at ``grad_batch`` 0 and 2 (above); whisper's async run through a frames
  ``batch_fn`` replays its event graphs bit-equal to the per-arrival loop
  and agrees with the CPU port; the blocked attention core and the SSD's
  chunked and scan forms on the card equal the CPU's (atol 1e-5).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import gc
import weakref

import numpy as np

from repro_torch import configs
from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                 ExecutionConfig, OptimizerConfig,
                                 ShapeConfig, TrainConfig)
from repro_torch.kernels import backup_reduce as treduce
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import page_gather as tgather
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.models import RWKVLM, TransformerLM
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from repro_torch.train.loop import Trainer
from torch_parity import (cuda_device, qkv_inputs,  # noqa: F401 (fixture)
                          ragged_table, random_pool)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("quantized,out_dtype", [
    (False, torch.float32), (False, torch.bfloat16),
    (True, torch.float32), (True, torch.bfloat16)])
def test_gather_kernel_matches_plain(cuda_device, quantized, out_dtype):
    b, maxp, ps, kv, hd = 8, 6, 16, 8, 128
    num_pages = b * maxp + 1
    pool, scales = random_pool(5, (num_pages, ps, kv, hd), quantized)
    pool_t = torch.from_numpy(pool).to(cuda_device)
    if not quantized:
        pool_t = pool_t.to(out_dtype)
    sc = None if scales is None else torch.from_numpy(scales).to(cuda_device)
    tbl = torch.from_numpy(ragged_table(6, b, maxp, num_pages)).to(cuda_device)
    before = tgather.launches
    got = tgather.gather_pages(pool_t, tbl, sc, out_dtype=out_dtype)
    want = tgather.gather_pages(pool_t, tbl, sc, out_dtype=out_dtype,
                                use_kernel=False)
    torch.cuda.synchronize()
    assert tgather.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 4e-3, 8e-3)])
@pytest.mark.parametrize("s,d,window,softcap", [(16, 128, 0, 0.0),
                                                (100, 16, 0, 0.0),
                                                (77, 64, 0, 0.0),
                                                (512, 128, 0, 2.0),
                                                (512, 128, 64, 2.0),
                                                (77, 256, 0, 0.0),
                                                (512, 256, 512, 2.0)])
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, rtol, s, d,
                                   window, softcap):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in qkv_inputs(7, 1, s, 16, 8, d, scale=1.0))
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, window=window, softcap=softcap)
    want = tflash.flash_attention(q, k, v, window=window, softcap=softcap,
                                  use_kernel=False)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_flash_kernel_reads_strided_inputs(cuda_device):
    """q/k/v as slices of one packed projection (non-contiguous rows)."""
    qkv = torch.randn((2, 40, 16 + 8 + 8, 32), device=cuda_device)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    got = tflash.flash_attention(q, k, v)
    want = tflash.flash_attention(q, k, v, use_kernel=False)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _flash_bf16_case(device, s, d, ratio, causal, window, softcap):
    h = 4
    q, k, v = (torch.from_numpy(a).to(device, torch.bfloat16)
               for a in qkv_inputs(s + d, 2, s, h, h // ratio, d, scale=1.0))
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    want = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, use_kernel=False)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=8e-3)


FLASH_S = [1, 15, 64, 65, 100, 512, 1000]


@pytest.mark.parametrize("ratio", [1, 2, 4])
@pytest.mark.parametrize("s", FLASH_S)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_bf16_tensor_core_kernel_matches_plain(cuda_device, d, s,
                                                     ratio):
    _flash_bf16_case(cuda_device, s, d, ratio, True, 0, 0.0)


@pytest.mark.parametrize("causal,window,softcap", [(True, 64, 2.0),
                                                   (False, 0, 0.0)])
@pytest.mark.parametrize("s", FLASH_S)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_bf16_tensor_core_kernel_window_softcap_noncausal(
        cuda_device, d, s, causal, window, softcap):
    _flash_bf16_case(cuda_device, s, d, 2, causal, window, softcap)


@pytest.mark.parametrize("ratio", [1, 2, 4])
@pytest.mark.parametrize("s", [63, 129])
def test_flash_d256_split_kernel_matches_plain(cuda_device, s, ratio):
    """Head dim 256 at batch 2: a ragged last q tile and bands split over
    clusters of 2 blocks."""
    _flash_bf16_case(cuda_device, s, 256, ratio, True, 0, 0.0)


# a capacity that splits every band 8 ways
SPLIT8 = (10 ** 6,) * 4


@pytest.mark.parametrize("capacity,plan", [(None, (1, 64)),
                                           (SPLIT8, (8, 8))])
def test_flash_d256_long_noncausal_loops_through_the_ring(cuda_device,
                                                          capacity, plan):
    """S 4096, non-causal: each block streams T key tiles through its K/V
    tiles; with clusters of 8, each block takes 8 tiles of a 64-tile band
    and the merge sums 8 partials."""
    s = 4096
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in qkv_inputs(41, 1, s, 4, 1, 256, scale=1.0))
    cap = capacity or tflash._capacity(tflash._load(), q.device)
    assert tuple(tflash.split_plan(s, 4, 1, False, 0, cap))[:2] == plan
    before = tflash.launches
    got = tflash._flash_cuda(q, k, v, False, 0, 0.0, capacity=capacity)
    want = tflash.flash_attention(q, k, v, causal=False, use_kernel=False)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=8e-3)


def test_flash_d256_reads_strided_inputs(cuda_device):
    """bf16 q/k/v at head dim 256 as slices of one packed projection: the
    tensor maps read the b, s and h strides as given."""
    qkv = torch.randn((2, 77, 4 + 2 + 2, 256), device=cuda_device).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    for window, softcap in ((0, 0.0), (40, 2.0)):
        got = tflash.flash_attention(q, k, v, window=window, softcap=softcap)
        want = tflash.flash_attention(q, k, v, window=window,
                                      softcap=softcap, use_kernel=False)
        torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                                   rtol=8e-3)


@pytest.mark.parametrize("s", [129, 512])
def test_flash_d256_repeated_calls_are_bit_equal(cuda_device, s):
    """The cluster merges its partials in rank order, without atomics."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in qkv_inputs(43, 1, s, 4, 1, 256, scale=1.0))
    before = tflash.launches
    first = tflash.flash_attention(q, k, v, window=512)
    second = tflash.flash_attention(q, k, v, window=512)
    torch.cuda.synchronize()
    assert tflash.launches == before + 2
    assert torch.equal(first, second)


def test_flash_bf16_reads_strided_inputs(cuda_device):
    """bf16 q/k/v as slices of one packed projection (rows 16-byte
    aligned, not contiguous)."""
    qkv = torch.randn((2, 40, 16 + 8 + 8, 32), device=cuda_device).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    got = tflash.flash_attention(q, k, v)
    want = tflash.flash_attention(q, k, v, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=8e-3)


def test_flash_bf16_refuses_unaligned_rows(cuda_device):
    flat = torch.randn(1 + 2 * 16 * 4 * 32, device=cuda_device).to(
        torch.bfloat16)
    q = flat[1:].view(2, 16, 4, 32)          # base 2 bytes off 16
    before = tflash.launches
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, q, q)
    wide = torch.randn((2, 16, 4, 36), device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tflash.flash_attention(*(wide[..., :32],) * 3)   # h stride 36
    assert tflash.launches == before


def test_card_engine_matches_cpu_engine(cuda_device):
    cfg = configs.get_smoke_config("qwen3-0.6b")
    cpu_model = TransformerLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(4))
    gpu_model = TransformerLM(cfg, device=cuda_device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
              clock="virtual")
    tc = TraceConfig(num_requests=6, rate=100.0, prompt_len_min=2,
                     prompt_len_max=12, max_new_min=2, max_new_max=8,
                     vocab=cfg.vocab_size, seed=4)
    for int8 in (False, True):
        before = (tgather.launches, tflash.launches)
        cpu = ServeEngine(cfg, cpu_model, device="cpu", cache_int8=int8,
                          **kw).run(make_trace(tc))
        gpu = ServeEngine(cfg, gpu_model, cache_int8=int8,
                          **kw).run(make_trace(tc))
        assert gpu.tokens_by_rid() == cpu.tokens_by_rid()
        assert tgather.launches > before[0] and tflash.launches > before[1]


def _stack(w, p, kind, seed, device):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(w, p).astype(np.float32)).to(device)
    mask = {"zeros": np.zeros(w), "ones": np.ones(w),
            "mixed": (np.arange(w) % 3 != 1)}[kind].astype(np.float32)
    return g, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("kind", ["zeros", "ones", "mixed"])
@pytest.mark.parametrize("w", [2, 3, 8])
@pytest.mark.parametrize("p", [1, 3, 4097, 65536])
def test_backup_reduce_kernel_bit_equal_plain(cuda_device, w, p, kind):
    g, m = _stack(w, p, kind, w * p, cuda_device)
    before = treduce.launches
    got = treduce.backup_reduce(g, m, 6)
    want = treduce.backup_reduce_plain(g, m, 6)
    torch.cuda.synchronize()
    assert treduce.launches == before + 1
    assert treduce.uses_vec4(g, got) == (p % 4 == 0)
    assert torch.equal(got, want)


def test_backup_reduce_scalar_path_on_unaligned_and_strided(cuda_device):
    g, m = _stack(5, 4097, "mixed", 1, cuda_device)
    off = g[:, 1:]                    # P = 4096 but the base is 4 bytes off
    got = treduce.backup_reduce(off, m, 3)
    assert not treduce.uses_vec4(off, got)
    assert torch.equal(got, treduce.backup_reduce_plain(off, m, 3))
    wide, _ = _stack(5, 4096 * 3, "ones", 2, cuda_device)
    bucket = wide[:, 4096:8192]       # row stride 12288, aligned: float4
    out = torch.empty(4096, device=cuda_device)
    treduce.backup_reduce(bucket, m, 3, out=out)
    assert treduce.uses_vec4(bucket, out)
    assert torch.equal(out, treduce.backup_reduce_plain(bucket, m, 3))


def test_backup_reduce_refuses_cpu(cuda_device):
    g, m = _stack(3, 8, "ones", 0, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        treduce.backup_reduce(g, m, 2)


def _train_cfg():
    model = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"),
                                remat="full")
    return TrainConfig(
        model=model, shape=ShapeConfig("t", 16, 2 * 8, "train"),
        aggregation=AggregationConfig(strategy="backup", num_workers=6,
                                      backup_workers=2),
        optimizer=OptimizerConfig(name="rmsprop_momentum",
                                  learning_rate=0.005, eps=1e-3,
                                  ema_decay=0.99),
        checkpoint=CheckpointConfig(every_steps=0),
        execution=ExecutionConfig(backend="spmd", grad_batch=1),
        seed=0, total_steps=2, log_every=1)


def test_train_steps_on_card_match_cpu(cuda_device):
    cfg = _train_cfg()
    cpu = Trainer(cfg, device="cpu")
    cpu.init_state()
    card = Trainer(cfg, device=cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    card.reset_optimizer_state()
    before = treduce.launches
    rc, rg = cpu.run(2), card.run(2)
    assert treduce.launches == before + 2
    assert [m["selected"] for m in rg.metrics] == \
        [m["selected"] for m in rc.metrics]
    np.testing.assert_allclose([m["loss"] for m in rg.metrics],
                               [m["loss"] for m in rc.metrics], rtol=1e-5)
    for k, v in rc.params.items():
        np.testing.assert_allclose(rg.params[k].detach().cpu().numpy(),
                                   v.detach().numpy(), atol=1e-5, err_msg=k)


def _wkv_inputs(b, s, h, d, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    r, k, v = ((0.5 * rng.randn(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(np.clip(rng.randn(b, s, h, d) - 1.0, -8.0, 1.6)))
    u = 0.5 * rng.randn(h, d)
    return ([torch.from_numpy(t).to(device, dtype) for t in (r, k, v)]
            + [torch.from_numpy(t.astype(np.float32)).to(device)
               for t in (w, u)])


WKV_TOL = dict(dr=1e-4, dk=1e-4, dv=1e-4, dw=5e-4, du=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 16, 40, 256])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv_forward_matches_plain(cuda_device, d, s, dtype):
    args = _wkv_inputs(2, s, 3, d, dtype, cuda_device, seed=s + d)
    before = twkv.launches_fwd
    out, final, states = twkv.wkv6_forward(*args)
    want, want_final = twkv.wkv6_plain(*args)
    torch.cuda.synchronize()
    assert twkv.launches_fwd == before + 1
    assert out.dtype == torch.float32 and states.shape == (2, 3, -(-s // 16),
                                                           d, d)
    for got, ref in ((out, want), (final, want_final)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,dfinal", [(1, 64, False), (16, 16, True),
                                        (40, 32, False), (256, 64, True)])
def test_wkv_backward_matches_plain_autograd(cuda_device, s, d, dfinal,
                                             dtype):
    args = _wkv_inputs(2, s, 3, d, dtype, cuda_device, seed=s)
    rng = np.random.RandomState(1)
    dout = torch.from_numpy(rng.randn(2, s, 3, d).astype(np.float32)).to(
        cuda_device)
    dfin = torch.from_numpy(rng.randn(2, 3, d, d).astype(np.float32)).to(
        cuda_device) if dfinal else None
    _, _, states = twkv.wkv6_forward(*args)
    before = twkv.launches_bwd
    got = twkv.wkv6_backward(*args, states, dout, dfin)
    assert twkv.launches_bwd == before + 1
    leaves = [a.float().requires_grad_() for a in args]
    out, final = twkv.wkv6_plain(*leaves)
    loss = (out * dout).sum() + ((final * dfin).sum() if dfinal else 0.0)
    want = torch.autograd.grad(loss, leaves)
    for (name, tol), g, ref in zip(WKV_TOL.items(), got, want):
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=tol * ref.abs().max().item(),
                                   msg=name)


def _wkv_backward_case(device, s, d, dfinal, dtype):
    args = _wkv_inputs(2, s, 3, d, dtype, device, seed=s + 1)
    rng = np.random.RandomState(2)
    dout = torch.from_numpy(rng.randn(2, s, 3, d).astype(np.float32)).to(
        device)
    dfin = torch.from_numpy(rng.randn(2, 3, d, d).astype(np.float32)).to(
        device) if dfinal else None
    _, _, states = twkv.wkv6_forward(*args)
    return args, states, dout, dfin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dfinal", [False, True])
@pytest.mark.parametrize("s", [17, 1000])
def test_wkv_two_pass_backward_long_and_ragged(cuda_device, s, dfinal,
                                               dtype):
    args, states, dout, dfin = _wkv_backward_case(cuda_device, s, 64, dfinal,
                                                  dtype)
    before = twkv.launches_bwd
    got = twkv.wkv6_backward(*args, states, dout, dfin)
    assert twkv.launches_bwd == before + 1
    leaves = [a.float().requires_grad_() for a in args]
    out, final = twkv.wkv6_plain(*leaves)
    loss = (out * dout).sum() + ((final * dfin).sum() if dfinal else 0.0)
    want = torch.autograd.grad(loss, leaves)
    for (name, tol), g, ref in zip(WKV_TOL.items(), got, want):
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=tol * ref.abs().max().item(),
                                   msg=name)


def test_wkv_backward_is_deterministic(cuda_device):
    args, states, dout, dfin = _wkv_backward_case(cuda_device, 1000, 64,
                                                  True, torch.bfloat16)
    first = twkv.wkv6_backward(*args, states, dout, dfin)
    second = twkv.wkv6_backward(*args, states, dout, dfin)
    for name, a, b in zip(WKV_TOL, first, second):
        assert torch.equal(a, b), name


def test_wkv_autograd_launches_and_dtypes(cuda_device):
    args = [a.requires_grad_() for a in
            _wkv_inputs(1, 40, 2, 32, torch.bfloat16, cuda_device)]
    before = (twkv.launches_fwd, twkv.launches_bwd)
    out, _ = twkv.wkv6(*args)
    out.sum().backward()
    assert (twkv.launches_fwd, twkv.launches_bwd) == (before[0] + 1,
                                                      before[1] + 1)
    assert [a.grad.dtype for a in args] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2
    with pytest.raises(ValueError, match="head dim"):
        twkv.wkv6(*_wkv_inputs(1, 8, 1, 8, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="w and u must be f32"):
        a = _wkv_inputs(1, 8, 1, 16, torch.float32, cuda_device)
        twkv.wkv6(*a[:3], a[3].double(), a[4])


def _plain_states(args):
    """Every chunk's incoming state from the plain twin: the final state
    of each whole-chunk prefix (zero for the first chunk)."""
    b, s, h, d = args[0].shape
    zero = torch.zeros((b, h, d, d), device=args[0].device)
    return torch.stack([zero] + [
        twkv.wkv6_plain(*(a[:, :twkv.CHUNK * c] for a in args[:4]),
                        args[4])[1]
        for c in range(1, -(-s // twkv.CHUNK))], dim=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 40, 256])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv_forward_without_states_is_bit_equal(cuda_device, d, s, dtype):
    args = _wkv_inputs(2, s, 3, d, dtype, cuda_device, seed=s + 2 * d)
    before = (twkv.launches_fwd, twkv.launches_fwd_states)
    out, final, states = twkv.wkv6_forward(*args)
    bare_out, bare_final, none = twkv.wkv6_forward(*args, save_states=False)
    torch.cuda.synchronize()
    assert none is None and states is not None
    assert (twkv.launches_fwd, twkv.launches_fwd_states) == (before[0] + 2,
                                                             before[1] + 1)
    assert torch.equal(out, bare_out) and torch.equal(final, bare_final)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 17, 40, 256])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv_forward_states_match_plain(cuda_device, d, s, dtype):
    args = _wkv_inputs(2, s, 3, d, dtype, cuda_device, seed=3 * s + d)
    _, _, states = twkv.wkv6_forward(*args)
    want = _plain_states(args)
    torch.testing.assert_close(states, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_wkv_forward_refuses_unaligned_rows(cuda_device):
    """Rows that do not start 16-byte aligned (r/k/v/w sliced out of wider
    rows, or a base off 16 bytes) are refused, with nothing launched."""
    args = _wkv_inputs(2, 40, 3, 32, torch.bfloat16, cuda_device, seed=6)
    wide = [torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in args[:4]]
    assert any(t.stride(2) * t.element_size() % 16 for t in wide)
    flat = torch.zeros(1 + args[0].numel(), dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(args[0].shape)           # base 2 bytes off 16
    before = (twkv.launches_fwd, twkv.launches_fwd_states)
    with pytest.raises(ValueError, match="16-byte"):
        twkv.wkv6_forward(*wide, args[4])
    with pytest.raises(ValueError, match="16-byte"):
        twkv.wkv6_forward(shifted, *args[1:])
    assert (twkv.launches_fwd, twkv.launches_fwd_states) == before


def test_wkv_forward_on_every_card(cuda_device):
    """The forward asks for its dynamic shared memory on each device it
    launches on: on every visible card it agrees with the plain twin."""
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            args = _wkv_inputs(2, 40, 3, 64, torch.bfloat16, dev, seed=i)
            out, final, _ = twkv.wkv6_forward(*args)
            want, want_final = twkv.wkv6_plain(*args)
        for got, ref in ((out, want), (final, want_final)):
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-4 * ref.abs().max().item())


def test_wkv_forward_is_deterministic(cuda_device):
    args = _wkv_inputs(2, 1000, 3, 64, torch.bfloat16, cuda_device, seed=4)
    first = twkv.wkv6_forward(*args)
    second = twkv.wkv6_forward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rwkv_model_on_card_matches_cpu(cuda_device):
    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6-1.6b"),
                              remat="full")
    cpu = RWKVLM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    card = RWKVLM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (2, 40)),
             "labels": rng.randint(0, cfg.vocab_size, (2, 40))}
    with torch.no_grad():
        np.testing.assert_allclose(
            card(torch.from_numpy(batch["tokens"]).to(cuda_device)).cpu(),
            cpu(torch.from_numpy(batch["tokens"])), atol=1e-5)
    before = (twkv.launches_fwd, twkv.launches_bwd)
    losses = {}
    for tag, model in (("cpu", cpu), ("card", card)):
        per_tok, _ = model.per_token_loss(batch)
        per_tok.mean().backward()
        losses[tag] = per_tok.detach().cpu().numpy()
    layers = cfg.num_layers
    assert (twkv.launches_fwd, twkv.launches_bwd) == (before[0] + 2 * layers,
                                                      before[1] + layers)
    np.testing.assert_allclose(losses["card"], losses["cpu"], atol=1e-5)
    grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   grads[name].grad.numpy(), atol=1e-5,
                                   err_msg=name)


def test_rwkv_model_remat_writes_states_once_per_layer(cuda_device):
    cfg = configs.get_smoke_config("rwkv6-1.6b")
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (2, 40)),
             "labels": rng.randint(0, cfg.vocab_size, (2, 40))}
    weights, runs = None, {}
    for remat in ("none", "full"):
        model = RWKVLM(dataclasses.replace(cfg, remat=remat),
                       device=cuda_device)
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        before = (twkv.launches_fwd, twkv.launches_fwd_states,
                  twkv.launches_bwd)
        per_tok, _ = model.per_token_loss(batch)
        per_tok.mean().backward()
        torch.cuda.synchronize()
        after = (twkv.launches_fwd, twkv.launches_fwd_states,
                 twkv.launches_bwd)
        runs[remat] = (per_tok.detach().cpu().numpy(),
                       {n: p.grad.cpu().numpy()
                        for n, p in model.named_parameters()},
                       tuple(a - b for a, b in zip(after, before)))
    layers = cfg.num_layers
    assert runs["none"][2] == (layers, layers, layers)
    assert runs["full"][2] == (2 * layers, layers, layers)
    np.testing.assert_allclose(runs["full"][0], runs["none"][0], atol=1e-5)
    for name, g in runs["full"][1].items():
        np.testing.assert_allclose(g, runs["none"][1][name], atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# CUDA graphs: the chunked trainer and graph decode
# ---------------------------------------------------------------------------


def _chunk_cfg(arch, backend, chunk, directory="", every=0, optimizer=None):
    return dataclasses.replace(
        _train_cfg(), model=dataclasses.replace(
            configs.get_smoke_config(arch), remat="full"),
        optimizer=optimizer or OptimizerConfig(
            name="momentum", learning_rate=0.05, scale_lr_with_workers=False,
            ema_decay=0.99),
        execution=ExecutionConfig(backend=backend, grad_batch=1),
        checkpoint=CheckpointConfig(directory=directory, every_steps=every),
        chunk_size=chunk)


def _state_equal(a, b):
    """Params, optimizer state and EMA of two trainers, bit for bit."""
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    for s, sub in a.opt_state.items():
        for k, v in sub.items():
            assert torch.equal(v, b.opt_state[s][k]), (s, k)
    for k, v in a.ema.items():
        assert torch.equal(v, b.ema[k]), k


@pytest.mark.parametrize("backend", ["sim", "spmd"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_graph_chunks_match_eager_steps(cuda_device, arch, backend):
    """5 steps at chunk 3 (chunks of 3 and 2; one capture, then replays)
    against the eager per-step loop: bit-equal state and metrics."""
    runs = {}
    for chunk in (1, 3):
        tr = Trainer(_chunk_cfg(arch, backend, chunk), device=cuda_device)
        tr.init_state()
        runs[chunk] = (tr, tr.run(5))
    (eager, re), (graph, rg) = runs[1], runs[3]
    assert rg.metrics == re.metrics and rg.sim_time == re.sim_time
    _state_equal(eager, graph)
    g = graph.chunk_step.graph
    assert (g.captures, g.replays) == (1, 4)


def test_graph_recaptures_when_the_state_is_rebuilt(cuda_device):
    """init_state and reset_optimizer_state build new tensors: the next
    chunk captures anew instead of updating the old ones; a restore copies
    in place and keeps the graph. Each stage equals the eager loop's."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        trainers = {}
        for chunk in (1, 2):
            tr = Trainer(_chunk_cfg("qwen3-0.6b", "spmd", chunk,
                                    directory=f"{d}/{chunk}", every=2),
                         device=cuda_device)
            tr.init_state()
            tr.run(2)
            tr.init_state(seed=5)
            tr.run(2)
            tr.reset_optimizer_state()
            tr.run(2)
            tr.restore_checkpoint(4)
            tr.run(2)
            trainers[chunk] = tr
        _state_equal(trainers[1], trainers[2])
        assert trainers[1].metrics == trainers[2].metrics
        assert trainers[2].chunk_step.graph.captures == 3


def test_launch_counters_count_replays(cuda_device):
    """Through the graph each wrapper's count is what the card ran: the
    same counts as the eager loop (rwkv6 smoke, spmd, 4 workers)."""
    cfg = dataclasses.replace(
        _chunk_cfg("rwkv6-1.6b", "spmd", 3),
        aggregation=AggregationConfig(strategy="backup", num_workers=3,
                                      backup_workers=1))
    counts = {}
    for chunk in (1, 3):
        tr = Trainer(dataclasses.replace(cfg, chunk_size=chunk),
                     device=cuda_device)
        tr.init_state()
        before = (twkv.launches_fwd, twkv.launches_fwd_states,
                  twkv.launches_bwd, treduce.launches)
        tr.run(3)
        torch.cuda.synchronize()
        counts[chunk] = tuple(a - b for a, b in zip(
            (twkv.launches_fwd, twkv.launches_fwd_states, twkv.launches_bwd,
             treduce.launches), before))
    per_step = cfg.model.num_layers * 4
    assert counts[3] == counts[1] == (2 * per_step * 3, per_step * 3,
                                      per_step * 3, 3)


@pytest.mark.parametrize("int8", [False, True])
def test_graph_decode_matches_eager(cuda_device, int8):
    """Graph decode (the default on the card) gives the eager decode's
    greedy tokens and gather launches; one capture serves two runs."""
    cfg = configs.get_smoke_config("qwen3-0.6b")
    model = TransformerLM(cfg, device=cuda_device,
                          generator=torch.Generator(
                              device=cuda_device).manual_seed(6))
    kw = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
              clock="virtual", cache_int8=int8)
    trace = make_trace(TraceConfig(
        num_requests=6, rate=100.0, prompt_len_min=2, prompt_len_max=12,
        max_new_min=2, max_new_max=8, vocab=cfg.vocab_size, seed=6))
    eager = ServeEngine(cfg, model, decode_graph=False, **kw)
    graph = ServeEngine(cfg, model, **kw)
    out = {}
    for tag, eng in (("eager", eager), ("graph", graph)):
        before = tgather.launches
        report = eng.run(trace)
        torch.cuda.synchronize()
        out[tag] = (report.tokens_by_rid(), tgather.launches - before)
    assert out["graph"] == out["eager"]
    assert graph.decode_compiles == 1
    assert graph.run(trace).tokens_by_rid() == out["eager"][0]
    assert graph.decode_compiles == 1


# ---------------------------------------------------------------------------
# The event regimes' CUDA graphs
# ---------------------------------------------------------------------------

_EVENT_AGG = {
    "async": AggregationConfig(strategy="async", num_workers=4),
    "softsync": AggregationConfig(strategy="softsync", num_workers=4,
                                  softsync_c=3),
    "staleness": AggregationConfig(strategy="staleness", num_workers=1,
                                   staleness_tau=2, staleness_ramp_steps=3,
                                   staleness_jitter=1),
}


def _event_cfg(arch, name, chunk):
    return dataclasses.replace(
        _chunk_cfg(arch, "sim", chunk), aggregation=_EVENT_AGG[name],
        shape=ShapeConfig("t", 16, 8, "train"))


def _event_runs(device, arch, name, updates=6):
    runs = {}
    for chunk in (1, 4):
        tr = Trainer(_event_cfg(arch, name, chunk), device=device)
        tr.init_state()
        runs[chunk] = (tr, tr.run(updates))
    return runs


@pytest.mark.parametrize("arch,name", [("qwen3-0.6b", "async"),
                                       ("qwen3-0.6b", "softsync"),
                                       ("qwen3-0.6b", "staleness"),
                                       ("rwkv6-1.6b", "async")])
def test_event_graphs_match_per_arrival(cuda_device, arch, name):
    """6 updates at chunk 4 (chunks of 4 and 2) against the per-arrival
    loop: bit-equal state, read copies and metrics; every worker arrived,
    though each graph was captured on one worker's arrival."""
    runs = _event_runs(cuda_device, arch, name)
    (eager, re), (graph, rg) = runs[1], runs[4]
    assert rg.metrics == re.metrics and rg.sim_time == re.sim_time
    assert rg.arrivals == re.arrivals
    _state_equal(eager, graph)
    if eager.strategy.uses_clock:
        assert (graph._draws > 0).all()          # every worker arrived
        for w in range(eager.strategy.total_workers):
            for k, v in eager._reads.read(w).items():
                assert torch.equal(graph._workers_stacked[k][w], v), (w, k)
    g = graph._event_chunk.graphs
    assert sum(x.captures for x in g.values()) == (1 if name == "async"
                                                   else 2)
    assert sum(x.captures + x.replays for x in g.values()) == rg.arrivals


def test_event_graphs_replay_the_planned_branch(cuda_device):
    """softsync c = 3: of each window's arrivals two only buffer and one
    applies; each branch's graph runs exactly that often."""
    runs = _event_runs(cuda_device, "qwen3-0.6b", "softsync", updates=4)
    graph, res = runs[4]
    g = graph._event_chunk.graphs
    assert res.arrivals == 12
    assert g[True].captures + g[True].replays == 4
    assert g[False].captures + g[False].replays == 8
    assert g[True].captures == g[False].captures == 1


def test_event_run_on_card_matches_cpu(cuda_device):
    cfg = _event_cfg("qwen3-0.6b", "async", 4)
    cpu = Trainer(cfg, device="cpu")
    cpu.init_state()
    card = Trainer(cfg, device=cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    card.reset_optimizer_state()
    card._init_event_state()
    rc, rg = cpu.run(5), card.run(5)
    assert [(m["staleness"], m["sim_time"]) for m in rg.metrics] == \
        [(m["staleness"], m["sim_time"]) for m in rc.metrics]
    np.testing.assert_allclose([m["loss"] for m in rg.metrics],
                               [m["loss"] for m in rc.metrics], rtol=1e-5)
    for k, v in rc.params.items():
        np.testing.assert_allclose(rg.params[k].detach().cpu().numpy(),
                                   v.detach().numpy(), atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The spmd engine: batched worker gradients, the 'data' axis over NCCL
# ---------------------------------------------------------------------------


def test_wkv_vmap_rule_matches_the_worker_loop(cuda_device):
    from repro_torch.distributed import spmd_engine
    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6-1.6b"),
                              remat="full")
    model = RWKVLM(cfg, device=cuda_device)
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 2, 40)))
             .to(cuda_device) for k in ("tokens", "labels")}
    params = dict(model.named_parameters())
    loss = spmd_engine.make_worker_loss(model)
    before = (twkv.launches_fwd, twkv.launches_bwd)
    want = []
    for w in range(4):
        total, _, _ = loss({k: v[w] for k, v in batch.items()})
        want.append(torch.autograd.grad(total, list(params.values())))
    mid = (twkv.launches_fwd, twkv.launches_bwd)
    grads, _ = spmd_engine.make_batched_grads(model)(
        {f"model.{k}": v.detach() for k, v in params.items()}, batch)
    torch.cuda.synchronize()
    after = (twkv.launches_fwd, twkv.launches_bwd)
    layers = cfg.num_layers
    assert (mid[0] - before[0], mid[1] - before[1]) == (8 * layers,
                                                        4 * layers)
    assert (after[0] - mid[0], after[1] - mid[1]) == (2 * layers, layers)
    for i, name in enumerate(params):
        torch.testing.assert_close(
            grads[f"model.{name}"], torch.stack([g[i] for g in want]),
            rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("grad_batch", [0, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b",
                                  "qwen2-moe-a2.7b", "hymba-1.5b"])
def test_batched_graph_chunks_match_eager_steps(cuda_device, arch,
                                                grad_batch):
    runs = {}
    for chunk in (1, 3):
        cfg = _chunk_cfg(arch, "spmd", chunk)
        cfg = dataclasses.replace(cfg, execution=dataclasses.replace(
            cfg.execution, grad_batch=grad_batch))
        tr = Trainer(cfg, device=cuda_device)
        tr.init_state()
        runs[chunk] = (tr, tr.run(5))
    (eager, re), (graph, rg) = runs[1], runs[3]
    assert rg.metrics == re.metrics and rg.sim_time == re.sim_time
    _state_equal(eager, graph)


def _mesh_cfg(mesh_data, chunk):
    cfg = _chunk_cfg("qwen3-0.6b", "spmd", chunk)
    return dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, grad_batch=0, mesh_data=mesh_data), total_steps=3)


def nccl_rank(rank, device, out_dir):
    """A rank of ``test_nccl_ranks_match_one_card`` (``mesh.spawn``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(_mesh_cfg(2, 3), device=device)
    tr.init_state()
    res = tr.run(3)
    torch.save({k: v.detach().cpu() for k, v in res.params.items()},
               f"{out_dir}/rank{rank}.pt")


def test_nccl_ranks_match_one_card(cuda_device, tmp_path):
    from repro_torch.distributed import mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards for 2 NCCL ranks (one card each)")
    mesh.spawn(nccl_rank, 2, "cuda", args=(str(tmp_path),), timeout_s=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    one = Trainer(_mesh_cfg(1, 1), device=cuda_device)
    one.init_state()
    want = one.run(3).params
    for k, v in ranks[0].items():
        assert torch.equal(ranks[1][k], v), k
        np.testing.assert_allclose(v.numpy(), want[k].detach().cpu().numpy(),
                                   atol=1e-5, err_msg=k)


def tp_rank(rank, device, out_dir, chunk):
    """A rank of ``test_tp_ranks_match_one_card`` (``mesh.spawn``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _mesh_cfg(1, chunk)
    tr = Trainer(dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, mesh_model=2)), device=device)
    tr.init_state()
    res = tr.run(3)
    local = {k: v.detach().cpu() for k, v in res.params.items()}
    full = {k: v.detach().cpu() for k, v in tr._full(res.params).items()}
    torch.save({"local": local, "full": full, "dims": tr.model.tp_dims},
               f"{out_dir}/rank{rank}.pt")


def test_tp_ranks_match_one_card(cuda_device, tmp_path):
    from repro_torch.distributed import mesh
    chunk = 3 if torch.cuda.device_count() >= 2 else 1   # gloo: no capture
    mesh.spawn(tp_rank, 1, "cuda", args=(str(tmp_path), chunk),
               mesh_model=2, timeout_s=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    one = Trainer(_mesh_cfg(1, 1), device=cuda_device)
    one.init_state()
    want = one.run(3).params
    dims = ranks[0]["dims"]
    assert any(d is not None for d in dims.values())
    for k, v in ranks[0]["full"].items():
        assert torch.equal(ranks[1]["full"][k], v), k
        if dims[k] is None:
            assert torch.equal(ranks[1]["local"][k], ranks[0]["local"][k]), k
        np.testing.assert_allclose(v.numpy(), want[k].detach().cpu().numpy(),
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The device straggler backend and a rescale inside a graph run
# ---------------------------------------------------------------------------


def _eager_chunk(tr):
    """The trainer's chunk step as the eager step in a loop (what the
    graph replays), for ``tr``'s own model and optimizer."""
    from repro_torch.train.train_step import build_train_step
    agg = tr.cfg.aggregation
    step = build_train_step(tr.model, tr.optimizer,
                            num_workers=agg.total_workers,
                            n_aggregate=agg.num_workers,
                            ema_decay=tr.cfg.optimizer.ema_decay,
                            clip_norm=tr.cfg.optimizer.clip_global_norm)

    def chunk(opt_state, ema, scalars, batches, masks):
        rows = {}
        for i in range(masks.shape[0]):
            m = step(opt_state, ema, {k: v[i] for k, v in scalars.items()},
                     {k: v[i] for k, v in batches.items()}, masks[i])
            for k, v in m.items():
                rows.setdefault(k, []).append(v.detach())
        return {k: torch.stack(v) for k, v in rows.items()}

    return chunk


def test_device_backend_graph_matches_eager(cuda_device):
    cfg = dataclasses.replace(_chunk_cfg("qwen3-0.6b", "sim", 4),
                              straggler_backend="device")
    runs = {}
    for tag, chunk in (("graph", 4), ("eager", 4), ("one", 8)):
        tr = Trainer(dataclasses.replace(cfg, chunk_size=chunk),
                     device=cuda_device)
        tr.init_state()
        if tag == "eager":
            tr.chunk_step = _eager_chunk(tr)
        runs[tag] = (tr, tr.run(8))
    (g, rg), (e, re_), (o, ro) = runs["graph"], runs["eager"], runs["one"]
    assert rg.metrics == re_.metrics == ro.metrics
    assert rg.sim_time == re_.sim_time == ro.sim_time
    _state_equal(g, e)
    _state_equal(g, o)
    assert (g.chunk_step.graph.captures, g.chunk_step.graph.replays) == (1, 7)
    assert all(m["selected"] == 6 for m in rg.metrics)


def test_rescale_inside_a_graph_run(cuda_device, tmp_path):
    from repro_torch.configs import FaultConfig
    from repro_torch.core import faults
    spec = "crash@2:w1,slow@2:w0:x3:d2,crash@3:w2,crash@5:w3"
    runs = {}
    for tag, chunk, device in (("graph", 3, cuda_device),
                               ("eager", 1, cuda_device),
                               ("cpu", 3, "cpu")):
        cfg = dataclasses.replace(
            _chunk_cfg("qwen3-0.6b", "spmd", chunk,
                       directory=str(tmp_path / tag), every=4),
            faults=FaultConfig(spec=spec))
        tr = Trainer(cfg, device=device, injector=faults.build_injector(
            cfg.faults, num_steps=8, num_workers=8))
        tr.init_state()
        old = weakref.ref(tr.chunk_step.graph) if tag == "graph" else None
        runs[tag] = (tr, tr.run(8), old)
    (g, rg, old), (e, re_, _), (_, rc, _) = (runs["graph"], runs["eager"],
                                             runs["cpu"])
    assert rg.recovery_log == re_.recovery_log == rc.recovery_log
    assert [ev["event"] for ev in rg.recovery_log].count("rescale") == 1
    assert g.cfg.aggregation.total_workers == 4 and rg.restarts == 1
    assert rg.metrics == re_.metrics
    _state_equal(g, e)
    # the old W's graph was captured and replayed before the rescale ...
    assert next(ev["step"] for ev in rg.recovery_log
                if ev["event"] == "rescale") >= 3
    # ... and nothing holds it (nor its pool and stack) after it
    gc.collect()
    assert old() is None
    new = g.chunk_step.graph
    assert new.captures == 1 and new.replays > 0


# ---------------------------------------------------------------------------
# Telemetry and the replica router on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_traced_graph_run_is_bit_equal(cuda_device, backend):
    """A traced, metered run through the step graph (2 chunks of 4) equals
    the untraced one bit for bit; the chunk spans hold their data and
    device waits (and the spmd spans), one capture serves both chunks."""
    from repro_torch import obs
    runs = {}
    for tag in ("plain", "traced"):
        tracer, reg = (obs.Tracer(), obs.MetricsRegistry()) \
            if tag == "traced" else (None, None)
        tr = Trainer(_chunk_cfg("qwen3-0.6b", backend, 4),
                     device=cuda_device, tracer=tracer, metrics=reg)
        tr.init_state()
        runs[tag] = (tr, tr.run(8), tracer, reg)
    (p, rp, _, _), (t, rt, tracer, reg) = runs["plain"], runs["traced"]
    assert rt.metrics == rp.metrics and rp.phase_times == {}
    _state_equal(p, t)
    roots = [r for r in obs.span_tree(list(tracer.events))
             if r["name"] == "train/chunk"]
    want = ["train/data_wait", "train/device_wait"]
    if backend == "spmd":
        want[1:1] = ["spmd/dispatch", "spmd/collective_wait"]
    assert len(roots) == 2 and all(
        [c["name"] for c in r["children"]] == want for r in roots)
    assert reg.counter("train/steps").value == 8
    assert reg.histogram("train/chunk_time_s").count == 2
    g = t.chunk_step.graph
    assert (g.captures, g.replays) == (1, 7)


def test_sessions_capture_their_own_decode_graphs(cuda_device):
    """Three router replicas over one engine: each session captures one
    decode graph over its own pool; the router's tokens equal the eager
    engine's; a crash drains a replica and loses nothing."""
    from repro_torch.serve import ReplicaRouter, RouterConfig, StepSession
    cfg = configs.get_smoke_config("qwen3-0.6b")
    model = TransformerLM(cfg, device=cuda_device,
                          generator=torch.Generator(
                              device=cuda_device).manual_seed(7))
    kw = dict(num_slots=2, page_size=4, max_prompt_len=12, max_new_cap=8,
              clock="virtual")
    trace = make_trace(TraceConfig(
        num_requests=12, rate=2.0, prompt_len_min=2, prompt_len_max=12,
        max_new_min=2, max_new_max=8, vocab=cfg.vocab_size, seed=7))
    want = ServeEngine(cfg, model, decode_graph=False, **kw).run(
        trace).tokens_by_rid()
    eng = ServeEngine(cfg, model, **kw)
    made = []

    class Session(StepSession):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    from unittest import mock
    from repro_torch.serve import router as router_lib
    with mock.patch.object(router_lib, "StepSession", Session):
        before = tgather.launches
        rep = ReplicaRouter(eng, RouterConfig(
            num_replicas=3, hedge_after=4.0,
            faults="crash@4:r1,restart@12:r1")).run(trace)
        torch.cuda.synchronize()
    assert rep.metrics["lost_requests"] == 0
    assert rep.metrics["completed"] == len(trace)
    assert rep.tokens_by_rid() == want
    assert tgather.launches > before
    assert [s.decode_captures for s in made] == [1, 1, 1]
    assert len({s._graph.graph for s in made}) == 3
    ptrs = {s.pool.buffers["k"].data_ptr() for s in made}
    assert len(ptrs) == 3


def test_backup_reduce_takes_one_worker(cuda_device):
    """A rank of a shrunk 'data' axis holds one worker: the kernel reduces
    [1, P] (masked in and out) to its plain version's value."""
    g = torch.randn((1, 4099), device=cuda_device)
    for bit in (1.0, 0.0):
        m = torch.tensor([bit], device=cuda_device)
        before = treduce.launches
        got = treduce.backup_reduce(g, m, 3)
        assert treduce.launches == before + 1
        assert torch.equal(got, treduce.backup_reduce_plain(g, m, 3))


# ---------------------------------------------------------------------------
# Tensor-parallel decode and the toy path on the card
# ---------------------------------------------------------------------------


def _smoke_tree(arch):
    """The smoke config and a seeded CPU model's parameters as the
    reference's tree (numpy leaves)."""
    from repro_torch.models import get_model, to_jax_tree
    cfg = configs.get_smoke_config(arch)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(7))
    return cfg, to_jax_tree({k: v.detach().numpy()
                             for k, v in model.named_parameters()})


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_tp_decode_on_card_matches_one_card(cuda_device, tmp_path, int8):
    """``ServeEngine(mesh_model=2)``: 2 NCCL ranks with 2 cards (the decode
    graph capturing the all-reduces and the vocab all-gather), else 2 gloo
    ranks sharing the one card (eager decode); both ranks serve the
    one-card engine's greedy tokens, kernels on."""
    import torch_serve_tp_ranks as ranks
    from repro_torch.distributed import mesh
    from repro_torch.models import get_model, load_jax_params
    cfg, tree = _smoke_tree("qwen3-0.6b")
    trace = make_trace(TraceConfig(
        num_requests=6, rate=2.0, prompt_len_min=2, prompt_len_max=12,
        max_new_min=2, max_new_max=8, vocab=cfg.vocab_size, seed=3))
    mesh.spawn(ranks.serve_rank, 1, "cuda",
               args=(str(tmp_path), {"tp": ("qwen3-0.6b", tree, int8,
                                            trace)}),
               mesh_model=2, timeout_s=300)
    model = load_jax_params(get_model(cfg, device=cuda_device), tree)
    want = ServeEngine(cfg, model, device=cuda_device, cache_int8=int8,
                       **ranks.ENGINE_KW).run(trace).tokens_by_rid()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["tp"]
        assert got["tokens"] == want
        assert got["all_reduces"] > 0 and got["all_gathers"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-1b", "rwkv6-1.6b",
                                  "hymba-1.5b"])
def test_toy_path_on_card_matches_cpu(cuda_device, arch):
    """``greedy_generate`` on the card gives the CPU port's tokens (f32
    smoke; gemma3 and hymba 26 steps past their window of 8), fp and int8
    caches."""
    from repro_torch.models import get_model
    from repro_torch.train.serve_step import greedy_generate
    cfg = configs.get_smoke_config(arch)
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    card = get_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)))
    for dt in (None, torch.int8):
        want = greedy_generate(cpu, prompt, 20, 27, cache_dtype=dt)
        got = greedy_generate(card, prompt, 20, 27, cache_dtype=dt)
        assert torch.equal(got.cpu(), want)


def test_rwkv_prefill_kernel_matches_stepped_decode(cuda_device):
    """RWKV ``prefill`` (the wkv6 forward kernel from a zero state, one
    launch a layer) against 40 ``decode_step``s carrying the state (the
    plain scan): f32 smoke, atol / rtol 1e-4."""
    from repro_torch.models import get_model
    cfg = configs.get_smoke_config("rwkv6-1.6b")
    model = get_model(cfg, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    before = twkv.launches_fwd
    with torch.inference_mode():
        pre = model.prefill(toks)
    assert twkv.launches_fwd == before + cfg.num_layers
    cache = model.init_cache(2, 40)
    for i in range(40):
        logits, cache = model.decode_step(toks[:, i:i + 1], cache)
    torch.testing.assert_close(logits, pre, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_on_card_matches_cpu(cuda_device, capacity_factor):
    """qwen2-moe smoke (f32) at ``capacity_factor`` (8 never drops, 1.25
    drops): the card's paged engine (graph decode and eager) and
    ``greedy_generate`` give the CPU port's tokens, fp and int8, with
    page gather and flash launched."""
    from repro_torch.models import get_model
    from repro_torch.train.serve_step import greedy_generate
    base = configs.get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=capacity_factor))
    cpu_model = get_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(4))
    gpu_model = get_model(cfg, device=cuda_device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
              clock="virtual")
    tc = TraceConfig(num_requests=6, rate=100.0, prompt_len_min=2,
                     prompt_len_max=12, max_new_min=2, max_new_max=8,
                     vocab=cfg.vocab_size, seed=4)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 5)))
    for int8 in (False, True):
        want = ServeEngine(cfg, cpu_model, device="cpu", cache_int8=int8,
                           **kw).run(make_trace(tc)).tokens_by_rid()
        for graph in (True, False):
            before = (tgather.launches, tflash.launches)
            got = ServeEngine(cfg, gpu_model, cache_int8=int8,
                              decode_graph=graph,
                              **kw).run(make_trace(tc)).tokens_by_rid()
            assert got == want, (int8, graph)
            assert tgather.launches > before[0] and \
                tflash.launches > before[1]
        dt = torch.int8 if int8 else None
        assert torch.equal(
            greedy_generate(gpu_model, prompt, 6, 12, cache_dtype=dt).cpu(),
            greedy_generate(cpu_model, prompt, 6, 12, cache_dtype=dt))


# ---------------------------------------------------------------------------
# The hybrid and audio families, the blocked attention core
# ---------------------------------------------------------------------------


def test_whisper_toy_path_on_card_matches_cpu(cuda_device):
    """whisper smoke (f32): ``greedy_generate`` with encoder frames (the
    cross cache primed first) on the card gives the CPU port's tokens, fp
    and int8 caches (the reference's scale-less int8)."""
    from repro_torch.models import get_model
    from repro_torch.train.serve_step import greedy_generate
    cfg = configs.get_smoke_config("whisper-tiny")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(6))
    card = get_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32))
    for dt in (None, torch.int8):
        want = greedy_generate(cpu, prompt, 12, 19, cache_dtype=dt,
                               encoder_frames=frames)
        got = greedy_generate(card, prompt, 12, 19, cache_dtype=dt,
                              encoder_frames=frames.to(cuda_device))
        assert torch.equal(got.cpu(), want)


def _whisper_batch_fn(cfg):
    def batch_fn(worker, draw):
        rng = np.random.default_rng(100 * draw + worker)
        toks = rng.integers(0, cfg.vocab_size, (2, 9))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "encoder_frames": rng.standard_normal(
                    (2, cfg.encoder_seq_len, cfg.d_model),
                    dtype=np.float32)}
    return batch_fn


def test_whisper_event_graph_matches_per_arrival(cuda_device):
    """whisper smoke (f32, remat full) through async over 4 workers with a
    ``batch_fn`` that makes frames: the event graph chunks of 4 updates
    against the per-arrival loop on the card, state and metrics
    bit-equal; the per-arrival run on the card against the CPU port's
    (atol 1e-5)."""
    cfg = dataclasses.replace(
        _train_cfg(), model=dataclasses.replace(
            configs.get_smoke_config("whisper-tiny"), remat="full"),
        shape=ShapeConfig("t", 8, 8, "train"),
        aggregation=AggregationConfig(strategy="async", num_workers=4),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.99),
        execution=ExecutionConfig(backend="sim"))
    fn = _whisper_batch_fn(cfg.model)
    cpu = Trainer(cfg, device="cpu", batch_fn=fn)
    cpu.init_state()
    start = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    rc = cpu.run(6)
    runs = {}
    for chunk in (1, 4):
        tr = Trainer(dataclasses.replace(cfg, chunk_size=chunk),
                     device=cuda_device, batch_fn=fn)
        tr.init_state()
        tr.model.load_state_dict(start)
        tr.reset_optimizer_state()
        tr._init_event_state()
        runs[chunk] = (tr, tr.run(6))
    (eager, re), (graph, rg) = runs[1], runs[4]
    assert rg.metrics == re.metrics and rg.sim_time == re.sim_time
    _state_equal(eager, graph)
    np.testing.assert_allclose([m["loss"] for m in re.metrics],
                               [m["loss"] for m in rc.metrics], rtol=1e-5)
    for k, v in rc.params.items():
        np.testing.assert_allclose(re.params[k].detach().cpu().numpy(),
                                   v.detach().numpy(), atol=1e-5, err_msg=k)


def test_chunked_attention_on_card_matches_cpu(cuda_device):
    """``chunked_attention_core`` (causal, window 6, softcap 2, ragged S,
    chunks of 8) and the SSD's chunked form on the card equal the CPU's
    (f32, atol 1e-5)."""
    from repro_torch.models import attention, mamba
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 37, 3, 16),
                                                    dtype=np.float32))
               for _ in range(3))
    kw = dict(causal=True, window=6, softcap=2.0, q_chunk=8, kv_chunk=8)
    want = attention.chunked_attention_core(q, k, v, **kw)
    got = attention.chunked_attention_core(
        *(t.to(cuda_device) for t in (q, k, v)), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    xv, bb, cc = (torch.from_numpy(0.5 * rng.standard_normal(
        (2, 45, 3, n), dtype=np.float32)) for n in (8, 4, 4))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((2, 45, 3), dtype=np.float32)))
    decay = torch.exp(-dt)
    args = (xv, bb, cc, dt, decay, torch.ones((3, 8)))
    for fn in (mamba.ssd_chunked, mamba.ssd_scan):
        wy, ws = fn(*args)
        gy, gs = fn(*(a.to(cuda_device) for a in args))
        np.testing.assert_allclose(gy.cpu().numpy(), wy.numpy(), atol=1e-5)
        np.testing.assert_allclose(gs.cpu().numpy(), ws.numpy(), atol=1e-5)

