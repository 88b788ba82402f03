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
  window and a softcap of 2 that binds. Each call adds exactly one
  launch.
* The card's ``ServeEngine`` (kernels) gives the CPU port's greedy tokens
  (which ``tests/test_torch_serve.py`` holds to the JAX engine).
* ``backup_reduce``: the kernel equals its plain version bit for bit over
  W in {2, 3, 8}, P in {1, 3, 4097, 65536}, masks all-zero, all-one and
  mixed, on both the float4 path and the scalar path (ragged P, a base
  off 16 bytes, a bucket sliced out of a wider stack); it refuses CPU
  tensors and counts one launch per call.
* Two training steps of the smoke model on the card (spmd backend, the
  kernel) against the same two steps of the CPU port: atol 1e-5 (f32).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import numpy as np

from repro_torch import configs
from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                 ExecutionConfig, OptimizerConfig,
                                 ShapeConfig, TrainConfig)
from repro_torch.kernels import backup_reduce as treduce
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import page_gather as tgather
from repro_torch.models import TransformerLM
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
                                                (512, 128, 64, 2.0)])
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
