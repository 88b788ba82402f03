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
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import page_gather as tgather
from repro_torch.models import TransformerLM
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
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
