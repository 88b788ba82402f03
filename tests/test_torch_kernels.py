"""The port's kernel modules against the JAX oracles, and their wrappers.

* ``gather_pages_plain`` vs ``gather_pages_reference`` and
  ``gather_pages_pallas(interpret=True)``: fp and int8 pools, trash-page
  rows and ragged tables. Bit-exact (a gather and one f32 multiply).
* ``flash_attention_plain`` vs ``ref.reference_attention`` and
  ``ops.flash_attention_bshd`` (Pallas, interpret mode): causal, window,
  softcap, GQA, non-causal, and S not a multiple of 128 (or of any block,
  against the reference only). f32 atol/rtol 2e-5: the same f32 algebra
  in another summation order; the online softmax of the Pallas kernel
  rescales partial sums.
* The wrappers: CPU tensors take the plain version and count no launch,
  bad input raises before any dispatch. On the card each kernel is held
  to its plain version by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro.kernels.page_gather import (gather_pages_pallas,
                                       gather_pages_reference)

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import page_gather as tgather
from torch_parity import j2n, qkv_inputs, ragged_table, random_pool, t2n

# ---------------------------------------------------------------------------
# page gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,maxp,ps,kv,hd", [(5, 4, 4, 2, 16),
                                             (4, 3, 8, 1, 32)])
def test_gather_plain_matches_jax(quantized, b, maxp, ps, kv, hd):
    num_pages = b * maxp + 1
    pool, scales = random_pool(0, (num_pages, ps, kv, hd), quantized)
    tbl = ragged_table(1, b, maxp, num_pages)
    t = tgather.gather_pages_plain(
        torch.from_numpy(pool), torch.from_numpy(tbl),
        None if scales is None else torch.from_numpy(scales),
        out_dtype=torch.float32)
    js = None if scales is None else jnp.asarray(scales)
    j_ref = gather_pages_reference(jnp.asarray(pool), jnp.asarray(tbl), js,
                                   out_dtype=jnp.float32)
    j_pallas = gather_pages_pallas(jnp.asarray(pool), jnp.asarray(tbl), js,
                                   out_dtype=jnp.float32, interpret=True)
    assert tuple(t.shape) == (b, maxp * ps, kv, hd)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_ref))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_pallas))


def test_gather_dequant_bf16_matches_jax():
    b, maxp, ps, kv, hd = 3, 2, 4, 2, 16
    num_pages = b * maxp + 1
    pool, scales = random_pool(2, (num_pages, ps, kv, hd), True)
    tbl = ragged_table(3, b, maxp, num_pages)
    t = tgather.gather_pages(torch.from_numpy(pool), torch.from_numpy(tbl),
                             torch.from_numpy(scales),
                             out_dtype=torch.bfloat16)
    j = gather_pages_reference(jnp.asarray(pool), jnp.asarray(tbl),
                               jnp.asarray(scales), out_dtype=jnp.bfloat16)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t2n(t), j2n(j))


def test_gather_cpu_dispatch_counts_no_launch():
    pool, _ = random_pool(4, (5, 4, 2, 16), False)
    tbl = np.array([[1, 2], [0, 0]], np.int32)
    before = tgather.launches
    for use_kernel in (True, False):
        out = tgather.gather_pages(torch.from_numpy(pool),
                                   torch.from_numpy(tbl),
                                   out_dtype=torch.float32,
                                   use_kernel=use_kernel)
        np.testing.assert_array_equal(out[1].numpy(),
                                      np.concatenate([pool[0], pool[0]]))
    assert tgather.launches == before


@pytest.mark.parametrize("case", ["table_dtype", "table_rank", "fp_cast",
                                  "scale_shape", "scale_dtype", "dq_out"])
def test_gather_rejects_bad_input(case):
    pool = torch.zeros((5, 4, 2, 16))
    q8 = torch.zeros((5, 4, 2, 16), dtype=torch.int8)
    sc = torch.zeros((5, 4, 2), dtype=torch.float16)
    tbl = torch.zeros((2, 3), dtype=torch.int32)
    args = {
        "table_dtype": (pool, tbl.long(), None, torch.float32),
        "table_rank": (pool, tbl[0], None, torch.float32),
        "fp_cast": (pool, tbl, None, torch.bfloat16),
        "scale_shape": (q8, tbl, sc[:, :2], torch.float32),
        "scale_dtype": (q8, tbl, sc.float(), torch.float32),
        "dq_out": (q8, tbl, sc, torch.float16),
    }[case]
    with pytest.raises(ValueError):
        tgather.gather_pages(*args[:3], out_dtype=args[3])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _ref_bshd(q, k, v, **kw):
    t = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    return np.asarray(ref.reference_attention(t(q), t(k), t(v), **kw)
                      ).transpose(0, 2, 1, 3)


FLASH_CASES = [
    # (b, s, h, kv, d, causal, window, softcap, block)
    (2, 128, 4, 4, 16, True, 0, 0.0, 64),      # MHA
    (1, 96, 4, 2, 16, True, 0, 0.0, 32),       # GQA 2:1, S % 128 != 0
    (1, 64, 4, 1, 32, True, 16, 0.0, 16),      # MQA + window
    (1, 64, 2, 2, 16, True, 0, 5.0, 32),       # softcap
    (1, 96, 4, 2, 16, True, 24, 3.0, 32),      # window + softcap
    (1, 64, 2, 1, 16, False, 0, 0.0, 32),      # non-causal
]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,softcap,block",
                         FLASH_CASES)
def test_flash_plain_matches_jax(b, s, h, kv, d, causal, window, softcap,
                                 block):
    q, k, v = qkv_inputs(0, b, s, h, kv, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    t = tflash.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw)
    np.testing.assert_allclose(t.numpy(), _ref_bshd(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)
    pallas = ops.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), block_q=block,
                                      block_k=block, **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(pallas),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,window", [(37, 0), (50, 7)])
def test_flash_plain_ragged_s_matches_reference(s, window):
    """S that no block divides: only the reference takes it (the Pallas
    kernel asserts divisibility; the port's CUDA kernel masks the edge)."""
    q, k, v = qkv_inputs(1, 1, s, 4, 2, 16)
    t = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window)
    np.testing.assert_allclose(t.numpy(), _ref_bshd(q, k, v, window=window),
                               atol=2e-5, rtol=2e-5)


def test_flash_bf16_output_dtype_and_cpu_dispatch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv_inputs(2, 1, 32, 2, 1, 16))
    before = tflash.launches
    out = tflash.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 32, 2, 16)
    expect = tflash.flash_attention_plain(q, k, v)
    assert torch.equal(out, expect)
    assert tflash.launches == before


@pytest.mark.parametrize("case", ["rank", "heads", "dtype", "mixed", "seq"])
def test_flash_rejects_bad_input(case):
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    args = {
        "rank": (q[0], k, k),
        "heads": (torch.zeros((1, 8, 3, 16)), k, k),
        "dtype": (q.half(), k.half(), k.half()),
        "mixed": (q, k.bfloat16(), k),
        "seq": (q, k[:, :4], k[:, :4]),
    }[case]
    with pytest.raises(ValueError):
        tflash.flash_attention(*args)
