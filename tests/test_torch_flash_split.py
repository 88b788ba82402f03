"""The split of flash attention's key band at head dim 256, on the CPU.

The bf16 head-dim-256 kernel (``csrc/flash_attention.cu``, namespace hop)
cuts each (q tile, head, batch)'s key band into ``clusters`` chunks of at
most ``tiles`` key tiles, one block a chunk, and merges the chunks'
partials (O, m, l) in the cluster. The plan comes from Python
(``kernels/flash_attention.split_plan`` / ``split_chunks``), so it is
tested here:

* ``split_plan`` / ``split_chunks``: over S in {1, 63, 64, 65, 128, 512,
  1000, 4096}, causal and not, window 0 / 512, and three card capacities,
  every key tile of each band is covered exactly once, in rank order, and
  no block takes more than its T; C is a power of two up to 8 and the
  clusters fit the capacity (or C is 1). The band holds every key the mask
  lets through. gemma3-1b's prefill buckets get the plans the H100 runs.
* ``flash_attention_split_plain``, the split computation in plain PyTorch
  (a partial per chunk, merged in f32 in rank order), against
  ``ref.reference_attention`` and ``ops.flash_attention_bshd`` (Pallas,
  interpret mode), under several plans: a window edge inside a chunk (rows
  with no key in it), non-causal, softcap, GQA, S = 1 and S not a multiple
  of 64 (the reference only: no Pallas block divides it). f32 atol / rtol
  2e-5: the same f32 algebra summed in another order.

The kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 25.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops, ref

from repro_torch.kernels import flash_attention as tflash
from torch_parity import qkv_inputs

CAPACITIES = [tflash.H100_CAPACITY, (10 ** 6,) * 4, (1, 1, 1, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", [0, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 128, 512, 1000, 4096])
def test_plan_covers_every_band_tile_once(s, causal, window):
    nq = -(-s // tflash.BQ)
    for h, b in ((4, 1), (1, 1), (8, 2)):
        for cap in CAPACITIES:
            plan = tflash.split_plan(s, h, b, causal, window, cap)
            c, t = plan.clusters, plan.tiles
            assert c in (1, 2, 4, 8) and t >= 1
            assert plan.blocks == nq * h * b * c
            assert c == 1 or nq * h * b <= cap[c.bit_length() - 1]
            widest = 0
            for qt in range(nq):
                first, n = tflash.band_tiles(qt, s, causal, window)
                widest = max(widest, n)
                chunks = tflash.split_chunks(plan, qt, s, causal, window)
                assert len(chunks) == c
                covered = [kt for lo, hi in chunks for kt in range(lo, hi)]
                assert covered == list(range(first, first + n))
                assert all(0 <= hi - lo <= t for lo, hi in chunks)
            assert c <= widest and t == -(-widest // c)


@pytest.mark.parametrize("s,causal,window", [(65, True, 0), (300, True, 100),
                                             (200, False, 64),
                                             (130, False, 0)])
def test_band_holds_every_unmasked_key(s, causal, window):
    pos = np.arange(s)
    diff = pos[:, None] - pos[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    for qt in range(-(-s // tflash.BQ)):
        first, n = tflash.band_tiles(qt, s, causal, window)
        rows = mask[qt * tflash.BQ:(qt + 1) * tflash.BQ]
        keys = np.flatnonzero(rows.any(axis=0))
        assert keys.min() >= first * tflash.BK
        assert keys.max() < (first + n) * tflash.BK
        assert first * tflash.BK <= keys.min() < (first + 1) * tflash.BK


def test_plan_at_gemma3_prefill_buckets():
    """gemma3-1b's prefill (4 heads, causal, window 512) on the H100's
    capacity: the grids `chip_smoke.py` phase 25 times."""
    want = {128: (2, 1, 16), 256: (4, 1, 64), 512: (4, 2, 128)}
    for s, plan in want.items():
        assert tuple(tflash.split_plan(s, 4, 1, True, 512)) == plan
    # past one wave of clusters the band stays whole: one block loops
    assert tuple(tflash.split_plan(4096, 4, 1, False, 0)) == (1, 64, 256)


# one compile a shape instead of one an op (the test's time)
_reference = jax.jit(ref.reference_attention,
                     static_argnames=("causal", "window", "softcap"))


def _ref_bshd(q, k, v, **kw):
    t = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    return np.asarray(_reference(t(q), t(k), t(v), **kw)
                      ).transpose(0, 2, 1, 3)


def _twins(q, k, v, plans, **kw):
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    return [tflash.flash_attention_split_plain(qt, kt, vt, plan=p, **kw
                                               ).numpy() for p in plans]


P = tflash.SplitPlan


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,softcap,block,plans", [
    # the window's edge inside a chunk: tile 0 holds no key of rows >= 163
    (2, 192, 4, 2, 32, True, 100, 0.0, 64,
     [None, P(4, 1, 0), P(2, 2, 0), P(1, 3, 0)]),
    # non-causal, softcap, MQA
    (1, 128, 4, 1, 32, False, 0, 3.0, 64, [None, P(2, 1, 0), P(8, 1, 0)]),
    # one row
    (1, 1, 2, 1, 256, True, 0, 0.0, 1, [None, P(8, 1, 0)]),
])
def test_split_twin_matches_jax(b, s, h, kv, d, causal, window, softcap,
                                block, plans):
    q, k, v = qkv_inputs(5, b, s, h, kv, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _ref_bshd(q, k, v, **kw)
    pallas = np.asarray(ops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
        block_k=block, **kw))
    np.testing.assert_allclose(pallas, want, atol=2e-5, rtol=2e-5)
    for got in _twins(q, k, v, plans, **kw):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)


def test_split_twin_ragged_s_matches_reference():
    """S = 77 (no Pallas block divides it) at head dim 256, causal with a
    window of 40: the last q tile is 13 rows, and with one tile a chunk the
    first tile of q tile 1's band holds no key of its last rows."""
    q, k, v = qkv_inputs(6, 1, 77, 4, 2, 256)
    kw = dict(causal=True, window=40, softcap=0.0)
    want = _ref_bshd(q, k, v, **kw)
    for got in _twins(q, k, v, [None, P(2, 1, 0), P(8, 1, 0)], **kw):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_split_twin_keeps_the_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv_inputs(7, 1, 70, 2, 1, 32))
    got = tflash.flash_attention_split_plain(q, k, v, window=30)
    want = tflash.flash_attention_plain(q, k, v, window=30)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=8e-3)
