"""The port's masked reduce against the JAX reference, on the CPU.

* ``backup_reduce_plain`` (the CUDA kernel's plain twin, which the kernel
  equals bit for bit on the card) against the JAX Pallas kernel in
  interpret mode and against ``ref_masked_mean``: rtol 1e-6, atol 1e-6
  (the dot sums in another order: a few f32 ulps of the terms, which are
  of order 1, so an output near 0 needs the absolute term).
* ``reduce_then_psum`` on the cases of ``tests/test_bucketed_reduce.py``:
  W = 1 (scalar rescale), the empty flatten, the tail passthrough, ragged
  buckets, and a mask shape mismatch; ``bucket_bounds`` equal to the
  reference's on a grid.
* ``flatten_stacked`` / ``unflatten_vector`` lay lanes out as the
  reference does; the kernel wrapper refuses CPU tensors and the engine
  refuses ``use_kernel=True`` and ``interpret=True`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.distributed import spmd_engine as jengine
from repro.kernels import backup_reduce as jbr
from repro.kernels import bucketed_reduce as jbucket

from repro_torch.distributed import spmd_engine as tengine
from repro_torch.kernels import backup_reduce as tbr
from repro_torch.kernels import bucketed_reduce as tbucket

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(seed, w, p, kind="mixed"):
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((w, p)).astype(np.float32)
    mask = {"mixed": (rng.random(w) < 0.7), "zeros": np.zeros(w, bool),
            "ones": np.ones(w, bool)}[kind].astype(np.float32)
    if kind == "mixed":
        mask[0] = 1.0
    return grads, mask


@pytest.mark.parametrize("w,p,kind", [(2, 1, "ones"), (3, 3, "mixed"),
                                      (8, 4097, "mixed"), (8, 4096, "zeros"),
                                      (3, 65536, "ones")])
def test_plain_matches_pallas_interpret_and_ref(w, p, kind):
    g, m = _rand(w * 1000 + p, w, p, kind)
    n_agg = max(1, w - 2)
    got = tbr.backup_reduce_plain(torch.from_numpy(g), torch.from_numpy(m),
                                  n_agg).numpy()
    pallas = np.asarray(jbr.backup_reduce(jnp.asarray(g), jnp.asarray(m),
                                          n_agg, interpret=True))
    ref = np.asarray(jbucket.ref_masked_mean(jnp.asarray(g), jnp.asarray(m),
                                             n_agg))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(
        tbucket.ref_masked_mean(torch.from_numpy(g), torch.from_numpy(m),
                                n_agg).numpy(), ref, **TOL)


def test_bucket_bounds_equal_reference():
    for total in (0, 1, 7, 64, 100):
        for bucket in (-1, 0, 1, 3, 8, 64, 200):
            assert tbucket.bucket_bounds(total, bucket) == \
                jbucket.bucket_bounds(total, bucket)
    with pytest.raises(ValueError, match=">= 0"):
        tbucket.bucket_bounds(-1, 4)


def _both(g, m, n_agg, **kw):
    tail = kw.pop("tail", None)
    jt = None if tail is None else jnp.asarray(tail)
    tt = None if tail is None else torch.from_numpy(np.asarray(tail))
    ja, jtail = jbucket.reduce_then_psum(jnp.asarray(g), jnp.asarray(m),
                                         n_agg, tail=jt, use_kernel=False,
                                         **kw)
    ta, ttail = tbucket.reduce_then_psum(torch.from_numpy(g),
                                         torch.from_numpy(m), n_agg,
                                         tail=tt, use_kernel=False, **kw)
    return (np.asarray(ja), None if jtail is None else np.asarray(jtail),
            ta.numpy(), None if ttail is None else ttail.numpy())


@pytest.mark.parametrize("mask_val", [0.0, 1.0])
@pytest.mark.parametrize("bucket", [0, 16])
def test_single_worker_is_a_rescale(mask_val, bucket):
    g, _ = _rand(0, 1, 37)
    ja, _, ta, _ = _both(g, np.array([mask_val], np.float32), 3,
                         bucket=bucket)
    np.testing.assert_allclose(ta, ja, **TOL)


@pytest.mark.parametrize("w,p,bucket", [(4, 50, 16), (4, 50, 6), (5, 23, 8),
                                        (8, 100, 0), (3, 64, 64)])
def test_ragged_buckets_match(w, p, bucket):
    g, m = _rand(w + p, w, p)
    ja, _, ta, _ = _both(g, m, 2, bucket=bucket)
    np.testing.assert_allclose(ta, ja, **TOL)


def test_empty_flatten_keeps_the_tail():
    g, m = _rand(2, 3, 0)
    ja, jtail, ta, ttail = _both(g, m, 2, tail=np.array([5.0, 7.0],
                                                        np.float32))
    assert ta.shape == ja.shape == (0,)
    np.testing.assert_array_equal(ttail, jtail)


def test_tail_rides_last_bucket_without_perturbing_gradient():
    g, m = _rand(3, 5, 23)
    tail = np.array([2.5, -1.25, 9.0], np.float32)
    plain, none_tail = tbucket.reduce_then_psum(
        torch.from_numpy(g), torch.from_numpy(m), 4, bucket=8,
        use_kernel=False)
    ja, jtail, ta, ttail = _both(g, m, 4, bucket=8, tail=tail)
    assert none_tail is None
    np.testing.assert_array_equal(ta, plain.numpy())
    np.testing.assert_allclose(ta, ja, **TOL)
    np.testing.assert_array_equal(ttail, jtail)


def test_mask_shape_mismatch_raises():
    g, _ = _rand(4, 4, 10)
    with pytest.raises(ValueError, match="does not match the worker axis"):
        tbucket.reduce_then_psum(torch.from_numpy(g), torch.ones(3), 2)


def test_flatten_unflatten_match_reference():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(2, 3, 2).astype(np.float32),
            "b": rng.randn(2, 5).astype(np.float32),
            "s": rng.randn(2).astype(np.float32)}
    jflat, _ = jengine.flatten_stacked({k: jnp.asarray(v)
                                        for k, v in tree.items()})
    tflat, spec = tengine.flatten_stacked({k: torch.from_numpy(v)
                                           for k, v in tree.items()})
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    rec = tengine.unflatten_vector(tflat[1], spec)
    for k, v in tree.items():
        np.testing.assert_array_equal(rec[k].numpy(), v[1])
    bf = tengine.unflatten_vector(tflat[0], tengine.flat_spec(
        {"a": torch.zeros(3, 2, dtype=torch.bfloat16),
         "b": torch.zeros(5), "s": torch.zeros(())}))
    assert bf["a"].dtype == torch.bfloat16 and bf["s"].shape == ()


def test_cpu_refusals():
    g, m = _rand(5, 3, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbr.backup_reduce(torch.from_numpy(g), torch.from_numpy(m), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbucket.reduce_then_psum(torch.from_numpy(g), torch.from_numpy(m), 2,
                                 use_kernel=True)
    cpu = torch.device("cpu")
    assert tengine.resolve_use_kernel(None, None, cpu) is False
    assert tengine.resolve_use_kernel(False, False, cpu) is False
    with pytest.raises(ValueError, match="needs the card"):
        tengine.resolve_use_kernel(True, None, cpu)
    with pytest.raises(ValueError, match="Pallas interpret"):
        tengine.resolve_use_kernel(None, True, cpu)
