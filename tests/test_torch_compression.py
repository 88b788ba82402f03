"""The port's gradient compression (``repro_torch.distributed.compression``)
against ``repro.distributed.compression`` on seeded numpy trees.

* bf16: the codes bit-equal (as uint16), the round trip equal.
* int8: codes and 0-d f32 scales bit-equal, dequantised values equal.
* Five steps of error feedback: codes, scales and residuals bit-equal at
  every step (no code differs by one: the port divides by the 0-d scale,
  as the reference's ``g32 / scale``, and both round half to even).
* ``compressed_bytes`` equal for every scheme; an unknown scheme raises.
* The reference's ``tests/test_compression.py`` bounds, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_stub import given, settings, st

from repro.distributed import compression as jcomp

from repro_torch.distributed import compression as comp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(seed: int, scale: float = 1.0):
    """A nested tree of f32 leaves of mixed magnitudes, with ties: values
    at exactly half a quantization step and zeros."""
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal(4097)).astype(np.float32)
    a[:8] = np.float32(scale) * np.array([0, 0.5, -0.5, 1.5, -2.5, 127.5,
                                          -127, 0], np.float32) / 127
    return {"a": a,
            "b": {"c": (scale * 1e-3 * rng.standard_normal((33, 65))
                        ).astype(np.float32),
                  "d": np.zeros((5,), np.float32)}}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree) if not isinstance(tree, torch.Tensor)
            else tree.numpy()}


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(
        {4: np.uint32, 2: np.uint16, 1: np.uint8}[x.dtype.itemsize])


def _assert_bit_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].shape == w[k].shape, k
        assert np.array_equal(_bits(g[k]), _bits(w[k])), k


SEEDS = [(0, 1.0), (1, 1e-3), (2, 1e3), (3, 7.5)]


@pytest.mark.parametrize("seed,scale", SEEDS)
def test_bf16_bit_equal(seed, scale):
    tree = _np_tree(seed, scale)
    got = comp.compress_bf16(_torch(tree))
    want = jcomp.compress_bf16(_jax(tree))
    _assert_bit_equal(
        jax.tree_util.tree_map(lambda x: x.view(torch.int16), got,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)),
        jax.tree_util.tree_map(lambda x: np.asarray(x).view(np.int16), want))
    _assert_bit_equal(comp.decompress_bf16(got), jcomp.decompress_bf16(want))


@pytest.mark.parametrize("seed,scale", SEEDS)
def test_int8_codes_and_scales_bit_equal(seed, scale):
    tree = _np_tree(seed, scale)
    got = comp.compress_int8(_torch(tree))
    want = jcomp.compress_int8(_jax(tree))
    _assert_bit_equal(got["q"], want["q"])
    _assert_bit_equal(got["scale"], want["scale"])
    for s in _flat(got["scale"]).values():
        assert s.shape == () and s.dtype == np.float32
    for q in _flat(got["q"]).values():
        assert q.dtype == np.int8
    _assert_bit_equal(comp.decompress_int8(got), jcomp.decompress_int8(want))


@pytest.mark.parametrize("seed,scale", SEEDS)
def test_error_feedback_five_steps_bit_equal(seed, scale):
    """Each step's gradient is a fresh draw; codes, scales and residuals
    equal at every step (0 codes off by one)."""
    trees = [_np_tree(seed * 10 + i, scale) for i in range(5)]
    e = comp.init_error_feedback(_torch(trees[0]))
    je = jcomp.init_error_feedback(_jax(trees[0]))
    _assert_bit_equal(e, je)
    for tree in trees:
        c, e = comp.compress_with_error_feedback(_torch(tree), e)
        jc, je = jcomp.compress_with_error_feedback(_jax(tree), je)
        _assert_bit_equal(c["q"], jc["q"])
        _assert_bit_equal(c["scale"], jc["scale"])
        _assert_bit_equal(e, je)


@pytest.mark.parametrize("scheme", ["none", "bf16", "int8_ef"])
def test_compressed_bytes_equal(scheme):
    tree = _np_tree(0)
    got = comp.compressed_bytes(_torch(tree), scheme)
    assert got == jcomp.compressed_bytes(_jax(tree), scheme)
    n = 4097 + 33 * 65 + 5
    assert got == {"none": 4 * n, "bf16": 2 * n, "int8_ef": n + 12}[scheme]


def test_unknown_scheme_raises_as_reference():
    with pytest.raises(ValueError):
        comp.compressed_bytes(_torch(_np_tree(0)), "fp4")
    with pytest.raises(ValueError):
        jcomp.compressed_bytes(_jax(_np_tree(0)), "fp4")


def test_a_bare_tensor_is_one_leaf():
    g = torch.from_numpy(_np_tree(4)["a"])
    c = comp.compress_int8(g)
    jc = jcomp.compress_int8(jnp.asarray(g.numpy()))
    assert np.array_equal(c["q"].numpy(), np.asarray(jc["q"]))
    assert c["scale"].item() == float(jc["scale"])
    assert comp.compressed_bytes(g, "int8_ef") == g.numel() + 4


# ---------------------------------------------------------------------------
# The reference's bounds (tests/test_compression.py), on the port
# ---------------------------------------------------------------------------


def test_bf16_roundtrip_error():
    t = _torch(_np_tree(0))
    rt = comp.decompress_bf16(comp.compress_bf16(t))
    for k, v in _flat(t).items():
        np.testing.assert_allclose(v, _flat(rt)[k], rtol=1e-2)


@given(scale=st.floats(1e-3, 1e3))
@settings(max_examples=10, deadline=None)
def test_int8_error_bound(scale):
    """Quantization error <= scale_step/2 = max|g|/254 per element."""
    t = _torch(_np_tree(5, scale))
    rt = comp.decompress_int8(comp.compress_int8(t))
    for k, a in _flat(t).items():
        bound = float(np.abs(a).max()) / 127.0 * 0.51
        assert float(np.abs(a - _flat(rt)[k]).max()) <= bound + 1e-9


def test_error_feedback_telescopes():
    """sum_t deq(q_t) -> sum_t g_t: the applied total differs from the
    true sum only by the final residual."""
    grads = [_torch(_np_tree(i)) for i in range(20)]
    e = comp.init_error_feedback(grads[0])
    applied = {k: np.zeros_like(v) for k, v in _flat(grads[0]).items()}
    true = {k: np.zeros_like(v) for k, v in _flat(grads[0]).items()}
    for g in grads:
        c, e = comp.compress_with_error_feedback(g, e)
        deq, flat_g = _flat(comp.decompress_int8(c)), _flat(g)
        for k in applied:
            applied[k] = applied[k] + deq[k]
            true[k] = true[k] + flat_g[k]
    for k, r in _flat(e).items():
        np.testing.assert_allclose(applied[k], true[k] - r, rtol=1e-4,
                                   atol=1e-5)
        assert float(np.abs(r).max()) < 0.2
