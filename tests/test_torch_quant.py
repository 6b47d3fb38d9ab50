"""repro_torch.core.quant and the scalar folds against the JAX reference.

Inputs are made with numpy from a fixed seed and handed to both packages.
Codes must match bit for bit, and so must every value that goes through
``exp``: the port's ``quant.exp`` is XLA's float32 exp, and the folds,
``dequantize_int`` and ``decode_output`` take the reference's order of
operations. ``init_scale`` goes through a float32 ``log``, which torch
rounds differently from XLA by an ulp (ROADMAP C11), so it is held to 2 ulp
of relative error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops

EXP_RTOL = 2.4e-7  # 2 ulp of float32 around 1


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_n_levels(bits):
    assert tq.n_levels(bits) == jq.n_levels(bits)


def test_n_levels_rejects_one_bit():
    with pytest.raises(ValueError):
        tq.n_levels(1)


@pytest.mark.parametrize("args", [(), (2, 4), (2, 4, 4, True), (8, 8, 8, False),
                                  (None, 5)])
def test_quant_config_label(args):
    t, j = tq.QuantConfig(*args), jq.QuantConfig(*args)
    assert t.label() == j.label()
    assert t.is_fp == j.is_fp


def test_bounds():
    assert (tq.WEIGHT_BOUND, tq.RELU_BOUND) == (jq.WEIGHT_BOUND, jq.RELU_BOUND)


def test_round_is_half_to_even():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(v)))


@pytest.mark.parametrize("bits,b,s", [(2, -1.0, 0.0), (4, 0.0, 0.0),
                                      (4, -1.0, -0.3), (8, -1.0, 0.7)])
def test_quantize_to_int_bit_exact(bits, b, s):
    rng = np.random.default_rng(bits * 10 + int(s * 10))
    x = (rng.standard_normal((64, 33)) * 1.5).astype(np.float32)
    # half-LSB ties at s = 0 (e^0 = 1 exactly in both frameworks)
    n = jq.n_levels(bits)
    x.reshape(-1)[: 2 * n] = (np.arange(-n, n) + 0.5) / n
    s32 = np.float32(s)
    want = np.asarray(jq.quantize_to_int(jnp.asarray(x), jnp.float32(s32),
                                         bits=bits, b=b))
    got = tq.quantize_to_int(torch.from_numpy(x), torch.tensor(s32),
                             bits=bits, b=b)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_dequantize_int():
    """Bit-exact: e^s by quant.exp (XLA's), the division tensor by tensor."""
    codes = np.arange(-7, 8, dtype=np.int8)
    for s in np.random.default_rng(3).uniform(-6, 3, 50).astype(np.float32):
        want = np.asarray(jq.dequantize_int(jnp.asarray(codes),
                                            jnp.float32(s), bits=4))
        got = tq.dequantize_int(torch.from_numpy(codes), torch.tensor(s),
                                bits=4)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_decode_output_bit_exact():
    """integer_inference.decode_output, e^s / n * codes in the reference's
    order, bit for bit at every code of 4 and 8 bits and 200 scales, both
    computing the scale and taking it carried (``decode_scale``)."""
    from repro.core import integer_inference as jii
    from repro_torch.core import integer_inference as tii
    rng = np.random.default_rng(4)
    for bits in (4, 8):
        n = jq.n_levels(bits)
        codes = np.arange(-n, n + 1, dtype=np.int8)
        for s in rng.uniform(-8, 4, 100).astype(np.float32):
            want = np.asarray(jii.decode_output(jnp.asarray(codes),
                                                jnp.float32(s), bits))
            got = tii.decode_output(torch.from_numpy(codes), torch.tensor(s),
                                    bits)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
            got = tii.decode_output(
                torch.from_numpy(codes), None, bits,
                scale=tii.decode_scale(torch.tensor(s), bits))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("scale", [1e-12, 0.3, 40.0])
def test_init_scale(scale):
    x = np.random.default_rng(7).standard_normal((40, 25)).astype(np.float32)
    x *= np.float32(scale)
    want = np.asarray(jq.init_scale(jnp.asarray(x)))
    got = tq.init_scale(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=EXP_RTOL, atol=0)


@pytest.mark.parametrize("s", [(0.2, -0.4, 0.1), (-1.3, -2.0, -2.3),
                               (0.0, 0.0, 0.0)])
def test_fold_scalars_within_exp_ulps(s):
    """The folds are the reference's bit for bit (0 ulp): e^s by quant.exp,
    the reference's order of operations, divisions tensor by tensor; at the
    given scales and at 300 random triples, over two bit-width configs."""
    rng = np.random.default_rng(5)
    triples = [s] + [tuple(v) for v in rng.uniform(-4, 2, (300, 3))]
    for kw in (dict(bits_a=4, bits_w=2), dict(bits_a=8, bits_w=4)):
        for t in triples:
            s_a, s_w, s_out = (np.float32(v) for v in t)
            want_r = np.asarray(jops.fold_rescale(
                *(jnp.float32(v) for v in (s_a, s_w, s_out)), bits_out=4,
                **kw))
            got_r = tops.fold_rescale(
                *(torch.tensor(v) for v in (s_a, s_w, s_out)), bits_out=4,
                **kw)
            np.testing.assert_array_equal(_bits(got_r.numpy()),
                                          _bits(want_r))
            want_a = np.asarray(jops.fold_alpha(jnp.float32(s_a),
                                                jnp.float32(s_w), **kw))
            got_a = tops.fold_alpha(torch.tensor(s_a), torch.tensor(s_w),
                                    **kw)
            np.testing.assert_array_equal(_bits(got_a.numpy()),
                                          _bits(want_a))
            assert got_r.dtype == got_a.dtype == torch.float32
