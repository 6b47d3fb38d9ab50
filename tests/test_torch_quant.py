"""repro_torch.core.quant and the scalar folds against the JAX reference.

Inputs are made with numpy from a fixed seed and handed to both packages.
Codes must match bit for bit. Where a value goes through ``exp`` in float32
the two frameworks may round differently by one ulp (XLA's exp is not
torch's), so those compares allow 2 ulp of relative error.
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


def test_dequantize_int():
    codes = np.arange(-7, 8, dtype=np.int8)
    s = np.float32(0.37)
    want = np.asarray(jq.dequantize_int(jnp.asarray(codes), jnp.float32(s),
                                        bits=4))
    got = tq.dequantize_int(torch.from_numpy(codes), torch.tensor(s), bits=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=EXP_RTOL, atol=0)


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
    s_a, s_w, s_out = (np.float32(v) for v in s)
    kw = dict(bits_a=4, bits_w=2)
    want_r = np.asarray(jops.fold_rescale(*(jnp.float32(v) for v in
                                           (s_a, s_w, s_out)), bits_out=4,
                                          **kw))
    got_r = tops.fold_rescale(*(torch.tensor(v) for v in (s_a, s_w, s_out)),
                              bits_out=4, **kw)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=EXP_RTOL, atol=0)
    want_a = np.asarray(jops.fold_alpha(jnp.float32(s_a), jnp.float32(s_w),
                                        **kw))
    got_a = tops.fold_alpha(torch.tensor(s_a), torch.tensor(s_w), **kw)
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=EXP_RTOL, atol=0)
    assert got_r.dtype == got_a.dtype == torch.float32
