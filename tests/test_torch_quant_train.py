"""The training side of repro_torch.core.quant and core.noise against the
JAX reference: ``exp``, ``learned_quantize`` (forward and straight-through
gradients, ties included), ``ste_round``, ``_grad_scale``, ``lsb``,
``add_lsb_noise`` and ``init_scale``.

Inputs are made with numpy from fixed seeds; the reference runs eagerly.
The port's ``quant.exp`` is XLA's float32 exp bit for bit, so e^s is the
reference's for every s and the quantizer's forward is held bit for bit,
with no s chosen to dodge a rounding difference.

Tolerances, stated beside each assert:
  * forwards: bit-exact; the noise draws (C4) are counted;
  * x gradients: bit-exact (the same graph of the same float32 operations);
  * the s gradient sums N per-element terms in another order:
    |port - reference| <= 4 sqrt(N) eps M, M = sum of the terms' magnitudes
    (a random walk of N roundings of at most eps M each, at 4 sigma).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import quant as jq
from repro_torch import interop, tree
from repro_torch.core import noise as tnoise
from repro_torch.core import quant as tq

EPS = float(np.finfo(np.float32).eps)
N = 4096


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_exp_is_xla_exp_bit_for_bit():
    rng = np.random.default_rng(0)
    # C10's two edge bands: (88.376, 88.722], where XLA stays finite past
    # Cephes' clamp, and [-87.68, -87.34], where XLA flushes results below
    # FLT_MIN to 0
    x = np.concatenate([rng.uniform(-20, 20, 100_000),
                        rng.uniform(-3, 3, 100_000),
                        rng.uniform(88.376, 88.7228, 20_000),
                        rng.uniform(-87.68, -87.34, 20_000),
                        [0.0, -0.0, 1.0, -1.0, 88.0, -87.0, 88.3763,
                         88.72283, 88.7229, 89.0, -87.3365, -87.3366,
                         -88.4, -110.0, np.inf, -np.inf]]).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    got = tq.exp(_t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # torch.exp is not: the fault C1 this takes out of training
    assert (torch.exp(_t(x)).numpy() != want).mean() > 0.01
    s = torch.tensor(0.3, requires_grad=True)
    e = tq.exp(s)
    e.backward()
    assert float(s.grad) == float(e.detach())  # d e^s / ds = e^s, as jax's JVP


@pytest.mark.parametrize("b", [-1.0, 0.0])
@pytest.mark.parametrize("bits", range(2, 9))
def test_learned_quantize_forward_and_grads(bits, b):
    rng = np.random.default_rng(bits * 10 + int(b))
    for s in rng.uniform(-2.5, 1.5, 6).astype(np.float32):
        x = (rng.standard_normal(N) * np.exp(s) * 1.2).astype(np.float32)
        r = rng.standard_normal(N).astype(np.float32)
        jx, js = jnp.asarray(x), jnp.asarray(s)

        def f(xx, ss):
            return jnp.sum(jq.learned_quantize(xx, ss, bits=bits, b=b)
                           * jnp.asarray(r))
        want = np.asarray(jq.learned_quantize(jx, js, bits=bits, b=b))
        jgx, jgs = jax.grad(f, argnums=(0, 1))(jx, js)
        tx, ts = _t(x).requires_grad_(True), torch.tensor(s).requires_grad_()
        q = tq.learned_quantize(tx, ts, bits=bits, b=b)
        gx, gs = torch.autograd.grad(torch.sum(q * _t(r)), (tx, ts))
        # forward: bit for bit
        np.testing.assert_array_equal(q.detach().numpy(), want)
        # x gradient: the same float32 operations, bit for bit
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
        # s gradient: N terms g r (Q - x [inside]) summed in another order
        g = 1.0 / math.sqrt(N * tq.n_levels(bits))
        m = g * np.sum(np.abs(r) * (np.abs(want) + np.abs(x)), dtype=np.float64)
        assert abs(float(gs) - float(jgs)) <= 4 * math.sqrt(N) * EPS * m, \
            (s, float(gs), float(jgs), m)


@pytest.mark.parametrize("stabilize", [True, False])
@pytest.mark.parametrize("b", [-1.0, 0.0])
def test_tie_gradients_are_the_references_half(b, stabilize):
    """x on a clip bound (x = 0 at b = 0, x = b e^s, x = e^s): jnp.clip
    passes half the gradient there, and so must the port; torch.clamp
    would pass all of it."""
    bits = 4
    r = np.array([1.0, -2.0, 0.5, 3.0, 1.5, 0.25], np.float32)
    for s in np.array([-1.2, 0.0, 0.37, 1.1], np.float32):
        # each framework's own e^s (the same bits: quant.exp)
        e = np.asarray(jnp.exp(jnp.asarray(s)))
        x = np.array([b * e, e, 0.0, 0.5 * e, 2.0 * e, -2.0 * e],
                     np.float32)

        def f(xx, ss):
            return jnp.sum(jq.learned_quantize(xx, ss, bits=bits, b=b,
                                               stabilize=stabilize)
                           * jnp.asarray(r))
        jgx, jgs = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(s))
        tx, ts = _t(x).requires_grad_(True), torch.tensor(s).requires_grad_()
        q = tq.learned_quantize(tx, ts, bits=bits, b=b, stabilize=stabilize)
        gx, gs = torch.autograd.grad(torch.sum(q * _t(r)), (tx, ts))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
        # the bounds (and x = 0 on the ReLU bound) pass half
        assert float(gx[0]) == 0.5 * r[0] and float(gx[1]) == 0.5 * r[1]
        if b == 0.0:
            assert float(gx[2]) == 0.5 * r[2]
        # six terms in another order: a few roundings of at most eps M
        g = 1.0 / math.sqrt(x.size * tq.n_levels(bits)) if stabilize else 1.0
        m = g * float(np.sum(np.abs(r) * (np.abs(q.detach().numpy())
                                          + np.abs(x)), dtype=np.float64))
        assert abs(float(gs) - float(jgs)) <= x.size * EPS * m, \
            (float(gs), float(jgs), m)
    # the clamp the port does not use would pass all of it
    clamped = torch.tensor([0.0, 1.0], requires_grad=True)
    torch.clamp(clamped, 0.0, 1.0).sum().backward()
    assert clamped.grad.tolist() == [1.0, 1.0]


def test_learned_quantize_full_precision_is_identity():
    x = torch.randn(7)
    s = torch.tensor(0.0)
    assert tq.learned_quantize(x, s, bits=None, b=-1.0) is x
    assert tq.learned_quantize(x, s, bits=32, b=-1.0) is x


def test_ste_round_and_grad_scale_are_the_references():
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(20_000) * 3).astype(np.float32)
    np.testing.assert_array_equal(tq.ste_round(_t(v)).numpy(),
                                  np.asarray(jq.ste_round(jnp.asarray(v))))
    tv = _t(v).requires_grad_(True)
    tq.ste_round(tv).sum().backward()
    assert torch.equal(tv.grad, torch.ones_like(tv))
    moved = 0
    for g in (1.0 / math.sqrt(4096 * 7), 1.0 / math.sqrt(13 * 1), 0.3):
        want = np.asarray(jq._grad_scale(jnp.asarray(v), g))
        got = tq._grad_scale(_t(v), g).numpy()
        np.testing.assert_array_equal(got, want)
        moved += int((want != v).sum())
        tv = _t(v).requires_grad_(True)
        tq._grad_scale(tv, g).sum().backward()
        assert torch.equal(tv.grad, torch.full_like(tv, np.float32(g)))
    # not an identity in float32: the port keeps the expression
    assert moved > 0


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lsb_bit_exact(bits):
    s = np.random.default_rng(bits).uniform(-4, 2, 64).astype(np.float32)
    want = np.asarray(jq.lsb(jnp.asarray(s), bits))
    np.testing.assert_array_equal(tq.lsb(_t(s), bits).numpy(), want)


@pytest.mark.parametrize("sigma", [0.3, 1.5])
@pytest.mark.parametrize("bits", [2, 4])
def test_add_lsb_noise_with_carried_keys(sigma, bits):
    """The reference's draw from the same key: the normals agree but for
    a few ulp in ~5% of draws (C4), counted; the gradients are the
    reference's (x: 1; s: the noise itself, summed)."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((8, 33, 7)).astype(np.float32)
    s = np.float32(-0.7)
    jk = jax.random.PRNGKey(bits + 100)
    key = interop.key_from_numpy(np.asarray(jk), device="cpu")
    want = np.asarray(jnoise.add_lsb_noise(jnp.asarray(x), jk, sigma,
                                           jnp.asarray(s), bits))
    tx, ts = _t(x).requires_grad_(True), torch.tensor(s).requires_grad_()
    got = tnoise.add_lsb_noise(tx, key, sigma, ts, bits)
    noise = want - x
    differ = got.detach().numpy() != want
    # normals a few ulp apart (C4): sigma * lsb * 4.8e-7, plus x's ulp
    step = float(np.asarray(jq.lsb(jnp.asarray(s), bits)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=sigma * step * 4.8e-7
                               + 2 * EPS * np.abs(want).max())
    print(f"add_lsb_noise bits={bits} sigma={sigma}: {int(differ.sum())} of "
          f"{differ.size} outputs differ in the last bits (C4)")
    assert differ.mean() <= 0.1
    assert np.abs(noise).max() > 0
    gx, gs = torch.autograd.grad(torch.sum(got), (tx, ts))
    assert torch.equal(gx, torch.ones_like(gx))
    jgs = jax.grad(lambda ss: jnp.sum(jnoise.add_lsb_noise(
        jnp.asarray(x), jk, sigma, ss, bits)))(jnp.asarray(s))
    m = float(np.abs(noise).sum())
    assert abs(float(gs) - float(jgs)) <= 4 * math.sqrt(x.size) * EPS * m \
        + 1e-6 * m
    # a no-op without a key, without sigma, or at full precision
    for args in ((None, sigma, bits), (key, 0.0, bits), (key, sigma, None)):
        assert tnoise.add_lsb_noise(tx, args[0], args[1], ts, args[2]) is tx


@pytest.mark.parametrize("percentile", [100.0, 99.0, 37.5])
def test_init_scale_matches_reference(percentile):
    """e^s covers max|x| or a percentile (jnp.percentile's linear
    interpolation, in its float32 steps: bit-exact before the log). The
    log: the port's is correctly rounded and taken on the host, XLA's is
    1 ulp off in ~9% of inputs: s within 1 ulp."""
    x = np.random.default_rng(7).standard_normal((64, 45, 3)).astype(
        np.float32)
    a = np.abs(x)
    if percentile < 100:
        np.testing.assert_array_equal(
            tq._percentile(_t(a).flatten(), percentile).numpy(),
            np.asarray(jnp.percentile(jnp.asarray(a), percentile)))
    want = np.float32(np.asarray(jq.init_scale(jnp.asarray(x),
                                               percentile=percentile)))
    got = np.float32(tq.init_scale(_t(x), percentile=percentile).numpy())
    assert abs(float(got) - float(want)) <= float(np.spacing(abs(want)))


def test_percentile_past_torch_quantile_limit():
    """2^24 + 3 elements (torch.quantile refuses more than 2^24): the
    kthvalue path gives jnp.percentile's value."""
    n = 2 ** 24 + 3
    a = np.random.default_rng(8).random(n, dtype=np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(_t(a), 0.99)
    got = tq._percentile(_t(a), 99.0).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnp.percentile(jnp.asarray(a), 99.0)))


def test_value_and_grad_over_a_param_tree():
    p = {"a": {"w": torch.ones(3), "s": torch.tensor(0.5)},
         "b": torch.zeros(2)}
    f = tree.value_and_grad(
        lambda pp, x: ((pp["a"]["w"] * x).sum() + pp["a"]["s"] ** 2, "aux"),
        has_aux=True)
    (v, aux), g = f(p, 2.0)
    assert float(v) == 6.25 and aux == "aux" and not v.requires_grad
    assert g["a"]["w"].tolist() == [2.0] * 3 and float(g["a"]["s"]) == 1.0
    assert torch.equal(g["b"], torch.zeros(2))  # unused: zeros, as in JAX
    assert not p["a"]["w"].requires_grad
    # sorted keys, as jax.tree orders a dict
    assert [tuple(t.shape) for t in tree.leaves(p)] == [(), (3,), (2,)]
