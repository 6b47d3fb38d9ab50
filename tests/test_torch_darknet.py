"""The DarkNet-19 integer serving slice of repro_torch against the JAX
reference.

Two configurations: ``reduced`` at 16x16 (batch 2) and ``full`` (the paper's
channel widths, all 17 integer convs) at 64x64 (batch 1); at 32x32 the last
five convs would see 1x1 maps. Both are built on the JAX side with a live
stand-in recipe (:func:`_live_standin`) and carried into the port bit for bit
with ``interop.stack_from_numpy``, with the reference's own entry
``inv_scale``. The repo's uniform stand-in (one ``s_out`` for every layer)
is not used: on the full-width net it gives all-zero codes from conv12 or
conv13 on, and a parity test on such a stack checks nothing there.

The reference runs its im2col impl (its fused Pallas conv does not trace on
current jax); the port runs on ``device="cpu"``, through the plain versions.
The ternary twin of each stack (``convert_int(weight_format="auto")``, from
the same calibrated params) is carried and checked the same way.

Tolerances:
  * stack, entry codes (given the same float pre-entry activations) and
    the integer core (given the same entry codes): bit-exact;
  * FP conv0 + float pool: 1e-5 x max|h|, float32 sums in another order;
  * ``int_apply`` logits: 1e-4 x max|logit|. The head is a float32 sum over
    up to 1,024 channels in another order, and torch's conv0 can flip an
    entry code sitting on a rounding boundary; the message counts flips.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fq_layers as jfql
from repro.core import integer_inference as jii
from repro.core.quant import (QuantConfig as JQuantConfig, RELU_BOUND,
                              WEIGHT_BOUND, n_levels, quantize_to_int)
from repro.kernels import ops as jops
from repro.models import darknet as jdn
from repro_torch import interop
from repro_torch.core import fq_layers as tfql
from repro_torch.core import integer_inference as tii
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.models import darknet as tdn

JQCFG = JQuantConfig(2, 4, 4, fq=True)
QCFG = QuantConfig(2, 4, 4, fq=True)
# name: (reference cfg, port cfg, image size, batch)
CFGS = {"reduced": (jdn.DarkNetConfig.reduced(), tdn.DarkNetConfig.reduced(),
                    16, 2),
        "full": (jdn.DarkNetConfig(), tdn.DarkNetConfig(), 64, 1)}
LIVE_FRACTION = 0.05


def _np(tree):
    """jax arrays -> numpy, leaving python statics (ints, strings) alone."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _images(name, seed=17, batch=None):
    _, _, size, b = CFGS[name]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch or b, size, size, 3)).astype(np.float32)


def _ref_pre_entry(conv0, x, jcfg):
    """The reference int_apply's float prefix: FP conv0 and float pools."""
    plan = jdn.layer_plan(jcfg)
    h = jnp.asarray(x)
    for step in plan[:jdn._split_plan(plan)]:
        if step[0] == "fp_conv":
            h = jfql.fq_conv2d(conv0, h, JQuantConfig(fq=True),
                               padding="SAME", b_in=WEIGHT_BOUND)
        else:
            h = -jax.lax.reduce_window(-h, jnp.inf, jax.lax.min,
                                       (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    return h


def _q99_positive(a):
    a = np.asarray(a, np.float64)
    return np.quantile(a[a > 0], 0.99)


def _live_standin(jcfg, x):
    """init -> to_fq -> per-layer accumulator calibration on images ``x``.

    conv1's s_in covers the 99th percentile of the positive pre-entry
    activations; then, layer by layer in plan order, s_out = s_in + s_w +
    log(q99(acc > 0) / (n_a n_w)) from the exact int32 accumulator of the
    current codes, handed off to the next layer's s_in, and the layer runs
    to give the next codes.
    """
    params, state = jdn.init(jax.random.key(0), jcfg)
    params = jdn.to_fq(params, state, jcfg)
    n_a, n_w = n_levels(JQCFG.bits_a), n_levels(JQCFG.bits_w)
    h = _ref_pre_entry(params["conv0"], x, jcfg)
    s_in = jnp.log(jnp.float32(_q99_positive(h)))
    codes = jii.entry_codes(h, {"s_in": s_in}, JQCFG, b_in=RELU_BOUND)
    plan = jdn.layer_plan(jcfg)
    for step in plan[jdn._split_plan(plan):]:
        if step[0] == "pool":
            codes = jii.int_maxpool2d(codes)
            continue
        _, name, ks, pooled = step
        p = dict(params[name], s_in=s_in)
        w_codes = quantize_to_int(p["w"], p["s_w"], bits=JQCFG.bits_w,
                                  b=WEIGHT_BOUND).reshape(-1, p["w"].shape[-1])
        acc = jops.fq_conv2d_int(codes, w_codes, jnp.float32(1.0), ksize=ks,
                                 padding=ks // 2, epilogue="dequant",
                                 impl="im2col")
        p["s_out"] = s_in + p["s_w"] + jnp.log(
            jnp.float32(_q99_positive(acc) / (n_a * n_w)))
        params[name] = p
        run = jii.int_conv2d_pool if pooled else jii.int_conv2d
        codes = run(jii.convert_layer(p, JQCFG, name=name), codes, ksize=ks,
                    padding=ks // 2, impl="im2col")
        s_in = p["s_out"]
    return params, state, jdn.convert_int(params, state, JQCFG, jcfg)


@functools.lru_cache(maxsize=None)
def _reference(name):
    jcfg = CFGS[name][0]
    return _live_standin(jcfg, _images(name, seed=5, batch=2))


@functools.lru_cache(maxsize=None)
def _carried(name):
    ip = _reference(name)[2]
    return interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=np.asarray(jnp.exp(-ip["entry"]["s_in"])),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_entry(name):
    """(float pre-entry activations, entry codes) of the reference."""
    ip, jcfg = _reference(name)[2], CFGS[name][0]
    h = _ref_pre_entry(ip["conv0"], _images(name), jcfg)
    return np.array(h), np.array(
        jii.entry_codes(h, ip["entry"], JQCFG, b_in=RELU_BOUND))


@functools.lru_cache(maxsize=None)
def _ref_core(name):
    ip, jcfg = _reference(name)[2], CFGS[name][0]
    codes = jnp.asarray(_ref_entry(name)[1])
    return np.asarray(jdn.int_core(ip, codes, JQCFG, jcfg, impl="im2col"))


def _port_layer_outputs(st, codes, cfg):
    """Each integer conv's output codes, walking the port's plan."""
    outs = {}
    plan = tdn.layer_plan(cfg)
    for step in plan[tdn._split_plan(plan):]:
        if step[0] == "pool":
            codes = tii.int_maxpool2d(codes)
            continue
        _, name, ks, pooled = step
        run = tii.int_conv2d_pool if pooled else tii.int_conv2d
        codes = outs[name] = run(st[name], codes, ksize=ks, padding=ks // 2)
    return outs


@pytest.mark.parametrize("name", list(CFGS))
def test_layer_plan_matches_reference(name):
    jcfg, tcfg, _, _ = CFGS[name]
    for fuse in (True, False):
        assert tdn.layer_plan(tcfg, fuse) == jdn.layer_plan(jcfg, fuse)
    assert tdn.int_conv_names(tcfg) == jdn.int_conv_names(jcfg)
    n_int = len([l for l in jcfg.layers if l != "M"]) - 1
    assert len(tdn.int_conv_names(tcfg)) == n_int


@pytest.mark.parametrize("name", list(CFGS))
def test_stack_carried_bit_for_bit(name):
    ip, st = _reference(name)[2], _carried(name)
    assert st.layer_names == ip.layer_names
    assert st.qcfg == QCFG and st.device == torch.device("cpu")
    for n in ip.layer_names:
        ref, got = ip.layers[n], st.layers[n]
        assert got["w_codes"].dtype == torch.int8
        np.testing.assert_array_equal(got["w_codes"].numpy(),
                                      np.asarray(ref["w_codes"]))
        for k in ("rescale", "s_out"):
            assert got[k].dtype == torch.float32
            assert got[k].numpy().tobytes() == np.asarray(ref[k]).tobytes()
        for k in ("n_out", "lo", "n_w", "n_a", "weight_format"):
            assert got[k] == ref[k]
    for edge in ("conv0", "head"):
        for k in ("w", "s_w", "s_in", "s_out"):
            assert st[edge][k].numpy().tobytes() == \
                np.asarray(ip[edge][k]).tobytes()
    assert st["s_out_last"].numpy().tobytes() == \
        np.asarray(ip["s_out_last"]).tobytes()
    assert st["entry"]["s_in"].numpy().tobytes() == \
        np.asarray(ip["entry"]["s_in"]).tobytes()


@pytest.mark.parametrize("name", list(CFGS))
def test_entry_codes_bit_exact(name):
    h, want = _ref_entry(name)
    got = tii.entry_codes(torch.from_numpy(h), _carried(name)["entry"], QCFG,
                          b_in=RELU_BOUND)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("fuse_pool", [True, False])
@pytest.mark.parametrize("impl", ["fused", "im2col", None])
def test_int_core_bit_exact(name, impl, fuse_pool):
    jcfg, tcfg, size, batch = CFGS[name]
    codes = torch.from_numpy(_ref_entry(name)[1])
    got = tdn.int_core(_carried(name), codes, QCFG, tcfg, impl=impl,
                       fuse_pool=fuse_pool)
    n_pool = jcfg.layers.count("M")
    cout = [l for l in jcfg.layers if l != "M"][-1][1]
    side = size >> n_pool
    assert got.dtype == torch.int8
    assert got.shape == (batch, side, side, cout)
    np.testing.assert_array_equal(got.numpy(), _ref_core(name))


@pytest.mark.parametrize("name", list(CFGS))
def test_fuse_pool_equals_conv_then_pool(name):
    st, tcfg = _carried(name), CFGS[name][1]
    codes = torch.from_numpy(_ref_entry(name)[1])
    for impl in ("fused", "im2col"):
        fused = tdn.int_core(st, codes, QCFG, tcfg, impl=impl)
        unfused = tdn.int_core(st, codes, QCFG, tcfg, impl=impl,
                               fuse_pool=False)
        assert torch.equal(fused, unfused)


@pytest.mark.parametrize("name", list(CFGS))
def test_every_integer_layer_is_live(name):
    """The live stand-in keeps codes nonzero in every layer (the uniform
    s_out recipe would not), so the parity tests above check every layer."""
    st, tcfg = _carried(name), CFGS[name][1]
    outs = _port_layer_outputs(st, torch.from_numpy(_ref_entry(name)[1]),
                               tcfg)
    assert list(outs) == tdn.int_conv_names(tcfg)
    live = {n: float((c != 0).double().mean()) for n, c in outs.items()}
    dead = {n: f for n, f in live.items() if f <= LIVE_FRACTION}
    assert not dead, f"layers with <= {LIVE_FRACTION} nonzero codes: {dead}"


@pytest.mark.parametrize("name", list(CFGS))
def test_fp_conv0_and_float_pool_within_tolerance(name):
    st, tcfg = _carried(name), CFGS[name][1]
    want = _ref_entry(name)[0]
    h = tfql.fq_conv2d(st["conv0"], torch.from_numpy(_images(name)),
                       QuantConfig(fq=True), padding="SAME",
                       b_in=WEIGHT_BOUND)
    got = tops.maxpool2d(h)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("ksize,stride,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (2, 1, "SAME"), (1, 1, "SAME"),
    (3, 1, "VALID")])
def test_float_fq_conv2d_matches_reference(ksize, stride, padding):
    """The float mode of fq_conv2d, with XLA's SAME padding (asymmetric for
    even kernels and strides > 1), within 1e-5 x max|y|."""
    rng = np.random.default_rng(ksize * 10 + stride)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize, 3, 5)).astype(np.float32)
    want = np.asarray(jfql.fq_conv2d({"w": jnp.asarray(w)}, jnp.asarray(x),
                                     JQuantConfig(), stride=stride,
                                     padding=padding))
    got = tfql.fq_conv2d({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                         QuantConfig(), stride=stride, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", list(CFGS))
def test_int_apply_logits_within_tolerance(name):
    ip, st = _reference(name)[2], _carried(name)
    jcfg, tcfg, _, batch = CFGS[name]
    x = _images(name)
    want = np.asarray(jdn.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                    impl="im2col"))
    got = tdn.int_apply(st, torch.from_numpy(x), QCFG, tcfg)
    h = tops.maxpool2d(tfql.fq_conv2d(st["conv0"], torch.from_numpy(x),
                                      QuantConfig(fq=True)))
    port_codes = tii.entry_codes(h, st["entry"], QCFG).numpy()
    ref_codes = _ref_entry(name)[1]
    flipped = int((port_codes != ref_codes).sum())
    assert got.shape == (batch, jcfg.num_classes)
    assert torch.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
        err_msg=f"{flipped} of {ref_codes.size} entry codes flipped")


@pytest.mark.parametrize("name", list(CFGS))
def test_port_conversion_matches_reference(name):
    """The port's own convert_int on the reference's float params: weight
    codes, folded rescales, the entry's e^{-s_in} and the carried decode
    scale e^{s_out_last} / n byte-equal to the reference's (quant.exp is
    XLA's exp)."""
    fq_params, state, ip = _reference(name)
    params, st = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    stack = tdn.convert_int(params, st, QCFG, CFGS[name][1])
    assert stack.layer_names == ip.layer_names
    for n in ip.layer_names:
        np.testing.assert_array_equal(stack[n]["w_codes"].numpy(),
                                      np.asarray(ip[n]["w_codes"]))
        assert (stack[n]["rescale"].numpy().tobytes()
                == np.asarray(ip[n]["rescale"]).tobytes()), n
    assert (stack["entry"]["inv_scale"].numpy().tobytes() == np.asarray(
        jnp.exp(-ip["entry"]["s_in"])).tobytes())
    assert (stack["decode_scale"].numpy().tobytes() == np.asarray(
        jnp.exp(ip["s_out_last"]) / n_levels(QCFG.bits_out)).tobytes())


@pytest.mark.parametrize("name", list(CFGS))
def test_port_conversion_codes_match_reference(name):
    """The port-converted stack against the reference's, from the same entry
    codes: every layer's output codes counted, and none may differ (the
    folded scalars of the two conversions must flip no code)."""
    fq_params, state, ip = _reference(name)
    jcfg, tcfg, _, _ = CFGS[name]
    params, st = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    stack = tdn.convert_int(params, st, QCFG, tcfg)
    entry = _ref_entry(name)[1]
    got = _port_layer_outputs(stack, torch.from_numpy(entry), tcfg)
    plan = jdn.layer_plan(jcfg)
    codes, differ = jnp.asarray(entry), {}
    for step in plan[jdn._split_plan(plan):]:
        if step[0] == "pool":
            codes = jii.int_maxpool2d(codes)
            continue
        _, layer, ks, pooled = step
        run = jii.int_conv2d_pool if pooled else jii.int_conv2d
        codes = run(ip[layer], codes, ksize=ks, padding=ks // 2,
                    impl="im2col")
        differ[layer] = int((got[layer].numpy() != np.asarray(codes)).sum())
    assert list(differ) == list(got)
    assert sum(differ.values()) == 0, differ


def test_int_serve_fn_takes_numpy_requests():
    st, tcfg = _carried("reduced"), CFGS["reduced"][1]
    x = _images("reduced")
    got = tdn.int_serve_fn(st, QCFG, tcfg, impl="fused")(x[:1])
    assert torch.equal(got, tdn.int_apply(st, torch.from_numpy(x[:1]), QCFG,
                                          tcfg, impl="fused"))


def test_port_builds_and_serves_its_own_reduced_stack():
    """init -> to_fq -> the smoke run's live calibration -> convert_int,
    all in the port, on the CPU."""
    import chip_smoke
    cfg = tdn.DarkNetConfig.reduced()
    calib = torch.from_numpy(_images("reduced", seed=5))
    stack, live = chip_smoke.darknet_live_stack(torch, cfg, QCFG, calib,
                                                device="cpu")
    assert stack.device == torch.device("cpu")
    assert list(live) == tdn.int_conv_names(cfg)
    assert min(live.values()) > LIVE_FRACTION, live
    assert set(stack["conv1"]["w_codes"].unique().tolist()) <= {-1, 0, 1}
    x = _images("reduced")
    logits = tdn.int_serve_fn(stack, QCFG, cfg)(x)
    assert logits.shape == (x.shape[0], cfg.num_classes)
    assert torch.isfinite(logits).all() and logits.abs().max() > 0
    for impl in ("fused", "im2col"):
        for fuse_pool in (True, False):
            assert torch.equal(logits, tdn.int_apply(
                stack, torch.from_numpy(x), QCFG, cfg, impl=impl,
                fuse_pool=fuse_pool))


@functools.lru_cache(maxsize=None)
def _ternary(name):
    """(reference ternary stack, the port's carried copy)."""
    fq_params, state, _ = _reference(name)
    ip = jdn.convert_int(fq_params, state, JQCFG, CFGS[name][0],
                         weight_format="auto")
    return ip, interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=np.asarray(jnp.exp(-ip["entry"]["s_in"])),
        device="cpu")


@pytest.mark.parametrize("name", list(CFGS))
def test_ternary_stack_carried_bit_for_bit(name):
    """Every cin here is a multiple of 4, so the ternary stack is a quarter
    of the int8 one's bytes; the digests equal the reference's."""
    ip, st = _ternary(name)
    ip8 = _reference(name)[2]
    for n in ip.layer_names:
        assert st[n]["w_codes"].dtype == torch.uint8
        np.testing.assert_array_equal(st[n]["w_codes"].numpy(),
                                      np.asarray(ip[n]["w_codes"]))
        assert 4 * st[n]["w_codes"].numel() == _carried(name)[n][
            "w_codes"].numel()
    assert tii.stack_digest(st) == jii.stack_digest(ip)
    assert tii.stack_digest(_carried(name)) == jii.stack_digest(ip8)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("fuse_pool", [True, False])
@pytest.mark.parametrize("impl", ["fused", "im2col"])
def test_ternary_int_core_bit_exact(name, impl, fuse_pool):
    ip, st = _ternary(name)
    jcfg, tcfg, _, _ = CFGS[name]
    codes = _ref_entry(name)[1]
    want = _ref_core(name)
    if impl == "im2col" and fuse_pool:  # the reference's ternary oracle
        want = np.asarray(jdn.int_core(ip, jnp.asarray(codes), JQCFG, jcfg,
                                       impl="im2col"))
        np.testing.assert_array_equal(want, _ref_core(name))
    got = tdn.int_core(st, torch.from_numpy(codes), QCFG, tcfg, impl=impl,
                       fuse_pool=fuse_pool)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CFGS))
def test_ternary_logits_within_tolerance(name):
    ip, st = _ternary(name)
    jcfg, tcfg, _, batch = CFGS[name]
    x = _images(name)
    want = np.asarray(jdn.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                    impl="im2col"))
    got = tdn.int_apply(st, torch.from_numpy(x), QCFG, tcfg)
    assert got.shape == (batch, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_noise_quantized_modes_and_packed_served():
    """The quantized float modes (Q and FQ) of ``fq_conv2d`` give the
    reference's outputs on the carried params. Noise runs: the noisy logits
    of the carried stack equal the reference's given the same key, under
    every impl and pool fusion. The packed formats are served: a packed
    stack serves the int8 stack's logits under every impl, its noisy logits
    are the same under every impl, and an unknown format raises."""
    from repro.core.noise import TABLE7_CONDITIONS
    from repro_torch.core.noise import NoiseConfig
    st, (jcfg, tcfg, _, _) = _carried("reduced"), CFGS["reduced"]
    ip = _reference("reduced")[2]
    x = _images("reduced")
    jk = jax.random.PRNGKey(7)
    key = interop.key_from_numpy(np.asarray(jk), device="cpu")
    cond = TABLE7_CONDITIONS[-1]
    noise = NoiseConfig(cond.sigma_w, cond.sigma_a, cond.sigma_mac)
    want = np.asarray(jdn.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                    impl="im2col", noise=cond, rng=jk))
    x = torch.from_numpy(x)
    for impl in ("fused", "im2col"):
        for fuse_pool in (True, False):
            got = tdn.int_apply(st, x, QCFG, tcfg, impl=impl,
                                fuse_pool=fuse_pool, noise=noise, rng=key)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
    fq_params, state, _ = _reference("reduced")
    params, bn = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    want = tdn.int_apply(tdn.convert_int(params, bn, QCFG, tcfg), x, QCFG,
                         tcfg)
    for fmt in ("ternary", "int4"):
        packed = tdn.convert_int(params, bn, QCFG, tcfg, weight_format=fmt)
        assert packed["conv1"]["w_codes"].dtype == torch.uint8
        noisy = tdn.int_apply(packed, x, QCFG, tcfg, noise=noise, rng=key)
        for impl in ("fused", "im2col"):
            for fuse_pool in (True, False):
                assert torch.equal(tdn.int_apply(
                    packed, x, QCFG, tcfg, impl=impl, fuse_pool=fuse_pool),
                    want)
                assert torch.equal(tdn.int_apply(
                    packed, x, QCFG, tcfg, impl=impl, fuse_pool=fuse_pool,
                    noise=noise, rng=key), noisy)
    with pytest.raises(ValueError):
        tdn.convert_int(params, bn, QCFG, tcfg, weight_format="int2")
    # Q and FQ mode: float32 conv sums in another order (1e-5 x max|y|);
    # in FQ mode an output on a rounding boundary may flip a code, counted
    # and bounded at 1e-4 of the outputs
    for jq in (JQuantConfig(2, 4), JQCFG):
        want = np.asarray(jfql.fq_conv2d(fq_params["conv0"], jnp.asarray(
            x.numpy()), jq, padding="SAME", b_in=WEIGHT_BOUND,
            relu_out=True))
        got = tfql.fq_conv2d(params["conv0"], x, QuantConfig(
            jq.bits_w, jq.bits_a, jq.bits_out, jq.fq), padding="SAME",
            b_in=WEIGHT_BOUND, relu_out=True).numpy()
        off = np.abs(got - want) > 1e-5 * np.abs(want).max()
        assert got.shape == want.shape and off.mean() <= 1e-4, off.sum()
