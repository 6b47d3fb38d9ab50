"""The KWS integer serving slice of repro_torch against the JAX reference.

The reference stack is the shared trained-checkpoint stand-in
(``conftest.trained_int_params``) under QuantConfig(2, 4, 4, fq=True). It is
carried into the port bit for bit with ``interop.stack_from_numpy``,
together with the reference's own entry ``inv_scale`` (XLA's f32 ``exp`` is
not torch's). The reference runs its im2col impl, its declared parity
oracle; the port runs on ``device="cpu"``. The ternary twin of each stack
(``convert_int(weight_format="auto")``, 4 codes per byte) is carried and
checked the same way, at request batch 2.

Tolerances:
  * entry codes, given the same float input, and the integer core, given
    the same entry codes: bit-exact;
  * ``int_apply`` logits: atol 1e-5, the tolerance of the reference's own
    eager-vs-jit test. The FP embedding's 39-term dot products are summed
    in another order by torch than by XLA, which can flip an entry code
    that sits on a rounding boundary; the assertion message reports how
    many flipped.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import trained_int_params
from repro.core import fq_layers as jfql
from repro.core import integer_inference as jii
from repro.core import quant as jq
from repro.core.quant import QuantConfig as JQuantConfig, RELU_BOUND
from repro.models import kws as jkws
from repro_torch import interop
from repro_torch.core import integer_inference as tii
from repro_torch.core.quant import QuantConfig
from repro_torch.models import kws as tkws

JQCFG = JQuantConfig(2, 4, 4, fq=True)
QCFG = QuantConfig(2, 4, 4, fq=True)
CFGS = {"reduced": (jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced(), 3),
        "full": (jkws.KWSConfig(), tkws.KWSConfig(), 4)}


def _np(tree):
    """jax arrays -> numpy, leaving python statics (ints, strings) alone."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


@functools.lru_cache(maxsize=None)
def _reference(name):
    jcfg = CFGS[name][0]
    return trained_int_params(jkws, jcfg, jkws.conv_names(jcfg), JQCFG)


@functools.lru_cache(maxsize=None)
def _carried(name):
    ip = _reference(name)[2]
    return interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=np.asarray(jnp.exp(-ip["entry"]["s_in"])),
        device="cpu")


def _inputs(name):
    jcfg, _, batch = CFGS[name]
    rng = np.random.default_rng(17)
    return rng.standard_normal((batch, jcfg.seq_len, jcfg.n_mfcc)).astype(
        np.float32)


def _ref_h(ip, x):
    h = jfql.dense(ip["embed"], jnp.asarray(x))
    h, _ = jfql.batchnorm(ip["embed_bn"][0], ip["embed_bn"][1], h, train=False)
    return h


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
    np.testing.assert_array_equal(st["embed"]["w"].numpy(),
                                  np.asarray(ip["embed"]["w"]))


@pytest.mark.parametrize("name", list(CFGS))
def test_entry_codes_bit_exact(name):
    ip, st = _reference(name)[2], _carried(name)
    h = _ref_h(ip, _inputs(name))
    want = np.asarray(jii.entry_codes(h, ip["entry"], JQCFG, b_in=RELU_BOUND))
    got = tii.entry_codes(torch.from_numpy(np.array(h)), st["entry"], QCFG,
                          b_in=RELU_BOUND)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("impl", ["fused", "im2col", None])
def test_int_core_bit_exact(name, impl):
    ip, st = _reference(name)[2], _carried(name)
    jcfg, tcfg, _ = CFGS[name]
    codes = jii.entry_codes(_ref_h(ip, _inputs(name)), ip["entry"], JQCFG,
                            b_in=RELU_BOUND)
    want = np.asarray(jkws.int_core(ip, codes, JQCFG, jcfg, impl="im2col"))
    got = tkws.int_core(st, torch.from_numpy(np.array(codes)), QCFG, tcfg,
                        impl=impl)
    assert got.dtype == torch.int8
    t_out = jcfg.seq_len - (jcfg.ksize - 1) * sum(jcfg.dilations)
    assert got.shape == (codes.shape[0], t_out, jcfg.filters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CFGS))
def test_int_apply_logits_within_tolerance(name):
    ip, st = _reference(name)[2], _carried(name)
    jcfg, tcfg, _ = CFGS[name]
    x = _inputs(name)
    want = np.asarray(jkws.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                     impl="im2col"))
    got = tkws.int_apply(st, torch.from_numpy(x), QCFG, tcfg)
    # entry codes each side computes from its own FP embedding
    ref_codes = np.asarray(jii.entry_codes(_ref_h(ip, x), ip["entry"], JQCFG,
                                           b_in=RELU_BOUND))
    h = tkws.fql.dense(st["embed"], torch.from_numpy(x))
    h, _ = tkws.fql.batchnorm(*st["embed_bn"], h)
    port_codes = tii.entry_codes(h, st["entry"], QCFG).numpy()
    flipped = int((port_codes != ref_codes).sum())
    assert got.shape == (x.shape[0], jcfg.num_classes)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=1e-5,
        err_msg=f"{flipped} of {ref_codes.size} entry codes flipped")


@pytest.mark.parametrize("name", list(CFGS))
def test_fused_and_im2col_identical(name):
    st, tcfg = _carried(name), CFGS[name][1]
    x = torch.from_numpy(_inputs(name))
    fused = tkws.int_apply(st, x, QCFG, tcfg, impl="fused")
    im2col = tkws.int_apply(st, x, QCFG, tcfg, impl="im2col")
    assert torch.equal(fused, im2col)


def test_int_serve_fn_takes_numpy_requests():
    st, tcfg = _carried("reduced"), CFGS["reduced"][1]
    x = _inputs("reduced")
    fn = tkws.int_serve_fn(st, QCFG, tcfg, impl="fused")
    got = fn(x[:1])
    assert torch.equal(got, tkws.int_apply(st, torch.from_numpy(x[:1]), QCFG,
                                           tcfg, impl="fused"))


@pytest.mark.parametrize("name", list(CFGS))
def test_port_conversion_matches_reference(name):
    """The port's own convert_int on the reference's float params: weight
    codes, folded rescales, the entry's e^{-s_in} and the carried decode
    scale e^{s_out_last} / n byte-equal to the reference's (quant.exp is
    XLA's exp)."""
    fq_params, state, ip = _reference(name)
    params, st = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    stack = tkws.convert_int(params, st, QCFG, CFGS[name][1])
    for n in ip.layer_names:
        np.testing.assert_array_equal(stack[n]["w_codes"].numpy(),
                                      np.asarray(ip[n]["w_codes"]))
        assert (stack[n]["rescale"].numpy().tobytes()
                == np.asarray(ip[n]["rescale"]).tobytes()), n
    assert (stack["entry"]["inv_scale"].numpy().tobytes() == np.asarray(
        jnp.exp(-ip["entry"]["s_in"])).tobytes())
    assert (stack["decode_scale"].numpy().tobytes() == np.asarray(
        jnp.exp(ip["s_out_last"]) / jq.n_levels(QCFG.bits_out)).tobytes())


@pytest.mark.parametrize("name", list(CFGS))
def test_port_conversion_codes_match_reference(name):
    """The port-converted stack against the reference's, from the same entry
    codes: every layer's output codes counted, and none may differ (the
    folded scalars of the two conversions must flip no code)."""
    fq_params, state, ip = _reference(name)
    jcfg, tcfg, _ = CFGS[name]
    params, st = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    stack = tkws.convert_int(params, st, QCFG, tcfg)
    want = jii.entry_codes(_ref_h(ip, _inputs(name)), ip["entry"], JQCFG,
                           b_in=RELU_BOUND)
    got = torch.from_numpy(np.array(want))
    differ = {}
    for (layer, dil), (tlayer, tdil) in zip(jkws.layer_plan(jcfg),
                                            tkws.layer_plan(tcfg)):
        assert (layer, dil) == (tlayer, tdil)
        want = jii.int_conv1d(ip[layer], want, ksize=jcfg.ksize, dilation=dil,
                              impl="im2col")
        got = tii.int_conv1d(stack[layer], got, ksize=tcfg.ksize,
                             dilation=dil)
        differ[layer] = int((got.numpy() != np.asarray(want)).sum())
    assert sum(differ.values()) == 0, differ


def test_port_builds_and_serves_its_own_stack():
    """init -> to_fq -> s_out -> sync_handoff -> convert_int on the CPU."""
    cfg = tkws.KWSConfig.reduced()
    params, state = tkws.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    params = tkws.to_fq(params, state, cfg)
    names = tkws.conv_names(cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(0.1)}
    params = tii.sync_handoff(params, names)
    stack = tkws.convert_int(params, state, QCFG, cfg)
    assert set(stack.layers[names[0]]["w_codes"].unique().tolist()) <= {-1, 0, 1}
    x = torch.from_numpy(_inputs("reduced"))
    logits = tkws.int_serve_fn(stack, QCFG, cfg)(x)
    assert logits.shape == (x.shape[0], cfg.num_classes)
    assert torch.isfinite(logits).all()
    assert torch.equal(logits, tkws.int_apply(stack, x, QCFG, cfg,
                                              impl="fused"))
    with pytest.raises(ValueError, match="hand-off"):
        bad = {**params, names[1]: {**params[names[1]],
                                    "s_in": torch.tensor(0.5)}}
        tkws.convert_int(bad, state, QCFG, cfg)


@functools.lru_cache(maxsize=None)
def _ternary(name):
    """(reference ternary stack, the port's carried copy)."""
    fq_params, state, _ = _reference(name)
    ip = jkws.convert_int(fq_params, state, JQCFG, CFGS[name][0],
                          weight_format="auto")
    return ip, interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=np.asarray(jnp.exp(-ip["entry"]["s_in"])),
        device="cpu")


@pytest.mark.parametrize("name", list(CFGS))
def test_ternary_stack_carried_and_converted_bit_for_bit(name):
    """Packed bytes of the carried stack and of the port's own conversion
    equal the reference's; digests equal the reference's, and differ from
    the int8 stack's."""
    ip, st = _ternary(name)
    fq_params, state, ip8 = _reference(name)
    params, bn = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    own = tkws.convert_int(params, bn, QCFG, CFGS[name][1],
                           weight_format="auto")
    assert {s.weight_format for s in st.specs} == {"ternary"}
    assert own.specs == st.specs
    for n in ip.layer_names:
        want = np.asarray(ip[n]["w_codes"])
        assert st[n]["w_codes"].dtype == torch.uint8
        assert st[n]["weight_format"] == "ternary"
        np.testing.assert_array_equal(st[n]["w_codes"].numpy(), want)
        np.testing.assert_array_equal(own[n]["w_codes"].numpy(), want)
    assert tii.stack_digest(st) == jii.stack_digest(ip)
    assert tii.stack_digest(_carried(name)) == jii.stack_digest(ip8)
    assert tii.stack_digest(st) != tii.stack_digest(_carried(name))


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("impl", ["fused", "im2col"])
def test_ternary_int_core_bit_exact(name, impl):
    """Request batch 2: the port's int_core on the ternary stack equals the
    reference's im2col oracle on its ternary stack, and the int8 core."""
    ip, st = _ternary(name)
    jcfg, tcfg, _ = CFGS[name]
    codes = jii.entry_codes(_ref_h(ip, _inputs(name)[:2]), ip["entry"],
                            JQCFG, b_in=RELU_BOUND)
    want = np.asarray(jkws.int_core(ip, codes, JQCFG, jcfg, impl="im2col"))
    got = tkws.int_core(st, torch.from_numpy(np.array(codes)), QCFG, tcfg,
                        impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tkws.int_core(
        _carried(name), torch.from_numpy(np.array(codes)), QCFG, tcfg,
        impl=impl))


@pytest.mark.parametrize("name", list(CFGS))
def test_ternary_logits_within_tolerance(name):
    ip, st = _ternary(name)
    jcfg, tcfg, _ = CFGS[name]
    x = _inputs(name)[:2]
    want = np.asarray(jkws.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                     impl="im2col"))
    got = tkws.int_apply(st, torch.from_numpy(x), QCFG, tcfg)
    assert got.shape == (2, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_noise_refused_and_packed_formats_served():
    """Noise, once refused, now runs: the noisy logits of the carried int8
    and ternary stacks equal the reference's given the same key, under both
    impls. The packed formats are served: a packed stack serves the int8
    stack's clean logits, and an unknown format raises."""
    from repro.core.noise import TABLE7_CONDITIONS
    from repro_torch.core.noise import NoiseConfig
    jcfg, tcfg, _ = CFGS["reduced"]
    x = _inputs("reduced")
    jk = jax.random.PRNGKey(7)
    key = interop.key_from_numpy(np.asarray(jk), device="cpu")
    cond = TABLE7_CONDITIONS[-1]
    noise = NoiseConfig(cond.sigma_w, cond.sigma_a, cond.sigma_mac)
    for ip, st in ((_reference("reduced")[2], _carried("reduced")),
                   _ternary("reduced")):
        want = np.asarray(jkws.int_apply(ip, jnp.asarray(x), JQCFG, jcfg,
                                         impl="im2col", noise=cond, rng=jk))
        for impl in ("fused", "im2col"):
            got = tkws.int_apply(st, torch.from_numpy(x), QCFG, tcfg,
                                 impl=impl, noise=noise, rng=key)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert not np.array_equal(want, np.asarray(jkws.int_apply(
            ip, jnp.asarray(x), JQCFG, jcfg, impl="im2col")))
    x = torch.from_numpy(x)
    st = _carried("reduced")
    fq_params, state, _ = _reference("reduced")
    params, bn = interop.params_from_numpy(_np(fq_params), _np(state),
                                           device="cpu")
    want = tkws.int_apply(tkws.convert_int(params, bn, QCFG, tcfg), x, QCFG,
                          tcfg)
    for fmt in ("ternary", "int4", "auto"):
        packed = tkws.convert_int(params, bn, QCFG, tcfg, weight_format=fmt)
        assert packed["conv0"]["w_codes"].dtype == torch.uint8
        noisy = [tkws.int_apply(packed, x, QCFG, tcfg, impl=impl,
                                noise=noise, rng=key)
                 for impl in ("fused", "im2col")]
        assert torch.equal(noisy[0], noisy[1])
        for impl in ("fused", "im2col"):
            assert torch.equal(tkws.int_apply(packed, x, QCFG, tcfg,
                                              impl=impl), want)
    with pytest.raises(ValueError):
        tkws.convert_int(params, bn, QCFG, tcfg, weight_format="int2")
    assert torch.equal(tkws.int_apply(st, x, QCFG, tcfg), want)


def test_stack_to_device_copies_every_tensor():
    st = _carried("reduced")
    moved = st.to("cpu")
    assert moved is not st and moved.layer_names == st.layer_names
    assert torch.equal(moved["conv0"]["w_codes"], st["conv0"]["w_codes"])
    assert moved["entry"]["inv_scale"].dtype == torch.float32
