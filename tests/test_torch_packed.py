"""Packed weight formats (int4, ternary) of repro_torch against the JAX
reference, on the same numpy inputs.

Covered: the packing helpers of ``core.quant`` (bytes), the packed operands
of K2/K3/K3b through ``kernels.ops`` (plain versions on the CPU), packed
conversion, ``ConvertedStack.rederive`` and ``stack_digest``. The serving
slices on ternary stacks (KWS reduced and full, DarkNet-19's live stand-in)
are checked in ``test_torch_kws.py`` and ``test_torch_darknet.py``, beside
the reference stacks those files already build. The reference's kernels
run as its own tests run them on the CPU: ``fq_matmul`` in interpret mode,
convs through ``ops.*(impl="im2col")``, its parity oracle.

Tolerances:
  * packed bytes, unpacked codes, kernel outputs (int8 codes, and f32
    dequant values: one float32 product of the same int32 and scale),
    digests: exact;
  * folded rescales of the port's own conversion: 2.4e-7 relative, as in
    ``test_torch_darknet.py`` (torch's float32 ``exp`` is not XLA's).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integer_inference as jii
from repro.core import quant as jq
from repro.core.quant import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.kernels.fq_matmul import fq_matmul as j_fq_matmul
from repro_torch import interop
from repro_torch import kernels as tkernels
from repro_torch.core import integer_inference as tii
from repro_torch.core import quant as tq
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.models import kws as tkws

PACKED = ("int4", "ternary")
JQCFG = JQuantConfig(2, 4, 4, fq=True)
QCFG = QuantConfig(2, 4, 4, fq=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    """jax arrays -> numpy, leaving python statics (ints, strings) alone."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _all_codes(rows: int, fmt: str) -> np.ndarray:
    """(rows, 2r+1) int8 codes in which every column holds each
    representable code of ``fmt`` once per 2r+1 rows."""
    r = tq.format_range(fmt)
    i, j = np.meshgrid(np.arange(rows), np.arange(2 * r + 1), indexing="ij")
    return ((i + j) % (2 * r + 1) - r).astype(np.int8)


def _codes(rng, shape, lo, hi):
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# core.quant: formats and byte layout
# ---------------------------------------------------------------------------


def test_format_helpers_match_reference():
    for fmt in jq.WEIGHT_FORMATS:
        assert tq.format_factor(fmt) == jq.format_factor(fmt)
        assert tq.format_range(fmt) == jq.format_range(fmt)
        assert tq.format_interval(fmt) == jq.format_interval(fmt)
    assert tq.WEIGHT_FORMATS == jq.WEIGHT_FORMATS
    for n_w in range(0, 130):
        assert tq.auto_weight_format(n_w) == jq.auto_weight_format(n_w)
    for fn in (tq.format_factor, tq.format_range, tq.format_interval):
        with pytest.raises(ValueError):
            fn("int2")


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("rows", [1, 5, 45])
def test_pack_bytes_match_reference(fmt, rows):
    codes = _all_codes(rows, fmt)
    want = np.asarray(jq.pack_codes(jnp.asarray(codes), fmt))
    got = tq.pack_codes(_t(codes), fmt)
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tq.unpack_codes(got, fmt, rows=rows)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), codes)
    assert not tq.unpack_codes(got, fmt)[rows:].any()  # pad rows decode to 0


@pytest.mark.parametrize("fmt", PACKED)
def test_unpack_every_byte_matches_reference(fmt):
    """All 256 bytes, including fields the quantizer never emits (-2 for
    ternary, -8 for int4): the sign extension is the reference's."""
    every = np.arange(256, dtype=np.uint8).reshape(64, 4)
    got = tq.unpack_codes(_t(every), fmt).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jq.unpack_codes(jnp.asarray(every), fmt)))
    lo, hi = tq.format_interval(fmt)
    assert got.min() == lo and got.max() == hi


@pytest.mark.parametrize("fmt", PACKED)
@pytest.mark.parametrize("taps,cin", [(3, 5), (9, 45)])
def test_pack_im2col_matches_reference(fmt, taps, cin):
    rng = np.random.default_rng(taps * 100 + cin)
    r = tq.format_range(fmt)
    w = _codes(rng, (taps * cin, 7), -r, r)
    want = np.asarray(jq.pack_im2col_codes(jnp.asarray(w), taps, fmt))
    got = tq.pack_im2col_codes(_t(w), taps, fmt)
    cin_p = -(-cin // tq.format_factor(fmt)) * tq.format_factor(fmt)
    assert tuple(got.shape) == (taps * cin_p // tq.format_factor(fmt), 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tq.unpack_im2col_codes(got, taps, cin, fmt).numpy(), w)
    np.testing.assert_array_equal(
        tq.unpack_im2col_codes(got, taps, cin, fmt).numpy(),
        np.asarray(jq.unpack_im2col_codes(jnp.asarray(want), taps, cin,
                                          fmt)))


@pytest.mark.parametrize("fmt", PACKED)
def test_out_of_range_codes_raise(fmt):
    r = tq.format_range(fmt)
    for bad in (r + 1, -r - 1):
        codes = np.zeros((5, 3), np.int8)
        codes[2, 1] = bad
        with pytest.raises(ValueError, match="out of range"):
            tq.pack_codes(_t(codes), fmt)
        with pytest.raises(ValueError):
            jq.pack_codes(jnp.asarray(codes), fmt)
    with pytest.raises(ValueError):
        tq.pack_codes(torch.zeros(2, 3, 4, dtype=torch.int8), fmt)


# ---------------------------------------------------------------------------
# K2 / K3 / K3b on packed operands (plain versions on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,k", [("int4", 13), ("ternary", 135)])
def test_int_matmul_packed_matches_reference(fmt, k):
    """K not a multiple of the factor: the pad rows of pack_codes are inert."""
    rng = np.random.default_rng(k)
    r = tq.format_range(fmt)
    a = _codes(rng, (19, k), -7, 7)
    w = _codes(rng, (k, 45), -r, r)
    packed = np.asarray(jq.pack_codes(jnp.asarray(w), fmt))
    scale = np.float32(1.7e-3)
    for epilogue, lo in (("requant", -7), ("dequant", 0)):
        want = np.asarray(j_fq_matmul(
            jnp.asarray(a), jnp.asarray(packed), jnp.float32(scale),
            epilogue=epilogue, n_out=7, lo=lo, interpret=True,
            weight_format=fmt))
        got = tops.int_matmul(_t(a), _t(packed), torch.tensor(scale),
                              epilogue=epilogue, n_out=7, lo=lo,
                              weight_format=fmt)
        np.testing.assert_array_equal(got.numpy(), want)


CONV1D = dict(ksize=3, dilation=4, n_out=7, lo=0)
CONV2D = dict(ksize=3, stride=1, padding=1, n_out=7, lo=-7)


@functools.lru_cache(maxsize=None)
def _conv_case(fmt, cin):
    """Packed conv operands with ragged cin and the reference's im2col
    outputs: conv1d, conv2d, and conv2d + 2x2 and 3x3 max-pool."""
    rng = np.random.default_rng(cin)
    r = tq.format_range(fmt)
    scale = np.float32(0.0131)
    a1 = _codes(rng, (2, 21, cin), 0, 7)
    w1 = np.asarray(jq.pack_im2col_codes(
        jnp.asarray(_codes(rng, (3 * cin, 6), -r, r)), 3, fmt))
    a2 = _codes(rng, (2, 9, 11, cin), 0, 7)
    w2 = np.asarray(jq.pack_im2col_codes(
        jnp.asarray(_codes(rng, (9 * cin, 5), -r, r)), 9, fmt))
    j = dict(impl="im2col", weight_format=fmt)
    want = {"conv1d": np.asarray(jops.fq_conv1d_int(
        jnp.asarray(a1), jnp.asarray(w1), jnp.float32(scale), **CONV1D, **j)),
            "conv2d": np.asarray(jops.fq_conv2d_int(
        jnp.asarray(a2), jnp.asarray(w2), jnp.float32(scale), **CONV2D, **j))}
    for pool in (2, 3):
        want[pool] = np.asarray(jops.fq_conv2d_pool_int(
            jnp.asarray(a2), jnp.asarray(w2), jnp.float32(scale), pool=pool,
            **CONV2D, **j))
    return scale, (a1, w1), (a2, w2), want


RAGGED = [("int4", 5), ("ternary", 5), ("ternary", 45)]


@pytest.mark.parametrize("fmt,cin", RAGGED)
@pytest.mark.parametrize("impl", ["fused", "im2col"])
def test_fq_conv1d_packed_matches_reference(fmt, cin, impl):
    scale, (a, w), _, want = _conv_case(fmt, cin)
    got = tops.fq_conv1d_int(_t(a), _t(w), torch.tensor(scale), impl=impl,
                             weight_format=fmt, **CONV1D)
    np.testing.assert_array_equal(got.numpy(), want["conv1d"])


@pytest.mark.parametrize("fmt,cin", RAGGED)
@pytest.mark.parametrize("impl", ["fused", "im2col"])
def test_fq_conv2d_and_pool_packed_match_reference(fmt, cin, impl):
    scale, _, (a, w), want = _conv_case(fmt, cin)
    kw = dict(impl=impl, weight_format=fmt, **CONV2D)
    got = tops.fq_conv2d_int(_t(a), _t(w), torch.tensor(scale), **kw)
    np.testing.assert_array_equal(got.numpy(), want["conv2d"])
    for pool in (2, 3):
        got = tops.fq_conv2d_pool_int(_t(a), _t(w), torch.tensor(scale),
                                      pool=pool, **kw)
        np.testing.assert_array_equal(got.numpy(), want[pool])


def test_packed_calls_on_the_cpu_launch_no_kernel():
    tkernels.reset_launch_counts()
    a = torch.zeros(1, 6, 6, 5, dtype=torch.int8)
    w = tq.pack_im2col_codes(torch.zeros(45, 3, dtype=torch.int8), 9,
                             "ternary")
    tops.fq_conv2d_pool_int(a, w, torch.tensor(0.1), ksize=3, padding=1,
                            impl="fused", weight_format="ternary")
    tops.int_matmul(a[0, 0], tq.pack_codes(torch.zeros(5, 3,
                                                       dtype=torch.int8),
                                           "int4"),
                    torch.tensor(0.1), weight_format="int4")
    assert set(tkernels.launch_counts().values()) == {0}
    counts = tkernels.packed_launch_counts()
    assert set(counts) == {f"{k}_{f}" for k in ("fq_matmul", "fq_conv2d",
                                                "fq_conv2d_pool")
                           for f in PACKED}
    assert set(counts.values()) == {0}


# ---------------------------------------------------------------------------
# Conversion, rederive, digest
# ---------------------------------------------------------------------------


def _layer_params(rng, wshape):
    return {"w": rng.standard_normal(wshape).astype(np.float32) * 0.3,
            "s_w": np.float32(-0.4), "s_in": np.float32(0.2),
            "s_out": np.float32(0.1)}


@pytest.mark.parametrize("fmt,wshape", [
    ("int8", (3, 5, 4)), ("ternary", (3, 5, 4)), ("int4", (3, 3, 45, 6)),
    ("ternary", (13, 6)), ("int4", (13, 6))])
def test_convert_layer_bytes_match_reference(fmt, wshape):
    """Conv weights pack per tap, linear weights flat."""
    qcfg, jqcfg = QuantConfig(2, 4, 4, fq=True), JQCFG
    p = _layer_params(np.random.default_rng(len(wshape)), wshape)
    want = jii.convert_layer({k: jnp.asarray(v) for k, v in p.items()},
                             jqcfg, weight_format=fmt)
    got = tii.convert_layer({k: _t(v) for k, v in p.items()}, qcfg,
                            weight_format=fmt)
    assert got["weight_format"] == want["weight_format"] == fmt
    assert got["w_codes"].dtype == (torch.int8 if fmt == "int8"
                                    else torch.uint8)
    np.testing.assert_array_equal(got["w_codes"].numpy(),
                                  np.asarray(want["w_codes"]))
    np.testing.assert_allclose(got["rescale"].numpy(),
                               np.asarray(want["rescale"]), rtol=2.4e-7,
                               atol=0)
    for k in ("n_out", "lo", "n_w", "n_a"):
        assert got[k] == want[k]


@pytest.mark.parametrize("fmt", PACKED)
def test_int_linear_threads_the_packed_format(fmt):
    """A packed linear layer (flat pack, K = 13 ragged) serves the int8
    layer's codes and dequant values through int_linear(_final)."""
    rng = np.random.default_rng(4)
    p = {k: _t(v) for k, v in _layer_params(rng, (13, 6)).items()}
    codes = _t(_codes(rng, (5, 13), 0, 7))
    for final, run in ((False, tii.int_linear), (True, tii.int_linear_final)):
        packed = tii.convert_layer(p, QCFG, final=final, weight_format=fmt)
        assert packed["w_codes"].dtype == torch.uint8
        want = run(tii.convert_layer(p, QCFG, final=final), codes)
        assert torch.equal(run(packed, codes), want)


def test_convert_layer_refuses_too_narrow_a_format():
    p = _layer_params(np.random.default_rng(0), (3, 5, 4))
    for bits_w, fmt in ((4, "ternary"), (8, "int4"), (8, "ternary")):
        with pytest.raises(ValueError, match="refusing to clip"):
            tii.convert_layer({k: _t(v) for k, v in p.items()},
                              QuantConfig(bits_w, 4, 4, fq=True),
                              weight_format=fmt)
        with pytest.raises(ValueError):
            jii.convert_layer({k: jnp.asarray(v) for k, v in p.items()},
                              JQuantConfig(bits_w, 4, 4, fq=True),
                              weight_format=fmt)
    with pytest.raises(ValueError, match="unknown weight_format"):
        tii.convert_layer({k: _t(v) for k, v in p.items()}, QCFG,
                          weight_format="int2")


def _port_kws_stack(weight_format=None):
    cfg = tkws.KWSConfig.reduced()
    params, state = tkws.init(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    params = tkws.to_fq(params, state, cfg)
    names = tkws.conv_names(cfg)
    for n in names:
        params[n] = {**params[n], "s_out": torch.tensor(0.1)}
    params = tii.sync_handoff(params, names)
    return params, tkws.convert_int(params, state, QCFG, cfg,
                                    weight_format=weight_format)


def test_convert_stack_auto_records_format_and_rederive_is_idempotent():
    params, int8 = _port_kws_stack()
    _, auto = _port_kws_stack("auto")
    assert {s.weight_format for s in int8.specs} == {"int8"}
    assert {s.weight_format for s in auto.specs} == {"ternary"}
    assert tii.stack_digest(auto) != tii.stack_digest(int8)
    for stack in (int8, auto):
        again = stack.rederive({n: params[n] for n in stack.layer_names})
        assert again.specs == stack.specs
        assert tii.stack_digest(again) == tii.stack_digest(stack)
        for n in stack.layer_names:
            for k, v in stack[n].items():
                w = again[n][k]
                assert (torch.equal(w, v) if isinstance(v, torch.Tensor)
                        else w == v), (n, k)
        assert torch.equal(again["entry"]["inv_scale"],
                           stack["entry"]["inv_scale"])
        assert torch.equal(again["decode_scale"], stack["decode_scale"])
    moved = {n: {**params[n], "w": params[n]["w"] * 2}
             for n in auto.layer_names}
    assert tii.stack_digest(auto.rederive(moved)) != tii.stack_digest(auto)
    bad = {**params, "conv1": {**params["conv1"], "s_in": torch.tensor(0.5)}}
    with pytest.raises(ValueError, match="hand-off"):
        auto.rederive(bad)


def test_stack_digest_is_device_and_copy_invariant():
    _, stack = _port_kws_stack("ternary")
    assert tii.stack_digest(stack.to("cpu")) == tii.stack_digest(stack)


# ---------------------------------------------------------------------------
# stack_digest of stacks carried from the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_stack(fmt):
    """A small reference chain: two conv1d layers and a linear one, with
    KWS-shaped extras (a dense layer, a BN tuple, the entry and decode
    scales), converted to ``fmt``."""
    rng = np.random.default_rng(9)
    shapes = {"conv0": (3, 5, 6), "conv1": (3, 6, 6), "fc": (6, 4)}
    params = {n: {k: jnp.asarray(v) for k, v in
                  _layer_params(rng, shape).items()}
              for n, shape in shapes.items()}
    for a, b in zip(shapes, list(shapes)[1:]):
        params[b]["s_in"] = params[a]["s_out"]
    f32 = lambda *shape: jnp.asarray(rng.standard_normal(shape), jnp.float32)
    extras = {"embed": {"w": f32(3, 5), "b": f32(5)},
              "embed_bn": ({"scale": f32(5), "bias": f32(5)},
                           {"mean": f32(5), "var": f32(5)}),
              "entry": {"s_in": params["conv0"]["s_in"]},
              "s_out_last": params["fc"]["s_out"]}
    specs = [jii.LayerSpec(n) for n in shapes]
    return jii.convert_stack(params, JQCFG, specs=specs, extras=extras,
                             weight_format=fmt)


def _carry(ip):
    return interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=np.asarray(jnp.exp(-ip["entry"]["s_in"])),
        device="cpu")


@pytest.mark.parametrize("fmt", ["int8", "int4", "ternary"])
def test_stack_digest_of_carried_stack_matches_reference(fmt):
    ip = _reference_stack(fmt)
    assert {s.weight_format for s in ip.specs} == {fmt}
    st = _carry(ip)
    assert "inv_scale" in st["entry"]
    assert tii.stack_digest(st) == jii.stack_digest(ip)
    digests = {jii.stack_digest(_reference_stack(f))
               for f in ("int8", "int4", "ternary")}
    assert len(digests) == 3


def test_interop_refuses_mismatched_formats():
    ip = _reference_stack("ternary")
    layers = _np(ip.layers)
    specs = _reference_stack("int8").specs
    with pytest.raises(ValueError, match="format"):
        interop.stack_from_numpy(layers, _np(ip.extras), ip.qcfg, specs,
                                 device="cpu")
    wrong = {**layers, "conv0": {**layers["conv0"], "w_codes": layers[
        "conv0"]["w_codes"].astype(np.int8)}}
    with pytest.raises(ValueError, match="uint8"):
        interop.stack_from_numpy(wrong, _np(ip.extras), ip.qcfg, ip.specs,
                                 device="cpu")
