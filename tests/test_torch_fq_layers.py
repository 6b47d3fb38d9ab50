"""repro_torch.core.fq_layers in its quantized and training modes against the
JAX reference: ``fq_linear``, ``fq_conv1d`` and ``fq_conv2d`` in FP, Q and
FQ modes with and without the §4.4 noise (forwards and VJPs), training BN,
and ``calibrate``.

The reference runs eagerly (un-jitted): jit lets XLA fuse the float edges,
which moves them by an ulp (C-ref-3). Weights and keys are carried with
``interop``; the port computes e^s with ``quant.exp``, XLA's float32 exp
bit for bit, so given the same operands both quantize to the same codes.

Where the two frameworks sum in another order (a conv, a BN statistic), a
quantizer's input can land on the other side of a rounding boundary (a
*code flip*) or on a clip bound in one framework and not in the other (a
*tie flip*: the straight-through gradient is 0.5 at a bound, 1 inside and
0 outside; discrete codes times weights make exact ties common), and a
(leaky) ReLU's input on the other side of 0 (a *ReLU flip*: gradient 1 on
one side, 0 or 0.1 on the other; a BN output 0 in exact arithmetic, as
every output of a channel whose conv outputs are all equal is, a common
case under 2-bit weights and activations, takes its sign from rounding).
``hold_against_reference`` counts them at every quantizer and
ReLU with ``repro_torch.taps`` (the taps ``chip_smoke.py`` holds the card
against the CPU with), then runs the port again with those inputs pinned
to the reference's values (the value pinned, the gradient passed through;
a ReLU flip only where both inputs lie within rounding of 0), so that the
gradients are held against the reference's on the same forward.
Tolerances, stated beside each assert:

  * codes: bit-exact given the same operands; code flips <= 1e-4 of the
    positions (the expectation is 0); tie flips are counted and reported;
  * ReLU flips: <= 1e-3 of the ReLU inputs (full-width ResNet-20, Q W2A2,
    reads 3.1e-4), each within 8 float32 ulps of the call's largest
    reference input on both sides (reads <= 2.3): only those are pinned,
    a flip farther from 0 fails;
  * float outputs: 1e-5 x max|y| (float32 sums over <= 1,152 terms in
    another order, ~1e-7 relative);
  * gradients of weights (every leaf but the log-scales): 1e-4 relative L2;
  * gradients of a log-scale s: |port - reference| <= 1e-5 x M, M the sum of
    the magnitudes of the terms the gradient sums (each quantizer's
    g * sum |dL/dQ| (|Q| + |x|), g the LSQ gradient scale, plus each noise
    draw's sum |dL/dy * noise|). The gradient is a sum of cancelling
    quantization errors, so its own value says nothing about its rounding:
    float32 sums of N terms in two orders differ by ~sqrt(N) eps M, and the
    terms carry the weight gradients' ~1e-6 relative differences.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fq_layers as jfql
from repro.core import noise as jnoise
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import kws as jkws
from repro_torch import interop, tree
from repro_torch.core import fq_layers as tfql
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models import kws as tkws
from repro_torch.taps import Taps, recorded
from repro_torch.taps import value_and_grad as taps_value_and_grad

MAX_CODE_FLIPS = 1e-4   # of the quantized positions
MAX_RELU_FLIPS = 1e-3   # of the (leaky) ReLU inputs
RELU_PIN_ULPS = 8.0     # x eps x max|ReLU input|: "0 in exact arithmetic"
RTOL_FLOAT = 1e-5       # x max|y|, float32 sums in another order
RTOL_W = 1e-4           # relative L2 of a weight leaf's gradient
C_S = 1e-5              # x M, the magnitude of a log-scale's terms
COND = jnoise.TABLE7_CONDITIONS[-1]   # Table 7's noisiest condition


def port_qcfg(j):
    return QuantConfig(j.bits_w, j.bits_a, j.bits_out, j.fq)


def port_noise(c):
    return None if c is None else NoiseConfig(c.sigma_w, c.sigma_a,
                                              c.sigma_mac)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def key_pair(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, interop.key_from_numpy(np.asarray(jk), device="cpu")


# ---------------------------------------------------------------------------
# Quantizer taps (``repro_torch.taps``): the reference's side
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def reference_taps(relus=None):
    """The input of every learned quantizer the reference runs, in call
    order; under ``jax.value_and_grad`` too (a debug callback sees the
    primal values), so the reference's forward runs once. With a list
    ``relus``, the input of every ``jax.nn.relu`` and ``leaky_relu`` (the
    models' nonlinearities outside FQ) is appended to it likewise."""
    taps, orig = [], jfql.learned_quantize

    def tap(x, s, *, bits, b, stabilize=True):
        if bits is not None and bits < 32:
            jax.debug.callback(lambda v: taps.append(np.array(v)), x)
        return orig(x, s, bits=bits, b=b, stabilize=stabilize)

    def signed(fn):
        def tapped(x, *args, **kw):
            jax.debug.callback(lambda v: relus.append(np.array(v)), x)
            return fn(x, *args, **kw)
        return tapped
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jfql, "learned_quantize", tap))
        if relus is not None:
            for name in ("relu", "leaky_relu"):
                stack.enter_context(mock.patch.object(
                    jax.nn, name, signed(getattr(jax.nn, name))))
        yield taps


def hold_against_reference(ref_fn, port_fn, jparams, tparams, *,
                           zero_leaves=(), loss_scale=None, label=""):
    """``ref_fn(p) -> (loss, out)`` (jax) and ``port_fn(p) -> (loss, out)``
    (torch) on carried params: flips counted, then value and gradient of
    the port (flipped quantizer inputs pinned) held against the reference.
    ``zero_leaves``: leaves the loss does not depend on in exact arithmetic
    (a bias before a training-mode BN), held at zero. ``loss_scale(out)``:
    the magnitude of the loss's terms where they cancel. Returns a
    report."""
    rrelus = []
    with reference_taps(relus=rrelus) as rtaps:
        (jloss, jout), jgrad = jax.value_and_grad(ref_fn, has_aux=True)(
            jparams)
        jax.block_until_ready(jgrad)
    ref = recorded(calls=[np.array(a, copy=True) for a in rtaps],
                   relus=rrelus)
    # the port's own forward, its flips against the reference counted
    counted = Taps(ref, pin=False, relu_ulps=RELU_PIN_ULPS)
    with counted, torch.no_grad():
        _, tout0 = port_fn(tparams)
    counted.matched()
    # again, each flipped quantizer input and each ReLU input flipped
    # within rounding of 0 pinned to the reference's
    pinned = Taps(ref, relu_ulps=RELU_PIN_ULPS)
    (tloss, tout), tgrad = taps_value_and_grad(port_fn, tparams, pinned)
    pinned.matched()
    code_flips, tie_flips, total = (counted.code_flips, counted.tie_flips,
                                    counted.positions)
    report = dict(code_flips=code_flips, tie_flips=tie_flips,
                  positions=total, relu_flips=counted.relu_flips,
                  relu_positions=counted.relu_positions,
                  relu_far=counted.relu_far,
                  pinned=pinned.code_flips + pinned.tie_flips
                  + pinned.relu_flips - pinned.relu_far)
    print(f"\n{label}: {report}")
    # code flips: <= 1e-4 of the positions (the expectation is 0)
    assert code_flips <= MAX_CODE_FLIPS * max(total, 1), report
    # ReLU flips: <= 1e-3 of the inputs, every one within rounding of 0
    assert counted.relu_flips <= MAX_RELU_FLIPS * max(
        counted.relu_positions, 1), report
    assert counted.relu_far == 0, report
    for name, jo, to in (("unpinned", jout, tout0), ("pinned", jout, tout)):
        for a, b in zip(jax.tree_util.tree_leaves(jo),
                        tree.leaves(to)):
            a, b = np.asarray(a), b.detach().numpy()
            assert a.shape == b.shape
            # float32 sums in another order; unpinned, a counted code flip
            # moves an output by up to one LSB, so 10x more room
            tol = RTOL_FLOAT * (10 if name == "unpinned" else 1)
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=tol * np.abs(a).max() + 1e-30,
                                       err_msg=f"{label} {name} output")
    # the loss: float32 sums in another order, relative to its terms
    scale = abs(float(jloss)) if loss_scale is None else loss_scale(jout)
    assert abs(float(tloss) - float(jloss)) <= RTOL_FLOAT * scale, \
        (label, float(tloss), float(jloss))
    jflat = {".".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jgrad)}
    assert set(jflat) == set(tgrad)
    gmax = max(np.linalg.norm(v) for v in jflat.values())
    worst = {}
    for name, a in jflat.items():
        b = tgrad[name].numpy()
        leaf = name.rsplit(".", 1)[-1]
        if name in zero_leaves:
            # zero in exact arithmetic: rounding noise only, on both sides
            assert np.linalg.norm(a) <= 1e-5 * gmax, name
            assert np.linalg.norm(b) <= 1e-5 * gmax, name
            continue
        if leaf.startswith("s_"):
            err, m = float(abs(b - a)), pinned.mag.get(name, 0.0)
            worst[name] = err / m if m else err
            assert err <= C_S * m, (f"{label} {name}: {b} vs {a}, |diff| "
                                    f"{err:.3g} > {C_S} x M = {C_S * m:.3g}")
        else:
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            worst[name] = rel
            assert rel <= RTOL_W, f"{label} {name}: rel L2 {rel:.3g}"
    report["worst"] = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    return report


# ---------------------------------------------------------------------------
# The layers, FP / Q / FQ, clean and noisy
# ---------------------------------------------------------------------------

MODES = {"fp": JQuantConfig(), "q": JQuantConfig(2, 4),
         "fq": JQuantConfig(2, 4, 4, fq=True),
         "fq_w3a5": JQuantConfig(3, 5, 5, fq=True)}
LAYERS = {
    # name: (x shape, w shape, layer kwargs); few shapes, so that the
    # reference's eager ops compile once for several cases
    "linear": ((6, 5, 24), (24, 16), {}),
    "conv1d": ((2, 20, 8), (3, 8, 12), dict(dilation=2, padding="VALID")),
    "conv1d_same": ((2, 20, 8), (3, 8, 12), dict(dilation=3,
                                                 padding="SAME")),
    "conv2d": ((2, 9, 9, 8), (3, 3, 8, 12), dict(padding="SAME")),
    "conv2d_s2": ((2, 9, 9, 8), (3, 3, 8, 12), dict(stride=2,
                                                    padding="SAME")),
    "conv2d_valid": ((2, 9, 9, 8), (1, 1, 8, 12), dict(padding="VALID")),
    # strided "SAME" on an even side, as the ResNets' downsample blocks:
    # 3x3 pads (0, 1), 1x1 pads nothing
    "conv2d_s2even": ((2, 8, 8, 8), (3, 3, 8, 12), dict(stride=2,
                                                        padding="SAME")),
    "conv2d_1x1s2": ((2, 8, 8, 8), (1, 1, 8, 12), dict(stride=2,
                                                       padding="SAME")),
}


def _layer_fns(name):
    base = name.split("_")[0]
    return {"linear": (jfql.fq_linear, tfql.fq_linear),
            "conv1d": (jfql.fq_conv1d, tfql.fq_conv1d),
            "conv2d": (jfql.fq_conv2d, tfql.fq_conv2d)}[base]


def _layer_case(name, relu_in, seed=3):
    """Params and inputs, numpy. ``relu_in``: half the inputs are exact
    zeros (a quantized ReLU's b = 0 sits on them: tie gradients)."""
    xs, ws, kw = LAYERS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    if relu_in:
        x = np.maximum(x, 0)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:-1]))).astype(
        np.float32)
    fp = _layer_fns(name)[0]({"w": jnp.asarray(w)}, jnp.asarray(x),
                             JQuantConfig(), **kw)
    p = {"w": w, "s_w": np.asarray(jfql.init_scale(jnp.asarray(w))),
         "s_in": np.float32(np.log(0.7 * np.abs(x).max())),
         "s_out": np.float32(np.log(0.6 * np.abs(np.asarray(fp)).max()))}
    r = rng.standard_normal(np.asarray(fp).shape).astype(np.float32)
    return p, x, r, kw


# every layer in Q and FQ mode; FP, noise and 3-bit weights / 5-bit
# activations on some; the strided even-side convs in every mode
CASES = ([(name, mode, False) for mode in ("q", "fq") for name in LAYERS]
         + [(name, mode, False) for mode in ("fp", "fq_w3a5")
            for name in ("conv2d_s2even", "conv2d_1x1s2")]
         + [("conv2d_s2even", "fq", True)]
         + [("linear", "fp", False), ("conv2d", "fp", False),
            ("linear", "fq", True), ("conv1d", "fq", True),
            ("conv2d_s2", "fq", True), ("conv2d", "q", True),
            ("conv1d_same", "fq_w3a5", False),
            ("conv2d_valid", "fq_w3a5", True)])


@pytest.mark.parametrize(
    "name, mode, noisy", CASES,
    ids=[f"{n}-{m}-{'noisy' if z else 'clean'}" for n, m, z in CASES])
def test_layer_forward_and_vjp_match_reference(name, mode, noisy):
    jq = MODES[mode]
    relu = name != "linear"
    p, x, r, kw = _layer_case(name, relu_in=relu)
    jfn, tfn = _layer_fns(name)
    jk, tk = key_pair(11) if noisy else (None, None)
    cond = COND if noisy else None
    lk = dict(kw, b_in=0.0 if relu else -1.0, relu_out=relu)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jr, tr = jnp.asarray(r), torch.from_numpy(r)

    def ref_fn(pp):
        px, y = pp
        out = jfn(px, y, jq, noise=cond, rng=jk, **lk)
        return jnp.sum(out * jr), out

    def port_fn(pp):
        px, y = pp["p"], pp["x"]
        out = tfn(px, y, port_qcfg(jq), noise=port_noise(cond), rng=tk,
                  **lk)
        return torch.sum(out * tr), out

    jparams = ({k: jnp.asarray(v) for k, v in p.items()}, jx)
    tparams = {"p": interop.params_from_numpy(p, {}, device="cpu")[0],
               "x": tx}

    def ref_named(pp):
        return ref_fn((pp["p"], pp["x"]))
    report = hold_against_reference(
        ref_named, port_fn, {"p": jparams[0], "x": jparams[1]}, tparams,
        loss_scale=lambda out: float(np.abs(np.asarray(out) * r).sum()),
        label=f"{name} {mode} {'noisy' if noisy else 'clean'}")
    if jq.fq:
        assert report["positions"] > 0


# ---------------------------------------------------------------------------
# Training BN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 10, 6), (2, 5, 5, 7)])
def test_training_batchnorm_matches_reference(shape):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    c = shape[-1]
    p = {"gamma": rng.uniform(0.5, 2, c).astype(np.float32),
         "beta": rng.standard_normal(c).astype(np.float32)}
    st = {"mean": rng.standard_normal(c).astype(np.float32),
          "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    r = rng.standard_normal(shape).astype(np.float32)
    jp, jst = ({k: jnp.asarray(v) for k, v in d.items()} for d in (p, st))
    tp, tst = interop.params_from_numpy(p, st, device="cpu")

    def jloss(pp, y):
        out, new = jfql.batchnorm(pp, jst, y, train=True, momentum=0.8)
        return jnp.sum(out * jnp.asarray(r)), (out, new)
    (_, (jy, jnew)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, tnew = tfql.batchnorm(live, tst, xt, train=True, momentum=0.8)
    grads = torch.autograd.grad(torch.sum(ty * torch.from_numpy(r)),
                                [live["gamma"], live["beta"], xt])
    # float32 statistics summed in another order: ~1e-7 relative
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=RTOL_FLOAT * np.abs(np.asarray(jy)).max())
    for k in ("mean", "var"):
        assert not tnew[k].requires_grad
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=RTOL_FLOAT)
    for got, want in zip(grads, (jgp["gamma"], jgp["beta"], jgx)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= RTOL_W, rel
    # eval mode reads the state and returns it unchanged
    y, same = tfql.batchnorm(tp, tst, torch.from_numpy(x))
    assert same is tst
    jy_eval, _ = jfql.batchnorm(jp, jst, jnp.asarray(x), train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy_eval), rtol=0,
                               atol=RTOL_FLOAT * np.abs(y.numpy()).max())


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def test_calibrate_matches_reference(iters=3):
    """KWS (reduced), BN folded by the reference, calibrated by both on one
    batch: every s_in / s_out within 1 ulp (the port takes the float32 log
    on the host, correctly rounded; XLA's log is 1 ulp off in ~9% of
    inputs). The observed maxima are equal but for a code flip, counted."""
    jcfg, tcfg = jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced()
    qcfg = JQuantConfig(2, 4, 4, fq=True)
    jp, js = jkws.init(jax.random.PRNGKey(4), jcfg)
    jfq = jkws.to_fq(jp, js, jcfg)
    x = np.random.default_rng(6).standard_normal(
        (4, jcfg.seq_len, jcfg.n_mfcc)).astype(np.float32)
    tp, ts = interop.params_from_numpy(np_tree(jfq), np_tree(js),
                                       device="cpu")
    want = jfql.calibrate(lambda pp: jkws.apply(pp, js, jnp.asarray(x), qcfg,
                                                jcfg), jfq, iters=iters)
    got = tfql.calibrate(lambda pp: tkws.apply(pp, ts, torch.from_numpy(x),
                                               port_qcfg(qcfg), tcfg),
                         tp, iters=iters)
    n = 0
    for name in tkws.conv_names(tcfg):
        for k in ("s_in", "s_out"):
            a = np.float32(np.asarray(want[name][k]))
            b = np.float32(got[name][k].numpy())
            assert b.dtype == np.float32 and got[name][k].dim() == 0
            # 1 ulp: the log of the same observed maximum
            assert abs(float(b) - float(a)) <= float(np.spacing(abs(a))), \
                (name, k, a, b)
            n += 1
    assert n == 2 * len(tcfg.dilations)
    # the calibration recorded real ranges: s moved off its init
    assert any(float(got[nm]["s_in"]) != 0.0 for nm in tkws.conv_names(tcfg))


def test_calibration_records_by_param_dict():
    rec = {}
    p = {"w": torch.ones(2, 3), "s_w": torch.tensor(0.0),
         "s_in": torch.tensor(0.0), "s_out": torch.tensor(0.0)}
    x = torch.tensor([[0.5, -2.0]])
    with tfql.calibration(rec):
        tfql.fq_linear(p, x, QuantConfig(4, 4, 4, fq=True))
    # x quantized at scale 1, 4 bits: (0.5, -2) -> (4/7, -1); the MAC of
    # the ones-weights is -3/7
    out = float(np.float32(4) / np.float32(7) - np.float32(1))
    assert rec[id(p)] == {"in": 2.0, "out": abs(out)}
    tfql.apply_calibration({"layer": p}, rec)
    assert float(p["s_in"]) == float(np.log(np.float32(2.0)))
    assert float(p["s_out"]) == float(np.log(np.float32(abs(out))))
    # outside the context nothing is recorded
    tfql.fq_linear(p, x, QuantConfig(4, 4, 4, fq=True))
    assert len(rec) == 1


def test_taps_pin_relu_flips_only_near_zero():
    """With ``relu_ulps``, a ReLU input on the other side of 0 from the
    reference's is pinned only where both lie within that many float32
    ulps of the call's largest reference input (a 0 signed by rounding);
    a flip farther off is counted in ``relu_far`` and keeps its own value
    and gradient. Counted by ``Taps`` on the ResNets' ReLU."""
    from repro_torch.models import resnet as tres
    h = torch.tensor([3.0, 1e-7, -2e-7, -0.5, 2.0], requires_grad=True)
    ref = torch.tensor([3.0, -1e-7, 1e-7, 0.5, 2.0])
    # 8 ulps of max|ref| = 3: 8 x 2^-23 x 3 = 2.9e-6
    with Taps(recorded(relus=[ref]), relu_ulps=8.0) as t:
        y = tres._relu(h)
    assert (t.relu_flips, t.relu_far, t.relu_positions) == (3, 1, 5)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.float32([3.0, 0.0, 1e-7, 0.0, 2.0]))
    y.sum().backward()
    np.testing.assert_array_equal(h.grad.numpy(), [1, 0, 1, 0, 1])
    # without the bound every flip is pinned, the far one too
    with Taps(recorded(relus=[ref])) as t:
        y = tres._relu(h)
    assert (t.relu_flips, t.relu_far) == (3, 0)
    assert float(y[3].detach()) == 0.5
