"""Deploy-QAT of the port (``core.deploy_qat``, ``qat_apply`` of both models)
against its own ``int_apply`` and against the JAX reference.

The nets are the reference's stand-ins (``conftest.trained_int_params``, as
``tests/test_deploy_qat.py`` builds them) at ``reduced()``, DarkNet on
16 x 16 images, carried into the port with ``interop``; keys with
``key_from_numpy``. The reference runs its im2col impl (C-ref-1) eagerly.

Tolerances, stated beside each assert:

  * the port's ``qat_apply`` against its own ``int_apply`` of the converted
    params: bit for bit, clean and noisy, as the reference holds its own;
  * codes layer by layer against the reference's ``qat_apply``: equal
    (clean); under noise the code-domain draws are normals, which are not
    bit-exact (C4), so differing codes are counted, at most 1e-4 of them;
  * logits: KWS 1e-5 absolute, DarkNet 1e-4 x max|logit| (the tolerances
    of ``test_torch_kws`` / ``test_torch_darknet`` for ``int_apply``);
  * gradients against the reference's ``jax.grad``: as
    ``test_torch_fq_layers.hold_against_reference`` holds them (the
    surrogate's quantizer inputs counted and pinned with
    ``repro_torch.taps``; weights 1e-4 relative L2, a log-scale's within
    1e-5 x M), and every stale inner ``s_in`` exactly 0 on both sides;
  * zero-noise weight gradients against the port's own float FQ path:
    rtol 1e-4, atol 1e-5, the reference's test of its own.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import trained_int_params
from repro.core import deploy_qat as jdq
from repro.core import distill as jdistill
from repro.core.noise import TABLE7_CONDITIONS as JCONDS
from repro.core.quant import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.models import darknet as jdn
from repro.models import kws as jkws
from repro_torch import interop, tree
from repro_torch.core import deploy_qat as tdq
from repro_torch.core import distill as tdistill
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from repro_torch.taps import Taps, recorded
from repro_torch.taps import value_and_grad as taps_value_and_grad
from test_torch_fq_layers import (C_S, MAX_CODE_FLIPS, RTOL_W, key_pair,
                                  port_noise, reference_taps)

JQCFG = JQuantConfig(2, 4, 4, fq=True)
QCFG = QuantConfig(2, 4, 4, fq=True)
NOISY = JCONDS[-1]     # Table 7's noisiest condition
MODELS = {
    # name: (reference module, port module, reference cfg, port cfg,
    #        input shape, the stand-in's s_out, logit tolerance, relative)
    "kws": (jkws, tkws, jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced(),
            (3, 24, 8), 0.1, 1e-5, False),
    "darknet": (jdn, tdn, jdn.DarkNetConfig.reduced(),
                tdn.DarkNetConfig.reduced(), (2, 16, 16, 3), 0.2, 1e-4,
                True),
}


def _np(t):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, t)


def conv_names(name):
    jm, _, jcfg = MODELS[name][:3]
    if name == "kws":
        return jkws.conv_names(jcfg)
    return [f"conv{i}" for i in range(sum(l != "M" for l in jcfg.layers))]


@functools.lru_cache(maxsize=None)
def standin(name):
    """(reference params, state; the port's params, state and its own
    converted stack of them)."""
    jm, tm, jcfg, tcfg, _, s_out = MODELS[name][:6]
    jp, js, _ = trained_int_params(jm, jcfg, conv_names(name), JQCFG,
                                   s_out=s_out)
    tp, ts = interop.params_from_numpy(_np(jp), _np(js), device="cpu")
    return jp, js, tp, ts, tm.convert_int(tp, ts, QCFG, tcfg)


def inputs(name, seed=5):
    shape = MODELS[name][4]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, MODELS[name][2].num_classes, shape[0])
    return x, y


# ---------------------------------------------------------------------------
# The port's QAT forward is its deployed integer path, bit for bit
# ---------------------------------------------------------------------------


def test_kws_qat_forward_equals_int_apply():
    """Clean, zero noise with a key, and Table 7's two noisiest conditions
    at mac_chunks 1 and 4: the cases of the reference's own test."""
    _, _, tp, ts, ip = standin("kws")
    tcfg = MODELS["kws"][3]
    x = torch.from_numpy(inputs("kws")[0])
    _, key = key_pair(11)
    cases = [(None, None, 1), (NoiseConfig(0, 0, 0), key, 1)]
    cases += [(port_noise(c), key_pair(20 + k)[1], k)
              for c in JCONDS[-2:] for k in (1, 4)]
    for nz, rng, k in cases:
        yi = tkws.int_apply(ip, x, QCFG, tcfg, noise=nz, rng=rng,
                            mac_chunks=k)
        yq = tkws.qat_apply(tp, ts, x, QCFG, tcfg, noise=nz, rng=rng,
                            mac_chunks=k)
        assert torch.equal(yi, yq), (nz, k)


@pytest.mark.parametrize("fuse_pool", [False, True])
def test_darknet_qat_forward_equals_int_apply(fuse_pool):
    _, _, tp, ts, ip = standin("darknet")
    tcfg = MODELS["darknet"][3]
    x = torch.from_numpy(inputs("darknet")[0])
    for nz, rng in ((None, None), (port_noise(NOISY), key_pair(12)[1])):
        yi = tdn.int_apply(ip, x, QCFG, tcfg, fuse_pool=fuse_pool,
                           noise=nz, rng=rng, mac_chunks=2)
        yq = tdn.qat_apply(tp, ts, x, QCFG, tcfg, fuse_pool=fuse_pool,
                           noise=nz, rng=rng, mac_chunks=2)
        assert torch.equal(yi, yq), nz


# ---------------------------------------------------------------------------
# Against the reference: codes layer by layer, logits
# ---------------------------------------------------------------------------


def record_codes(module, fn_name):
    """Wraps ``module.<fn_name>`` (a deploy-QAT unit) to keep each call's
    output codes as numpy, in call order."""
    kept, orig = [], getattr(module, fn_name)

    def unit(*args, **kw):
        h, codes = orig(*args, **kw)
        kept.append(np.array(codes.detach().numpy() if isinstance(
            codes, torch.Tensor) else codes))
        return h, codes
    return mock.patch.object(module, fn_name, unit), kept


@pytest.mark.parametrize("name,noisy", [("kws", False), ("kws", True),
                                        ("darknet", False),
                                        ("darknet", True)])
def test_codes_match_reference_layer_by_layer(name, noisy):
    jm, tm, jcfg, tcfg, _, _, tol, relative = MODELS[name]
    jp, js, tp, ts, _ = standin(name)
    x = inputs(name)[0]
    jk, tk = key_pair(13) if noisy else (None, None)
    unit = "qat_conv1d" if name == "kws" else "qat_conv2d"
    jpatch, jcodes = record_codes(jdq, unit)
    tpatch, tcodes = record_codes(tdq, unit)
    with jpatch:
        want = np.asarray(jm.qat_apply(
            jp, js, jnp.asarray(x), JQCFG, jcfg, impl="im2col",
            noise=NOISY if noisy else None, rng=jk))
    with tpatch:
        got = tm.qat_apply(tp, ts, torch.from_numpy(x), QCFG, tcfg,
                           noise=port_noise(NOISY) if noisy else None,
                           rng=tk)
    assert len(jcodes) == len(tcodes) == len(
        [s for s in tm.layer_plan(tcfg) if s[0] != "pool" and s[0] !=
         "fp_conv"])
    differ = [int((a != b).sum()) for a, b in zip(jcodes, tcodes)]
    total = sum(a.size for a in jcodes)
    if noisy:
        # normals are not bit-exact (C4): codes counted, <= 1e-4 differ
        assert sum(differ) <= 1e-4 * total, differ
    else:
        assert sum(differ) == 0, differ
    atol = tol * (np.abs(want).max() if relative else 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                               err_msg=f"codes differing per layer {differ}")


# ---------------------------------------------------------------------------
# Gradients against the reference's jax.grad
# ---------------------------------------------------------------------------


def loss_pair(name, noisy, fuse_pool=True):
    """(reference, port) cross-entropy of ``qat_apply``: fn(p) -> (loss,
    logits)."""
    jm, tm, jcfg, tcfg = MODELS[name][:4]
    _, js, _, ts, _ = standin(name)
    x, y = inputs(name)
    jk, tk = key_pair(14) if noisy else (None, None)
    kw = {} if name == "kws" else {"fuse_pool": fuse_pool}
    jy = jax.nn.one_hot(y, jcfg.num_classes)
    ty = torch.nn.functional.one_hot(torch.from_numpy(y),
                                     tcfg.num_classes).float()

    def ref(p):
        logits = jm.qat_apply(p, js, jnp.asarray(x), JQCFG, jcfg,
                              impl="im2col", noise=NOISY if noisy else None,
                              rng=jk, **kw)
        return jnp.mean(jdistill.softmax_cross_entropy(logits, jy)), logits

    def port(p):
        logits = tm.qat_apply(p, ts, torch.from_numpy(x), QCFG, tcfg,
                              noise=port_noise(NOISY) if noisy else None,
                              rng=tk, **kw)
        return torch.mean(tdistill.softmax_cross_entropy(logits, ty)), logits
    return ref, port


def stale_s_in(name):
    """The stored s_in of every inner integer layer (the surrogate reads
    the previous layer's s_out instead)."""
    tm, tcfg = MODELS[name][1], MODELS[name][3]
    names = (tkws.conv_names(tcfg) if name == "kws"
             else tdn.int_conv_names(tcfg))
    return [f"{n}.s_in" for n in names[1:]]


@pytest.mark.parametrize("name,noisy", [("kws", False), ("kws", True),
                                        ("darknet", False),
                                        ("darknet", True)])
def test_gradients_match_reference(name, noisy):
    """The reference's custom_vjp and the port's autograd.Function run the
    surrogate in the backward, layer by layer from the last: the taps see
    the same quantizer calls in the same order on both sides."""
    jp, _, tp, _, _ = standin(name)
    ref_fn, port_fn = loss_pair(name, noisy)
    with reference_taps() as rtaps:
        (jloss, jlogits), jgrad = jax.value_and_grad(ref_fn, has_aux=True)(
            jp)
        jax.block_until_ready(jgrad)
    ref = recorded(calls=[np.array(a, copy=True) for a in rtaps])
    assert len(ref.calls) == 3 * len(stale_s_in(name)) + 3
    # the port's own backward, its flips against the reference counted
    counted = Taps(ref, pin=False)
    taps_value_and_grad(port_fn, tp, counted)
    counted.matched()
    # again, each flipped quantizer input pinned to the reference's
    pinned = Taps(ref)
    (tloss, tlogits), tgrad = taps_value_and_grad(port_fn, tp, pinned)
    pinned.matched()
    report = dict(code_flips=counted.code_flips,
                  tie_flips=counted.tie_flips, positions=counted.positions)
    print(f"\n{name} noisy={noisy}: {report}")
    assert counted.code_flips <= MAX_CODE_FLIPS * counted.positions, report
    tol, relative = MODELS[name][6:]
    want = np.asarray(jlogits)
    np.testing.assert_allclose(
        tlogits.detach().numpy(), want, rtol=0,
        atol=tol * (np.abs(want).max() if relative else 1.0))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = {".".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jgrad)}
    assert set(jflat) == set(tgrad)
    for leaf in stale_s_in(name):
        # stale by design, on both sides exactly
        assert float(jflat[leaf]) == 0.0 and float(tgrad[leaf]) == 0.0, leaf
    for key, a in jflat.items():
        b = tgrad[key].numpy()
        if key.rsplit(".", 1)[-1].startswith("s_"):
            # a log-scale: within 1e-5 x M, M the magnitude of its terms
            err, m = float(abs(b - a)), pinned.mag.get(key, 0.0)
            assert err <= C_S * m, (f"{name} {key}: {b} vs {a}, |diff| "
                                    f"{err:.3g} > {C_S} x M")
        else:
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            assert rel <= RTOL_W, f"{name} {key}: rel L2 {rel:.3g}"


def test_zero_noise_weight_grads_match_float_path():
    """At zero noise the QAT backward is the float FQ path's STE chain: the
    weight and edge-layer gradients agree with ``kws.apply``'s; the scale
    gradients are tied (layer i's input quantizer is addressed through
    s_out[i-1], so g[s_out[i-1]] absorbs the float path's g[s_in[i]]), and
    the stale stored s_in get exactly 0 (the reference's test, on the
    port)."""
    _, _, tp, ts, _ = standin("kws")
    tcfg = MODELS["kws"][3]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, tcfg.seq_len, tcfg.n_mfcc)).astype(np.float32))

    def loss_qat(p):
        return torch.sum(tkws.qat_apply(p, ts, x, QCFG, tcfg) ** 2)

    def loss_float(p):
        y, _ = tkws.apply(p, ts, x, QCFG, tcfg, train=False)
        return torch.sum(y ** 2)

    g_qat = tree.value_and_grad(loss_qat)(tp)[1]
    g_float = tree.value_and_grad(loss_float)(tp)[1]
    names = tkws.conv_names(tcfg)

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    for n in names:
        close(g_qat[n]["w"], g_float[n]["w"])
        close(g_qat[n]["s_w"], g_float[n]["s_w"])
    for n in ("embed", "head"):
        close(g_qat[n]["w"], g_float[n]["w"])
    for a, b in zip(names, names[1:]):
        close(g_qat[a]["s_out"], g_float[a]["s_out"] + g_float[b]["s_in"])
        assert float(g_qat[b]["s_in"]) == 0.0


def test_noisy_darknet_grads_finite_and_nonzero():
    _, _, tp, ts, _ = standin("darknet")
    tcfg = MODELS["darknet"][3]
    x = torch.from_numpy(inputs("darknet", seed=7)[0])

    def loss(p):
        y = tdn.qat_apply(p, ts, x, QCFG, tcfg, noise=port_noise(NOISY),
                          rng=key_pair(15)[1])
        return torch.sum(y ** 2)

    leaves = tree.leaves(tree.value_and_grad(loss)(tp)[1])
    assert all(torch.isfinite(v).all() for v in leaves)
    assert sum(float(v.abs().sum()) for v in leaves) > 0.0


# ---------------------------------------------------------------------------
# Max-pool ties on the float stream
# ---------------------------------------------------------------------------


def test_tied_pool_gradient_goes_to_the_first_maximum():
    """Decoded codes tie in most windows: every 2x2 tie pattern of codes
    {0, 1} (16 windows) and random codes of 4 bits, decoded, pooled by
    ``qat_maxpool2d`` and by ``ops.maxpool2d``, against the reference's
    ``jax.vjp`` of its ``ops.maxpool2d`` on the same windows; the code
    stream is ``int_maxpool2d``'s."""
    patterns = np.array([[(i >> b) & 1 for b in range(4)]
                         for i in range(16)], np.int8)
    windows = np.concatenate([   # (window, row, col)
        patterns.reshape(16, 2, 2),
        np.random.default_rng(8).integers(0, 8, (16, 2, 2)).astype(np.int8)])
    # NHWC (1, 2, 64, 3): window j covers columns 2j and 2j + 1
    codes = windows.transpose(1, 0, 2).reshape(1, 2, 64, 1)
    codes = np.ascontiguousarray(np.repeat(codes, 3, axis=-1))
    scale = np.float32(np.exp(np.float32(-0.7)) / np.float32(7))
    h = codes.astype(np.float32) * scale
    ct = np.random.default_rng(9).standard_normal(
        (1, 1, 32, 3)).astype(np.float32)
    _, vjp = jax.vjp(jops.maxpool2d, jnp.asarray(h))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    assert (want != 0).sum() == ct.size   # one position a window
    for pool in (lambda t: tdq.qat_maxpool2d(t, torch.from_numpy(codes))[0],
                 tops.maxpool2d):
        th = torch.from_numpy(h).requires_grad_(True)
        out = pool(th)
        (out * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_array_equal(th.grad.numpy(), want)
    hq, cq = tdq.qat_maxpool2d(torch.from_numpy(h), torch.from_numpy(codes))
    np.testing.assert_array_equal(cq.numpy(),
                                  np.asarray(jops.maxpool2d(codes)))
    # the pair stays (decode(codes), codes)
    np.testing.assert_array_equal(hq.numpy(),
                                  cq.numpy().astype(np.float32) * scale)


def test_taps_count_rounding_ties_apart():
    """A code flip whose two inputs lie within float32 rounding of the
    half-LSB boundary between the codes is a rounding tie (the surrogate's
    quantizers see sums of lattice values, on such boundaries); a flip
    farther off, or across two codes, is not. Counted by ``Taps`` on
    ``learned_quantize`` against a recorded run."""
    from repro_torch import taps
    from repro_torch.core import fq_layers as tfql
    n, s = 7, torch.tensor(0.0)   # e^s = 1: the input in LSBs is 7 x
    u = np.array([2.5 - 4e-6, 4.5 + 3e-6, 2.5 - 1e-3, 1.4, 0.5 + 2e-6],
                 np.float32)
    u_ref = np.array([2.5 + 4e-6, 4.5 - 3e-6, 2.5 + 1e-3, 2.6, 0.5 - 2e-6],
                     np.float32)
    x, x_ref = (torch.from_numpy(v / np.float32(n)) for v in (u, u_ref))
    code, _, got_u = taps.category(x, torch.tensor(1.0), 0.0, n)
    code_r, _, got_ur = taps.category(x_ref, torch.tensor(1.0), 0.0, n)
    assert (code != code_r).all()
    np.testing.assert_array_equal(
        taps.rounding_ties(code, got_u, code_r, got_ur).numpy(),
        [True, True, False, False, True])
    with Taps(recorded(calls=[x_ref]), pin=False) as t:
        tfql.learned_quantize(x, s, bits=4, b=0.0, stabilize=False)
    assert (t.code_flips, t.round_ties, t.tie_flips) == (5, 3, 0)
