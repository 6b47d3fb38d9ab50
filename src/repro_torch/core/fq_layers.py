"""FQ layers: the paper's fully quantized layer contract in PyTorch.

Counterpart of ``repro.core.fq_layers``. Every layer has three modes,
selected by :class:`QuantConfig`:

  * FP: a plain float layer;
  * Q: learned-quantized weights and input activations, float MAC, output
    left in float for the BN and nonlinearity that follow;
  * FQ: BN folded away, the MAC output quantized by the learned quantizer,
    which doubles as the nonlinearity (b = 0 a ReLU, b = -1 a hard tanh).

Parameters are plain dicts of tensors, as in the reference; the stored
weights are the full-precision shadow copy and quantization is applied in
the forward pass with straight-through gradients. Random initialisation
takes an explicit ``torch.Generator``; the reference draws from
``jax.random``, so the two give different numbers for one seed, and the
tests carry weights across instead (``repro_torch.interop``).

The float MAC of every conv is cuDNN's (mkldnn's on the CPU) through
:class:`_Conv`, which turns TF32 off in the forward and in the backward
alike: autograd runs a backward after the forward has returned, under
whatever the global flag says then, and that flag defaults to on.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from . import prng
from .noise import NoiseConfig, add_lsb_noise
from .quant import (QuantConfig, RELU_BOUND, WEIGHT_BOUND, host_log,
                    init_scale, learned_quantize)


def he_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)


def _init_fq(gen: torch.Generator, shape, fan_in: int):
    w = he_normal(gen, shape, fan_in)
    return {
        "w": w,
        "s_w": init_scale(w),
        "s_in": torch.tensor(0.0),
        "s_out": torch.tensor(0.0),
    }


def init_fq_linear(gen: torch.Generator, din: int, dout: int):
    return _init_fq(gen, (din, dout), din)


def init_fq_conv1d(gen: torch.Generator, ksize: int, cin: int, cout: int):
    return _init_fq(gen, (ksize, cin, cout), ksize * cin)


def init_fq_conv2d(gen: torch.Generator, ksize: int, cin: int, cout: int):
    return _init_fq(gen, (ksize, ksize, cin, cout), ksize * ksize * cin)


# ---------------------------------------------------------------------------
# Activation-range calibration (at the FQ transition)
# ---------------------------------------------------------------------------
# Run a batch through the BN-folded network inside ``calibration(rec)``:
# every quantizer records max|x|, keyed by ``id()`` of its layer's param
# dict; ``apply_calibration`` writes s = log(range) back into the same
# dicts. Iterate 2-3 times: each range depends on the quantizers upstream.

_CAL = threading.local()


@contextlib.contextmanager
def calibration(rec: dict):
    _CAL.rec = rec
    try:
        yield rec
    finally:
        _CAL.rec = None


def _record(p, kind: str, x: torch.Tensor):
    rec = getattr(_CAL, "rec", None)
    if rec is not None:
        v = float(torch.max(torch.abs(x.detach())))
        d = rec.setdefault(id(p), {})
        d[kind] = max(d.get(kind, 0.0), v)


def apply_calibration(params, rec: dict):
    """Write recorded ranges back: s_in / s_out = log(observed max)."""
    def walk(t):
        if isinstance(t, dict):
            if id(t) in rec:
                r = rec[id(t)]
                for kind in ("in", "out"):
                    if kind in r and f"s_{kind}" in t and r[kind] > 0:
                        t[f"s_{kind}"] = host_log(torch.tensor(
                            r[kind])).to(t[f"s_{kind}"].device)
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
    walk(params)
    return params


def calibrate(apply_fn, params, *, iters: int = 3):
    """``apply_fn(params)`` runs the network on a sample batch."""
    for _ in range(iters):
        rec = {}
        with calibration(rec), torch.no_grad():
            apply_fn(params)
        params = apply_calibration(params, rec)
    return params


# ---------------------------------------------------------------------------
# The shared FQ forward contract
# ---------------------------------------------------------------------------


def _split3(rng):
    if rng is None:
        return None, None, None
    k = prng.split(rng, 3)
    return k[0], k[1], k[2]


def _prepare_operands(p, x, qcfg: QuantConfig, *, b_in: float,
                      noise: Optional[NoiseConfig], rng):
    """Quantize (and optionally perturb) input activations and weights."""
    kw, ka, kmac = _split3(rng)
    w, xa = p["w"], x
    if qcfg.bits_a is not None:
        _record(p, "in", xa)
        xa = learned_quantize(xa, p["s_in"], bits=qcfg.bits_a, b=b_in)
        if noise is not None:
            xa = add_lsb_noise(xa, ka, noise.sigma_a, p["s_in"], qcfg.bits_a)
    if qcfg.bits_w is not None:
        w = learned_quantize(w, p["s_w"], bits=qcfg.bits_w, b=WEIGHT_BOUND)
        if noise is not None:
            w = add_lsb_noise(w, kw, noise.sigma_w, p["s_w"], qcfg.bits_w)
    return xa, w, kmac


def _finish_output(p, y, qcfg: QuantConfig, *, relu_out: bool,
                   noise: Optional[NoiseConfig], kmac):
    """FQ epilogue: MAC noise, then the output quantizer-as-nonlinearity."""
    if not (qcfg.fq and qcfg.bits_out is not None):
        return y  # Q mode: BN + nonlinearity follow outside this layer.
    _record(p, "out", y)
    if noise is not None:
        y = add_lsb_noise(y, kmac, noise.sigma_mac, p["s_out"], qcfg.bits_out)
    b_out = RELU_BOUND if relu_out else WEIGHT_BOUND
    return learned_quantize(y, p["s_out"], bits=qcfg.bits_out, b=b_out)


@contextlib.contextmanager
def _no_tf32():
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


class _Conv(torch.autograd.Function):
    """``aten.convolution`` (no bias, no groups) with TF32 off in both
    directions: the backward calls ``aten.convolution_backward`` under the
    same setting as the forward."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        with _no_tf32():
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, dilation, False,
                [0] * len(stride), 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False,
                [0] * len(stride), 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def _same_padding(size: int, k: int, stride: int):
    """(before, after) padding of XLA's "SAME" for one spatial axis, ``k``
    the dilated filter extent."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, *, stride: int, padding: str, dilation: int):
    """Channels-last conv: x (B, *spatial, C), w (*taps, I, O), as the
    reference's NHWC / NTC convs with HWIO / TIO weights."""
    nd = x.dim() - 2
    xc = x.movedim(-1, 1)                      # an NC* view, channels last
    wc = w.to(x.dtype).permute(nd + 1, nd, *range(nd))   # -> OI*
    if stride > 1 and all(k == 1 for k in w.shape[:nd]):
        # A 1-tap conv at stride s (no padding, "SAME" or "VALID") reads
        # every s-th position: take them and run it at stride 1, the same
        # sums. The CPU's (mkldnn) weight gradient of a strided 1x1 conv on
        # a channels-last input writes out of bounds of its heap buffers.
        xc = xc[(slice(None),) * 2 + (slice(None, None, stride),) * nd]
        stride = 1
    if padding == "SAME":
        pads = [_same_padding(x.shape[1 + i], (w.shape[i] - 1) * dilation + 1,
                              stride) for i in range(nd)]
        if any(a != b for a, b in pads):
            xc = F.pad(xc, [v for a, b in reversed(pads) for v in (a, b)])
            pads = [(0, 0)] * nd
        pad = [a for a, _ in pads]
    elif padding == "VALID":
        pad = [0] * nd
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = _Conv.apply(xc, wc, [stride] * nd, pad, [dilation] * nd)
    return y.movedim(1, -1)


def fq_linear(p, x, qcfg: QuantConfig, *, b_in: float = WEIGHT_BOUND,
              relu_out: bool = False, noise: Optional[NoiseConfig] = None,
              rng=None):
    """x @ Q(w) with the FQ contract. x: (..., din)."""
    xa, w, kmac = _prepare_operands(p, x, qcfg, b_in=b_in, noise=noise,
                                    rng=rng)
    y = torch.matmul(xa, w.to(xa.dtype))
    return _finish_output(p, y, qcfg, relu_out=relu_out, noise=noise,
                          kmac=kmac)


def fq_conv2d(p, x, qcfg: QuantConfig, *, stride: int = 1,
              padding: str = "SAME", b_in: float = WEIGHT_BOUND,
              relu_out: bool = False, noise: Optional[NoiseConfig] = None,
              rng=None):
    """NHWC 2-D convolution with HWIO weights and the FQ contract."""
    xa, w, kmac = _prepare_operands(p, x, qcfg, b_in=b_in, noise=noise,
                                    rng=rng)
    y = _conv(xa, w, stride=stride, padding=padding, dilation=1)
    return _finish_output(p, y, qcfg, relu_out=relu_out, noise=noise,
                          kmac=kmac)


def fq_conv1d(p, x, qcfg: QuantConfig, *, dilation: int = 1,
              padding: str = "VALID", b_in: float = WEIGHT_BOUND,
              relu_out: bool = False, noise: Optional[NoiseConfig] = None,
              rng=None):
    """(B, T, C) 1-D convolution with (K, I, O) weights (the paper's KWS
    layers: VALID, dilated)."""
    xa, w, kmac = _prepare_operands(p, x, qcfg, b_in=b_in, noise=noise,
                                    rng=rng)
    y = _conv(xa, w, stride=1, padding=padding, dilation=dilation)
    return _finish_output(p, y, qcfg, relu_out=relu_out, noise=noise,
                          kmac=kmac)


# ---------------------------------------------------------------------------
# Batch normalization (the thing FQ mode removes)
# ---------------------------------------------------------------------------


def init_batchnorm(c: int):
    params = {"gamma": torch.ones(c), "beta": torch.zeros(c)}
    state = {"mean": torch.zeros(c), "var": torch.ones(c)}
    return params, state


def batchnorm(p, st, x, *, train: bool = False, momentum: float = 0.9,
              eps: float = 1e-5):
    """BN over all axes but the last. Returns (y, new_state).

    In training the batch statistics are the reference's: the mean, and
    the mean square of x less that mean (``jnp.var``); the running state
    moves by the reference's expression, without a gradient.
    """
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, axes)
        var = torch.mean(torch.square(x - mean), axes)
        new_st = {
            "mean": momentum * st["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * st["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    y = (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, new_st


def fold_bn(conv_p, bn_p, bn_st, *, eps: float = 1e-5):
    """Fold inference-mode BN into the conv before it (paper §3.4).

    gamma' = gamma / sigma scales the conv weights per output channel; beta'
    is dropped. s_w is re-initialised for the rescaled weights and s_out is
    seeded at 2.5 max|gamma|, as in the reference.
    """
    gamma_p = bn_p["gamma"] * torch.rsqrt(bn_st["var"] + eps)
    w = conv_p["w"] * gamma_p
    new = dict(conv_p)
    new["w"] = w
    new["s_w"] = init_scale(w)
    new["s_out"] = host_log(
        2.5 * torch.max(torch.abs(bn_p["gamma"].to(torch.float32))) + 1e-8)
    return new


def init_dense(gen: torch.Generator, din: int, dout: int):
    return {"w": he_normal(gen, (din, dout), din), "b": torch.zeros(dout)}


def dense(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"]
    return y
