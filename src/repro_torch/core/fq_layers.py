"""FQ layers: the serving pieces and the initialisers the port needs.

Counterpart of ``repro.core.fq_layers``. Parameters are plain dicts of
tensors, as in the reference, so a deployment stack can carry them. Random
initialisation takes an explicit ``torch.Generator``; the reference draws
from ``jax.random``, so the two give different numbers for one seed, and the
tests carry weights across instead (``repro_torch.interop``).

This slice ports the float edges of integer serving (``dense``, eval-mode
``batchnorm``, the float mode of ``fq_conv2d``) and what a stack is built
from (init, ``fold_bn``). The quantized (Q / FQ) modes of the layers are
the training slice and raise here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .quant import QuantConfig, WEIGHT_BOUND, init_scale


def he_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)


def init_fq_conv1d(gen: torch.Generator, ksize: int, cin: int, cout: int):
    w = he_normal(gen, (ksize, cin, cout), ksize * cin)
    return {
        "w": w,
        "s_w": init_scale(w),
        "s_in": torch.tensor(0.0),
        "s_out": torch.tensor(0.0),
    }


def init_fq_conv2d(gen: torch.Generator, ksize: int, cin: int, cout: int):
    w = he_normal(gen, (ksize, ksize, cin, cout), ksize * ksize * cin)
    return {
        "w": w,
        "s_w": init_scale(w),
        "s_in": torch.tensor(0.0),
        "s_out": torch.tensor(0.0),
    }


def _same_padding(size: int, k: int, stride: int):
    """(before, after) padding of XLA's "SAME" for one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def fq_conv2d(p, x, qcfg: QuantConfig, *, stride: int = 1,
              padding: str = "SAME", b_in: float = WEIGHT_BOUND,
              relu_out: bool = False, noise=None):
    """NHWC 2-D convolution with HWIO weights, in the float mode only.

    That is the mode of the FP edge convs of integer serving (``b_in`` and
    ``relu_out`` only matter in the quantized modes, which raise). The conv
    is cuDNN's, with TF32 off for its duration, as the reference leaves it
    to XLA outside any Pallas kernel.
    """
    if (qcfg.bits_a is not None or qcfg.bits_w is not None
            or (qcfg.fq and qcfg.bits_out is not None) or noise is not None):
        raise NotImplementedError(
            f"fq_conv2d: only the float mode is ported, got {qcfg} "
            f"noise={noise is not None}")
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    xc = x.permute(0, 3, 1, 2)  # NHWC -> an NCHW view in channels-last
    if padding == "SAME":
        (t, b), (l, r) = (_same_padding(x.shape[i + 1], w.shape[i + 2],
                                        stride) for i in range(2))
        if (t, l) != (b, r):
            xc, (t, l) = F.pad(xc, (l, r, t, b)), (0, 0)
        pad = (t, l)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xc, w, stride=stride, padding=pad)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


def init_batchnorm(c: int):
    params = {"gamma": torch.ones(c), "beta": torch.zeros(c)}
    state = {"mean": torch.zeros(c), "var": torch.ones(c)}
    return params, state


def batchnorm(p, st, x, *, eps: float = 1e-5):
    """Eval-mode BN over all axes but the last. Returns (y, state).

    Training-mode BN belongs to the training slice of the port.
    """
    y = (x - st["mean"]) * torch.rsqrt(st["var"] + eps) * p["gamma"] + p["beta"]
    return y, st


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
    new["s_out"] = torch.log(
        2.5 * torch.max(torch.abs(bn_p["gamma"].to(torch.float32))) + 1e-8)
    return new


def init_dense(gen: torch.Generator, din: int, dout: int):
    return {"w": he_normal(gen, (din, dout), din), "b": torch.zeros(dout)}


def dense(p, x):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"]
    return y
