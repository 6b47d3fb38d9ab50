"""FQ layers: the serving pieces and the initialisers the port needs.

Counterpart of ``repro.core.fq_layers``. Parameters are plain dicts of
tensors, as in the reference, so a deployment stack can carry them. Random
initialisation takes an explicit ``torch.Generator``; the reference draws
from ``jax.random``, so the two give different numbers for one seed, and the
tests carry weights across instead (``repro_torch.interop``).

This slice ports the float edges of integer serving (``dense``, eval-mode
``batchnorm``) and what a stack is built from (init, ``fold_bn``). The
float FQ training path is a later slice.
"""
from __future__ import annotations

import math

import torch

from .quant import init_scale


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
