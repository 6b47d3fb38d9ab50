"""CIFAR ResNets (paper §4.1 ResNet-20, §4.3 ResNet-32 / Figure 4).

Counterpart of ``repro.models.resnet``. Pre-FQ mode (Fig 4A): conv -> BN
-> ReLU -> conv -> BN, + shortcut, ReLU. FQ mode (Fig 4B): BN + ReLU ->
quantized ReLU (b = 0); the isolated BN -> learned quantization with
b = -1; the residual add and the ReLU after it stay in float (like the
paper's pooling and softmax). The 1x1 stride-2 convs of the downsample
shortcuts are quantized too; the input image is quantized by the stem's
input quantizer.

``apply`` is the float network of every ladder stage (FP, Q, and FQ with
BN folded by ``to_fq``), trained through straight-through gradients. Every
conv is XLA's "SAME": a 3x3 stride-2 conv on an even side pads (0, 1), as
``fq_layers.fq_conv2d`` pads it. ``noise`` + ``rng`` run the paper's §4.4
noise model on every conv, the keys split from ``rng`` as the reference
splits them. The reference has no integer path for the ResNets, so no
kernel of ``repro_torch.kernels`` runs here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import fq_layers as fql
from ..core import integer_inference as ii
from ..core import prng
from ..core.quant import QuantConfig, RELU_BOUND, WEIGHT_BOUND
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    widths: Tuple[int, ...] = (16, 32, 64)       # ResNet-20 (CIFAR-10)
    blocks_per_stage: int = 3
    num_classes: int = 10
    quantize_first_last: bool = True             # paper §4.1 uses False

    @classmethod
    def resnet20(cls, quantize_first_last=False):
        return cls((16, 32, 64), 3, 10, quantize_first_last)

    @classmethod
    def resnet32(cls):
        # Paper Fig 4: 3 ResBlocks of five subblocks, widths 64 -> 256.
        return cls((64, 128, 256), 5, 100, True)

    @classmethod
    def reduced(cls):
        return cls((8, 16), 1, 10, True)


def init(gen: torch.Generator, cfg: ResNetConfig, *,
         device: DeviceLike = None):
    """Random float params and BN state from ``gen``, placed on ``device``.

    The draws are made on the CPU, so one seed gives the same weights on
    every device. Names are the reference's: ``stem``, ``s{si}b{bi}_c1``,
    ``_c2``, ``_sc`` (the downsample shortcut), each with its ``_bn``, and
    ``head``.
    """
    dev = resolve_device(device)
    params, state = {}, {}

    def bn(name, c):
        params[name + "_bn"], state[name + "_bn"] = fql.init_batchnorm(c)

    params["stem"] = fql.init_fq_conv2d(gen, 3, 3, cfg.widths[0])
    bn("stem", cfg.widths[0])
    cin = cfg.widths[0]
    for si, w in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}"
            params[pre + "_c1"] = fql.init_fq_conv2d(gen, 3, cin, w)
            bn(pre + "_c1", w)
            params[pre + "_c2"] = fql.init_fq_conv2d(gen, 3, w, w)
            bn(pre + "_c2", w)
            if cin != w:  # downsample shortcut: 1x1 conv + BN (quantized too)
                params[pre + "_sc"] = fql.init_fq_conv2d(gen, 1, cin, w)
                bn(pre + "_sc", w)
            cin = w
    params["head"] = fql.init_dense(gen, cin, cfg.num_classes)
    return ii.to_device(params, dev), ii.to_device(state, dev)


def _maybe_fp(qcfg: QuantConfig, quantize: bool) -> QuantConfig:
    return qcfg if quantize else QuantConfig(fq=qcfg.fq)


def _relu(h):
    """``jax.nn.relu``: gradient 0 at 0, as ``torch.relu``'s."""
    return torch.relu(h)


def apply(params, state, x, qcfg: QuantConfig, cfg: ResNetConfig, *,
          train: bool = False, rng=None, noise=None):
    """x: (B, 32, 32, 3) images in [-1, 1] -> (logits (B, num_classes),
    new BN state)."""
    new_state = dict(state)
    # the reference's count: more keys than convs, taken in call order
    # (the stem, then per block c1, c2 and, where there is one, sc)
    n_layers = 1 + 3 * len(cfg.widths) * cfg.blocks_per_stage
    rngs = iter(prng.layer_keys(rng, n_layers))

    def conv_bn(name, h, lq, *, stride=1, relu=True, b_in=WEIGHT_BOUND):
        h = fql.fq_conv2d(params[name], h, lq, stride=stride, padding="SAME",
                          b_in=b_in, relu_out=relu, noise=noise,
                          rng=next(rngs))
        if not lq.fq:
            h, new_state[name + "_bn"] = fql.batchnorm(
                params[name + "_bn"], state[name + "_bn"], h, train=train)
            if relu:
                h = _relu(h)
        return h

    stem_q = _maybe_fp(qcfg, cfg.quantize_first_last)
    # Input images quantized by the stem's input quantizer (b=-1, §4.3).
    h = conv_bn("stem", x, stem_q, b_in=WEIGHT_BOUND)
    cin = cfg.widths[0]
    for si, w in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}"
            stride = 2 if (cin != w) else 1
            shortcut = h
            h1 = conv_bn(pre + "_c1", h, qcfg, stride=stride, relu=True,
                         b_in=RELU_BOUND)
            # Second conv: isolated BN (no ReLU) -> FQ uses b=-1 quantizer.
            h2 = conv_bn(pre + "_c2", h1, qcfg, relu=False, b_in=RELU_BOUND)
            if pre + "_sc" in params:
                shortcut = conv_bn(pre + "_sc", shortcut, qcfg,
                                   stride=stride, relu=False,
                                   b_in=RELU_BOUND)
            h = _relu(h2 + shortcut)  # FP add + ReLU between blocks
            cin = w
    h = torch.mean(h, dim=(1, 2))  # FP global average pool
    return fql.dense(params["head"], h), new_state


def to_fq(params, state, cfg: ResNetConfig):
    """Fold every BN into its conv for FQ retraining (paper §3.4/Fig 4B)."""
    new = dict(params)
    for name in params:
        if name + "_bn" in params:
            new[name] = fql.fold_bn(params[name], params[name + "_bn"],
                                    state[name + "_bn"])
    return new
