"""DarkNet-19 (paper §4.1 Table 3).

Counterpart of ``repro.models.darknet``. 19 convs (3x3 / 1x1), BN and
leaky ReLU(0.1) after each, a 2x2 max-pool between stages, a 1x1
classifier conv and a global average pool. The first conv and the
classifier stay full precision (the paper's ImageNet protocol).

``apply`` is the float network of every ladder stage (FP, Q, and FQ with
BN folded by ``to_fq``, where quantized ReLUs replace BN + leaky ReLU),
trained through straight-through gradients. Integer deployment (paper
§3.4): every conv between the FP edges runs integer-in / integer-out on
int8 codes, and a conv followed by a pool runs as one op whose pool is
fused into the conv kernel's epilogue (K3b); ``int_apply`` serves a stack
built with ``init`` -> ``to_fq`` -> ``convert_int`` or carried across from
the reference (``repro_torch.interop``). ``noise`` + ``rng`` run the
paper's §4.4 noise model on every conv, one key per conv, split from
``rng`` as the reference splits it. ``qat_apply`` is the
deployment-in-the-loop forward (``core.deploy_qat``): the value of
``int_apply`` of the converted params, the gradient of the float FQ path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import deploy_qat as dq
from ..core import fq_layers as fql
from ..core import integer_inference as ii
from ..core import prng, quant
from ..core.quant import QuantConfig, RELU_BOUND, WEIGHT_BOUND
from ..device import DeviceLike, resolve_device
from ..kernels import ops

# (ksize, cout) per conv; "M" = 2x2 maxpool stride 2.
_DARKNET19 = [
    (3, 32), "M", (3, 64), "M", (3, 128), (1, 64), (3, 128), "M",
    (3, 256), (1, 128), (3, 256), "M",
    (3, 512), (1, 256), (3, 512), (1, 256), (3, 512), "M",
    (3, 1024), (1, 512), (3, 1024), (1, 512), (3, 1024),
]


@dataclasses.dataclass(frozen=True)
class DarkNetConfig:
    layers: Tuple = tuple(_DARKNET19)
    num_classes: int = 1000
    in_channels: int = 3

    @classmethod
    def reduced(cls):
        return cls(layers=((3, 8), "M", (3, 16), "M", (3, 16), (1, 8), (3, 16)),
                   num_classes=16)


def init(gen: torch.Generator, cfg: DarkNetConfig, *,
         device: DeviceLike = None):
    """Random float params and BN state from ``gen``, placed on ``device``.

    The draws are made on the CPU, so one seed gives the same weights on
    every device.
    """
    dev = resolve_device(device)
    params, state = {}, {}
    cin = cfg.in_channels
    for i, (ks, cout) in enumerate(l for l in cfg.layers if l != "M"):
        params[f"conv{i}"] = fql.init_fq_conv2d(gen, ks, cin, cout)
        params[f"bn{i}"], state[f"bn{i}"] = fql.init_batchnorm(cout)
        cin = cout
    params["head"] = fql.init_fq_conv2d(gen, 1, cin, cfg.num_classes)
    return ii.to_device(params, dev), ii.to_device(state, dev)


def _leaky_relu(h):
    """``jax.nn.leaky_relu(h, 0.1)``: gradient 1 at 0 (torch's is 0.1)."""
    return torch.where(h >= 0, h, 0.1 * h)


def apply(params, state, x, qcfg: QuantConfig, cfg: DarkNetConfig, *,
          train: bool = False, rng=None, noise=None):
    """x: (B, H, W, 3) -> (logits (B, num_classes), new BN state)."""
    new_state = dict(state)
    n_convs = sum(layer != "M" for layer in cfg.layers)
    rngs = prng.layer_keys(rng, n_convs)
    h, ci = x, 0
    fp = QuantConfig(fq=qcfg.fq)
    for layer in cfg.layers:
        if layer == "M":
            h = ops.maxpool2d(h)  # gradient to each window's first maximum
            continue
        lq = fp if ci == 0 else qcfg  # the first conv stays FP
        b_in = WEIGHT_BOUND if ci == 0 else RELU_BOUND
        h = fql.fq_conv2d(params[f"conv{ci}"], h, lq, padding="SAME",
                          b_in=b_in, relu_out=True, noise=noise,
                          rng=rngs[ci])
        if not lq.fq:
            h, new_state[f"bn{ci}"] = fql.batchnorm(
                params[f"bn{ci}"], state[f"bn{ci}"], h, train=train)
            h = _leaky_relu(h)
        ci += 1
    # the classifier conv stays FP; GAP, the softmax is the loss's
    h = fql.fq_conv2d(params["head"], h, QuantConfig(), padding="SAME",
                      b_in=RELU_BOUND)
    return torch.mean(h, dim=(1, 2)), new_state


def to_fq(params, state, cfg: DarkNetConfig):
    """Fold each conv's BN into its weights for FQ retraining (§3.4)."""
    new = dict(params)
    for name in params:
        i = name[4:]
        if name.startswith("conv") and f"bn{i}" in params:
            new[name] = fql.fold_bn(params[name], params[f"bn{i}"],
                                    state[f"bn{i}"])
    return new


def layer_plan(cfg: DarkNetConfig, fuse_pool: bool = True):
    """cfg.layers -> ordered steps.

    ``("fp_conv", ks)`` FP first conv; ``("pool",)`` standalone maxpool
    (float before entry, code-domain after); ``("conv", name, ks, pooled)``
    integer conv, ``pooled=True`` when the following "M" is fused into its
    epilogue (and consumed from the walk).
    """
    plan, layers, ci, i = [], list(cfg.layers), 0, 0
    while i < len(layers):
        layer = layers[i]
        if layer == "M":
            plan.append(("pool",))
            i += 1
            continue
        ks, _ = layer
        if ci == 0:
            plan.append(("fp_conv", ks))
        else:
            pooled = fuse_pool and i + 1 < len(layers) and \
                layers[i + 1] == "M"
            plan.append(("conv", f"conv{ci}", ks, pooled))
            if pooled:
                i += 1
        ci += 1
        i += 1
    return plan


def int_conv_names(cfg: DarkNetConfig):
    """Names of the code-carrying chain (for sync_handoff)."""
    return [s[1] for s in layer_plan(cfg) if s[0] == "conv"]


def int_extras(params, state, cfg: DarkNetConfig):
    """The float-side extras of the deployment stack: the FP edge convs,
    the entry quantizer and the decode scale.

    Beside the reference's entries, ``entry`` carries ``inv_scale`` =
    e^{-s_in}, computed once here, as the KWS stack's does.
    """
    names = int_conv_names(cfg)
    s_in = params[names[0]]["s_in"]
    return {"conv0": params["conv0"], "head": params["head"],
            "entry": {"s_in": s_in, "inv_scale": quant.exp(-s_in)},
            "s_out_last": params[names[-1]]["s_out"]}


def convert_int(params, state, qcfg: QuantConfig, cfg: DarkNetConfig,
                weight_format=None):
    """Trained FQ (BN-folded) params -> :class:`ii.ConvertedStack`: the
    integer core plus the FP edge convs as extras."""
    names = int_conv_names(cfg)
    return ii.convert_stack({n: params[n] for n in names}, qcfg,
                            specs=[ii.LayerSpec(n) for n in names],
                            extras=int_extras(params, state, cfg),
                            weight_format=weight_format)


def _split_plan(plan):
    """Index of the first integer conv step: the entry of the code core."""
    for i, step in enumerate(plan):
        if step[0] == "conv":
            return i
    return len(plan)


def int_core(ip, codes, qcfg: QuantConfig, cfg: DarkNetConfig, *, impl=None,
             fuse_pool: bool = True, noise=None, rng=None,
             mac_chunks: int = 1):
    """The integer segment alone: int8 codes in -> int8 codes out."""
    plan = layer_plan(cfg, fuse_pool)
    core = plan[_split_plan(plan):]
    rngs = iter(prng.layer_keys(rng, sum(s[0] == "conv" for s in core)))
    for step in core:
        if step[0] == "pool":
            codes = ii.int_maxpool2d(codes)
            continue
        _, name, ks, pooled = step
        run = ii.int_conv2d_pool if pooled else ii.int_conv2d
        codes = run(ip[name], codes, ksize=ks, padding=ks // 2, impl=impl,
                    noise=noise, rng=next(rngs), mac_chunks=mac_chunks)
    return codes


def int_apply(ip, x, qcfg: QuantConfig, cfg: DarkNetConfig, *, impl=None,
              fuse_pool: bool = True, noise=None, rng=None,
              mac_chunks: int = 1):
    """x: (B, H, W, 3) float -> logits (B, num_classes).

    FP conv0 and the float pools before the entry, the entry quantizer,
    ``int_core``, decode, the FP 1x1 classifier conv and the spatial mean.
    ``fuse_pool=False`` runs each conv+pool pair as conv then code pool,
    the stack-level parity oracle.
    """
    plan = layer_plan(cfg, fuse_pool)
    h = x
    for step in plan[:_split_plan(plan)]:
        if step[0] == "fp_conv":
            h = fql.fq_conv2d(ip["conv0"], h, QuantConfig(fq=qcfg.fq),
                              padding="SAME", b_in=WEIGHT_BOUND)
        else:
            h = ops.maxpool2d(h)
    codes = ii.entry_codes(h, ip["entry"], qcfg, b_in=RELU_BOUND)
    codes = int_core(ip, codes, qcfg, cfg, impl=impl, fuse_pool=fuse_pool,
                     noise=noise, rng=rng, mac_chunks=mac_chunks)
    h = ii.decode_output(codes, ip["s_out_last"], qcfg.bits_out,
                         scale=ip.get("decode_scale"))
    h = fql.fq_conv2d(ip["head"], h, QuantConfig(), padding="SAME",
                      b_in=RELU_BOUND)
    return torch.mean(h, dim=(1, 2))


def qat_apply(params, state, x, qcfg: QuantConfig, cfg: DarkNetConfig, *,
              impl=None, fuse_pool: bool = True, noise=None, rng=None,
              mac_chunks: int = 1):
    """Deployment-in-the-loop forward: value == ``int_apply`` of the
    converted params (same codes, same noise draws), gradient == the float
    FQ/STE path. ``params`` must be BN-folded (after ``to_fq``); ``state``
    is unused (BN is folded) and kept for the signature's symmetry.
    """
    plan = layer_plan(cfg, fuse_pool)
    rngs = prng.layer_keys(rng, sum(s[0] == "conv" for s in plan))
    h, codes, s_prev, li = x, None, None, 0
    for step in plan:
        if step[0] == "fp_conv":
            h = fql.fq_conv2d(params["conv0"], h, QuantConfig(fq=qcfg.fq),
                              padding="SAME", b_in=WEIGHT_BOUND)
        elif step[0] == "pool":
            if codes is None:
                h = ops.maxpool2d(h)  # pre-entry FP pool (differentiable)
            else:
                h, codes = dq.qat_maxpool2d(h, codes)
        else:
            _, name, ks, pooled = step
            h, codes = dq.qat_conv2d(params[name], h, codes, qcfg, ksize=ks,
                                     pool=2 if pooled else None, s_in=s_prev,
                                     noise=noise, rng=rngs[li],
                                     mac_chunks=mac_chunks, impl=impl)
            s_prev = params[name]["s_out"]
            li += 1
    h = fql.fq_conv2d(params["head"], h, QuantConfig(), padding="SAME",
                      b_in=RELU_BOUND)
    return torch.mean(h, dim=(1, 2))


def int_serve_fn(ip, qcfg: QuantConfig, cfg: DarkNetConfig, **kw):
    """Fixed-signature serving closure: (B, H, W, 3) -> logits.

    Requests (numpy arrays or tensors) are moved to the stack's device;
    ``noise``/``rng`` pass through to :func:`int_apply`. The closure's
    ``device`` attribute is the stack's device, where
    ``serve.cnn_batching.CNNBatcher`` places its lanes.
    """
    device = ip.device

    def fn(x, noise=None, rng=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return int_apply(ip, x, qcfg, cfg, noise=noise, rng=rng, **kw)
    fn.device = device
    return fn
