"""Keyword-spotting network (paper §4.2, Figure 2).

Counterpart of ``repro.models.kws``. MFCC frames -> FP fully connected
embedding (N=100) -> BN -> 4-bit entry quantizer -> 7 dilated FQ-Conv1d
layers (45 filters, k=3, VALID, exponential dilation) -> global average
pool -> FP head.

``apply`` is the float network of every ladder stage (FP, Q with BN and
ReLU after each conv, FQ with BN folded by ``to_fq``), trained through
straight-through gradients; ``int_apply`` serves the converted stack
integer-in / integer-out (``init`` -> ``to_fq`` -> ``convert_int``, or a
stack carried across from the reference with ``repro_torch.interop``).
``noise`` + ``rng`` run the paper's §4.4 noise model on every conv, one
key per conv split from ``rng`` as the reference splits it.
``qat_apply`` is the deployment-in-the-loop forward (``core.deploy_qat``):
the value of ``int_apply`` of the converted params, the gradient of the
float FQ path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import deploy_qat as dq
from ..core import fq_layers as fql
from ..core import integer_inference as ii
from ..core import prng, quant
from ..core.quant import QuantConfig, RELU_BOUND
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class KWSConfig:
    n_mfcc: int = 39
    embed: int = 100
    filters: int = 45
    ksize: int = 3
    dilations: Tuple[int, ...] = (1, 1, 2, 4, 8, 16, 32)
    num_classes: int = 12
    seq_len: int = 140

    @classmethod
    def reduced(cls):
        return cls(n_mfcc=8, embed=16, filters=8,
                   dilations=(1, 1, 2), num_classes=4, seq_len=24)


def init(gen: torch.Generator, cfg: KWSConfig, *, device: DeviceLike = None):
    """Random float params and BN state from ``gen``, placed on ``device``.

    The draws are made on the CPU, so one seed gives the same weights on
    every device.
    """
    dev = resolve_device(device)
    params = {"embed": fql.init_dense(gen, cfg.n_mfcc, cfg.embed)}
    bn_p, bn_s = fql.init_batchnorm(cfg.embed)
    params["embed_bn"] = bn_p
    state = {"embed_bn": bn_s}
    cin = cfg.embed
    for i, _ in enumerate(cfg.dilations):
        params[f"conv{i}"] = fql.init_fq_conv1d(gen, cfg.ksize, cin,
                                                cfg.filters)
        bn_p, bn_s = fql.init_batchnorm(cfg.filters)
        params[f"bn{i}"] = bn_p
        state[f"bn{i}"] = bn_s
        cin = cfg.filters
    params["head"] = fql.init_dense(gen, cfg.filters, cfg.num_classes)
    return ii.to_device(params, dev), ii.to_device(state, dev)


def _relu(h):
    """``jax.nn.relu``: gradient 0 at 0, as ``torch.relu``'s."""
    return torch.relu(h)


def apply(params, state, x, qcfg: QuantConfig, cfg: KWSConfig, *,
          train: bool = False, rng=None, noise=None):
    """x: (B, T, n_mfcc) -> (logits (B, num_classes), new BN state)."""
    new_state = dict(state)
    # FP expansive embedding (the paper keeps this layer full precision)
    h = fql.dense(params["embed"], x)
    h, new_state["embed_bn"] = fql.batchnorm(
        params["embed_bn"], state["embed_bn"], h, train=train)
    rngs = prng.layer_keys(rng, len(cfg.dilations))
    for i, dil in enumerate(cfg.dilations):
        # the first conv's input quantizer is Fig. 2's 4-bit entry quantize
        h = fql.fq_conv1d(
            params[f"conv{i}"], h, qcfg, dilation=dil, padding="VALID",
            b_in=RELU_BOUND, relu_out=True, noise=noise, rng=rngs[i])
        if not qcfg.fq:
            # before FQ: BN + ReLU after each quantized conv
            h, new_state[f"bn{i}"] = fql.batchnorm(
                params[f"bn{i}"], state[f"bn{i}"], h, train=train)
            h = _relu(h)
    h = torch.mean(h, dim=1)  # FP global average pool (paper §3.4)
    return fql.dense(params["head"], h), new_state


def to_fq(params, state, cfg: KWSConfig):
    """Fold per-conv BN into conv weights for FQ retraining (paper §3.4)."""
    new = dict(params)
    for i, _ in enumerate(cfg.dilations):
        new[f"conv{i}"] = fql.fold_bn(params[f"conv{i}"], params[f"bn{i}"],
                                      state[f"bn{i}"])
    return new


def layer_plan(cfg: KWSConfig):
    """The ordered integer core: (layer name, dilation) per conv."""
    return [(f"conv{i}", d) for i, d in enumerate(cfg.dilations)]


def conv_names(cfg: KWSConfig):
    """Names of the code-carrying chain (for sync_handoff)."""
    return [name for name, _ in layer_plan(cfg)]


def int_extras(params, state, cfg: KWSConfig):
    """The float-side extras of the deployment stack.

    Beside the reference's entries, ``entry`` carries ``inv_scale`` =
    e^{-s_in}, computed once here: the entry quantizer then needs no ``exp``
    per request, and a stack moved between devices keeps the same scalar.
    """
    names = conv_names(cfg)
    s_in = params["conv0"]["s_in"]
    return {
        "embed": params["embed"],
        "embed_bn": (params["embed_bn"], state["embed_bn"]),
        "head": params["head"],
        "entry": {"s_in": s_in, "inv_scale": quant.exp(-s_in)},
        "s_out_last": params[names[-1]]["s_out"],
    }


def convert_int(params, state, qcfg: QuantConfig, cfg: KWSConfig,
                weight_format=None):
    """Trained FQ params -> :class:`integer_inference.ConvertedStack`."""
    names = conv_names(cfg)
    return ii.convert_stack({n: params[n] for n in names}, qcfg,
                            specs=[ii.LayerSpec(n) for n in names],
                            extras=int_extras(params, state, cfg),
                            weight_format=weight_format)


def int_core(ip, codes, qcfg: QuantConfig, cfg: KWSConfig, *, impl=None,
             noise=None, rng=None, mac_chunks: int = 1):
    """The integer segment alone: int8 codes in -> int8 codes out."""
    plan = layer_plan(cfg)
    for (name, dil), r in zip(plan, prng.layer_keys(rng, len(plan))):
        codes = ii.int_conv1d(ip[name], codes, ksize=cfg.ksize, dilation=dil,
                              impl=impl, noise=noise, rng=r,
                              mac_chunks=mac_chunks)
    return codes


def int_apply(ip, x, qcfg: QuantConfig, cfg: KWSConfig, *, impl=None,
              noise=None, rng=None, mac_chunks: int = 1):
    """x: (B, T, n_mfcc) float -> logits (B, num_classes). The FP embedding
    and head stay clean: the noise model covers the integer conv core."""
    h = fql.dense(ip["embed"], x)
    h, _ = fql.batchnorm(ip["embed_bn"][0], ip["embed_bn"][1], h)
    codes = ii.entry_codes(h, ip["entry"], qcfg, b_in=RELU_BOUND)
    codes = int_core(ip, codes, qcfg, cfg, impl=impl, noise=noise, rng=rng,
                     mac_chunks=mac_chunks)
    h = ii.decode_output(codes, ip["s_out_last"], qcfg.bits_out,
                         scale=ip.get("decode_scale"))
    h = torch.mean(h, dim=1)  # FP global average pool (paper §3.4)
    return fql.dense(ip["head"], h)


def qat_apply(params, state, x, qcfg: QuantConfig, cfg: KWSConfig, *,
              impl=None, noise=None, rng=None, mac_chunks: int = 1):
    """Deployment-in-the-loop forward: value == ``int_apply`` of the
    converted params (same codes, same noise draws for the same key, sigma
    and ``mac_chunks``), gradient == the float FQ/STE path.

    ``params`` must be BN-folded FQ params (after ``to_fq``). Layer i reads
    layer i-1's s_out, so the stored inner s_in go stale in training:
    ``sync_handoff`` before converting. One plan and one key split with
    ``int_apply``.
    """
    plan = layer_plan(cfg)
    h = fql.dense(params["embed"], x)
    h, _ = fql.batchnorm(params["embed_bn"], state["embed_bn"], h)
    codes, s_prev = None, None
    for (name, dil), r in zip(plan, prng.layer_keys(rng, len(plan))):
        h, codes = dq.qat_conv1d(params[name], h, codes, qcfg,
                                 ksize=cfg.ksize, dilation=dil, s_in=s_prev,
                                 noise=noise, rng=r, mac_chunks=mac_chunks,
                                 impl=impl)
        s_prev = params[name]["s_out"]
    h = torch.mean(h, dim=1)  # FP global average pool (paper §3.4)
    return fql.dense(params["head"], h)


def int_serve_fn(ip, qcfg: QuantConfig, cfg: KWSConfig, **kw):
    """Fixed-signature serving closure: (B, T, n_mfcc) -> logits.

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
