"""Integer-only inference (paper eq. 4 + §3.4 deployment story).

Counterpart of ``repro.core.integer_inference``, noise-free and int8 only.
A trained FQ layer collapses to

    int8 weight codes  +  one folded rescale scalar per layer,

and the conv stack runs integer-in / integer-out on the K2/K3/K3b kernels.
Only the final decode scale escapes to float, for the FP pooling and head.

The deployment artifact is a :class:`ConvertedStack`: per-layer codes and
folded scalars plus the float-side extras (FP edge layers, entry quantizer,
final decode scale). It is mapping-compatible (``stack["conv0"]``), and
``.to(device)`` takes the place of the reference's ``place_stack``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch

from ..kernels import ops
from .quant import (QuantConfig, RELU_BOUND, WEIGHT_BOUND, n_levels,
                    quantize_to_int)


def _validate_layer(p, out, name: Optional[str]):
    """Conversion-time range checks: raise, never deploy clipped garbage."""
    tag = f"convert_layer({name or 'layer'})"
    for k in ("s_in", "s_w", "s_out"):
        if not bool(torch.isfinite(torch.as_tensor(p[k])).all()):
            raise ValueError(f"{tag}: non-finite scale param {k!r}")
    if not bool(torch.isfinite(p["w"]).all()):
        raise ValueError(f"{tag}: non-finite weights (quantize_to_int would "
                         "cast NaN/inf to garbage int8 codes)")
    c = out["w_codes"]
    lo, hi = int(c.min()), int(c.max())
    if lo < -out["n_w"] or hi > out["n_w"]:
        raise ValueError(f"{tag}: weight codes [{lo}, {hi}] outside the "
                         f"recorded quantizer range [-{out['n_w']}, "
                         f"{out['n_w']}]")
    s = float(out["alpha"] if "alpha" in out else out["rescale"])
    if not math.isfinite(s) or s <= 0.0:
        raise ValueError(f"{tag}: folded epilogue scalar is {s!r} "
                         "(expected finite and > 0)")


def convert_layer(p, qcfg: QuantConfig, *, relu_out: bool = True,
                  final: bool = False, name: Optional[str] = None,
                  weight_format: str = "int8"):
    """Trained FQ layer params -> integer deployment params.

    Returns ``w_codes`` in the im2col layout (taps*cin, cout) plus the folded
    epilogue scalar: ``rescale`` (inner layers) or ``alpha`` (final layer).
    The codes and the scalar are validated; a bad layer raises.
    """
    assert qcfg.fq and qcfg.bits_out is not None and qcfg.bits_w is not None
    ops.refuse_unported(f"convert_layer({name or 'layer'})",
                        weight_format=weight_format)
    w_codes = quantize_to_int(p["w"], p["s_w"], bits=qcfg.bits_w,
                              b=WEIGHT_BOUND)
    out = {
        "w_codes": w_codes.reshape(-1, w_codes.shape[-1]).contiguous(),
        "weight_format": weight_format,
        "n_out": n_levels(qcfg.bits_out),
        "lo": 0 if relu_out else -n_levels(qcfg.bits_out),
        "s_out": p["s_out"],
        "n_w": n_levels(qcfg.bits_w),
        "n_a": n_levels(qcfg.bits_a if qcfg.bits_a is not None
                        else qcfg.bits_out),
    }
    if final:
        out["alpha"] = ops.fold_alpha(p["s_in"], p["s_w"], bits_a=qcfg.bits_a,
                                      bits_w=qcfg.bits_w)
    else:
        out["rescale"] = ops.fold_rescale(
            p["s_in"], p["s_w"], p["s_out"], bits_a=qcfg.bits_a,
            bits_w=qcfg.bits_w, bits_out=qcfg.bits_out)
    _validate_layer(p, out, name)
    return out


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static per-layer conversion recipe."""
    name: str
    relu_out: bool = True
    final: bool = False
    weight_format: str = "int8"


def to_device(x, device):
    """Tensors in nested dicts / tuples / lists -> copies on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x


class ConvertedStack:
    """Per-layer integer deployment params + float-side extras, one artifact.

    * ``layers``: {name: converted dict} from :func:`convert_layer`.
    * ``extras``: what the integer core does not own (FP edge layers, the
      ``entry`` quantizer scale, the ``s_out_last`` decode scale).
    * ``specs``/``qcfg``: the static conversion recipe.

    ``stack["conv0"]`` resolves layers first, then extras.
    """

    def __init__(self, qcfg: QuantConfig, specs: Sequence[LayerSpec],
                 layers: Dict[str, dict], extras: Dict[str, Any]):
        self.qcfg = qcfg
        self.specs = tuple(specs)
        self.layers = dict(layers)
        self.extras = dict(extras)

    def __getitem__(self, key: str):
        if key in self.layers:
            return self.layers[key]
        return self.extras[key]

    def __contains__(self, key: str) -> bool:
        return key in self.layers or key in self.extras

    def keys(self):
        return list(self.layers) + list(self.extras)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.layers) + len(self.extras)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    @property
    def layer_names(self):
        return tuple(s.name for s in self.specs)

    @property
    def device(self) -> torch.device:
        return self.layers[self.specs[0].name]["w_codes"].device

    def to(self, device) -> "ConvertedStack":
        """A copy with every tensor on ``device`` (statics unchanged)."""
        return ConvertedStack(self.qcfg, self.specs,
                              to_device(self.layers, device),
                              to_device(self.extras, device))


def _check_handoff(layer_params: Dict[str, dict], specs: Sequence[LayerSpec],
                   *, atol: float = 1e-6):
    """Validate the FQ hand-off contract s_in[i+1] == s_out[i]."""
    for a, b in zip(specs, specs[1:]):
        s_out = torch.as_tensor(layer_params[a.name]["s_out"])
        s_in = torch.as_tensor(layer_params[b.name]["s_in"])
        if not torch.allclose(s_in.cpu(), s_out.cpu(), atol=atol):
            raise ValueError(
                f"FQ hand-off contract violated between {a.name!r} and "
                f"{b.name!r}: s_in={float(s_in):.6f} != "
                f"s_out={float(s_out):.6f}. Run "
                "integer_inference.sync_handoff(params, names) first.")


def sync_handoff(params: Dict[str, dict], names: Sequence[str]):
    """Enforce s_in[i+1] = s_out[i] along a layer chain; returns a new dict."""
    new = dict(params)
    for a, b in zip(names, names[1:]):
        new[b] = {**new[b], "s_in": new[a]["s_out"]}
    return new


def convert_stack(layer_params: Dict[str, dict], qcfg: QuantConfig, *,
                  specs: Sequence[LayerSpec], extras: Dict[str, Any],
                  weight_format: Optional[str] = None) -> ConvertedStack:
    """Convert an ordered chain of trained FQ layers into a ConvertedStack,
    after checking the hand-off contract along the chain."""
    specs = tuple(specs)
    if weight_format is not None:
        ops.refuse_unported("convert_stack", weight_format=weight_format)
    _check_handoff(layer_params, specs)
    layers = {
        s.name: convert_layer(layer_params[s.name], qcfg,
                              relu_out=s.relu_out, final=s.final, name=s.name,
                              weight_format=s.weight_format)
        for s in specs
    }
    return ConvertedStack(qcfg, specs, layers, extras)


def entry_codes(x, p, qcfg: QuantConfig, *, b_in: float = RELU_BOUND):
    """Quantize a float tensor entering the integer stack to int8 codes.

    Uses the stack's carried ``inv_scale`` (e^{-s_in}) when present.
    """
    return ops.quantize_to_codes(x, p["s_in"], bits=qcfg.bits_a, b=b_in,
                                 inv_scale=p.get("inv_scale"))


def int_linear(ip, codes, *, noise=None):
    ops.refuse_unported("int_linear", noise=noise)
    return ops.int_matmul(codes, ip["w_codes"], ip["rescale"],
                          epilogue="requant", n_out=ip["n_out"], lo=ip["lo"],
                          weight_format=ip.get("weight_format", "int8"))


def int_linear_final(ip, codes):
    return ops.int_matmul(codes, ip["w_codes"], ip["alpha"],
                          epilogue="dequant",
                          weight_format=ip.get("weight_format", "int8"))


def int_conv1d(ip, codes, *, ksize: int, dilation: int = 1, impl=None,
               noise=None):
    ops.refuse_unported("int_conv1d", noise=noise)
    return ops.fq_conv1d_int(codes, ip["w_codes"], ip["rescale"],
                             ksize=ksize, dilation=dilation,
                             n_out=ip["n_out"], lo=ip["lo"], impl=impl,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv1d_final(ip, codes, *, ksize: int, dilation: int = 1, impl=None):
    return ops.fq_conv1d_int(codes, ip["w_codes"], ip["alpha"],
                             ksize=ksize, dilation=dilation,
                             epilogue="dequant", impl=impl,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv2d(ip, codes, *, ksize: int, stride: int = 1, padding: int = 0,
               dilation: int = 1, impl=None, noise=None):
    ops.refuse_unported("int_conv2d", noise=noise)
    return ops.fq_conv2d_int(codes, ip["w_codes"], ip["rescale"],
                             ksize=ksize, stride=stride, padding=padding,
                             dilation=dilation, n_out=ip["n_out"],
                             lo=ip["lo"], impl=impl,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv2d_pool(ip, codes, *, ksize: int, stride: int = 1,
                    padding: int = 0, dilation: int = 1, pool: int = 2,
                    impl=None, noise=None):
    """Conv + non-overlapping max-pool as one integer op.

    On the fused path the pool runs on the int32 accumulator in the conv
    kernel's epilogue (K3b) and the unpooled codes never reach device
    memory; the im2col path is the unfused conv + code-domain pool.
    """
    ops.refuse_unported("int_conv2d_pool", noise=noise)
    return ops.fq_conv2d_pool_int(codes, ip["w_codes"], ip["rescale"],
                                  ksize=ksize, stride=stride,
                                  padding=padding, dilation=dilation,
                                  pool=pool, n_out=ip["n_out"], lo=ip["lo"],
                                  impl=impl,
                                  weight_format=ip.get("weight_format",
                                                       "int8"))


def int_maxpool2d(codes, *, window: int = 2, stride: int = 2):
    """Max-pool directly on int8 codes (NHWC): exact, because the learned
    quantizer is monotone, so pooling commutes with requantization."""
    return ops.maxpool2d(codes, window=window, stride=stride)


def decode_output(codes_or_float, s_out, bits_out: Optional[int]):
    """Final-layer codes -> real values: e^s / n * codes (paper §3.4)."""
    if bits_out is None:
        return codes_or_float
    return (torch.exp(s_out) / n_levels(bits_out)
            * codes_or_float.to(torch.float32))
