"""Integer-only inference (paper eq. 4 + §3.4 deployment story).

Counterpart of ``repro.core.integer_inference``. A trained FQ layer
collapses to

    int8 weight codes  +  one folded rescale scalar per layer,

and the conv stack runs integer-in / integer-out on the K2/K3/K3b kernels.
The weight codes may be stored packed, 2 (int4) or 4 (ternary) per byte;
the kernels then read the packed bytes. Only the final decode scale escapes
to float, for the FP pooling and head.

The deployment artifact is a :class:`ConvertedStack`: per-layer codes and
folded scalars plus the float-side extras (FP edge layers, entry quantizer,
final decode scale). It is mapping-compatible (``stack["conv0"]``), carries
its conversion recipe (:meth:`ConvertedStack.rederive`) and a content
digest (:func:`stack_digest`); :func:`place_stack` / :func:`replicate_stack`
(``ConvertedStack.to``) put copies of it on devices.

The paper's §4.4 noise model runs at every integer layer boundary when the
caller passes a :class:`~.noise.NoiseConfig` and a key
(:func:`noisy_operands`): weight and activation codes perturbed in code
units, and the ADC noise in the kernels' epilogue (K4).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import prng, quant
from .noise import NoiseConfig, derive_seed, perturb_codes
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
    # packed codes are decoded first; the zero pad lanes are in range
    c = quant.unpack_codes(out["w_codes"], out.get("weight_format", "int8"))
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
                  final: bool = False, validate: bool = True,
                  name: Optional[str] = None, weight_format: str = "int8"):
    """Trained FQ layer params -> integer deployment params.

    Returns ``w_codes`` plus the folded epilogue scalar: ``rescale`` (inner
    layers) or ``alpha`` (final layer). ``weight_format`` "int8" keeps the
    im2col layout (taps*cin, cout) int8; "int4"/"ternary" pack 2/4 codes
    per byte, conv weights with cin padded per tap to the pack factor. A
    format too narrow for bits_w codes raises (never clip a trained code).
    With ``validate`` the codes and the scalar are checked and a bad layer
    raises; the checks read values back to the host, so the deploy-QAT
    forward, which converts every layer in every step, passes False.
    """
    assert qcfg.fq and qcfg.bits_out is not None and qcfg.bits_w is not None
    tag = f"convert_layer({name or 'layer'})"
    if weight_format not in quant.WEIGHT_FORMATS:
        raise ValueError(f"{tag}: unknown weight_format {weight_format!r}; "
                         f"expected one of {quant.WEIGHT_FORMATS}")
    if quant.format_range(weight_format) < n_levels(qcfg.bits_w):
        raise ValueError(
            f"{tag}: weight_format={weight_format!r} holds codes in "
            f"+-{quant.format_range(weight_format)} but bits_w="
            f"{qcfg.bits_w} trains codes in +-{n_levels(qcfg.bits_w)}: "
            "refusing to clip")
    w_codes = quantize_to_int(p["w"], p["s_w"], bits=qcfg.bits_w,
                              b=WEIGHT_BOUND)
    flat = w_codes.reshape(-1, w_codes.shape[-1]).contiguous()
    if weight_format == "int8":
        stored = flat
    elif w_codes.dim() >= 3:
        # conv weights (taps..., cin, cout): every tap owns whole byte rows
        stored = quant.pack_im2col_codes(flat, math.prod(w_codes.shape[:-2]),
                                         weight_format)
    else:
        stored = quant.pack_codes(flat, weight_format)
    out = {
        "w_codes": stored,
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
    if validate:
        _validate_layer(p, out, name)
    return out


# a scale tie of a residual-add DAG: (src, src_field, dst, dst_field)
Edge = Tuple[str, str, str, str]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static per-layer conversion recipe. ``weight_format`` is part of it:
    :meth:`ConvertedStack.rederive` re-packs with the same format."""
    name: str
    relu_out: bool = True
    final: bool = False
    weight_format: str = "int8"


def to_device(x, device, *, copy: bool = False):
    """Tensors in nested dicts / tuples / lists -> tensors on ``device``;
    a tensor already there is shared unless ``copy``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=copy)
    if isinstance(x, dict):
        return {k: to_device(v, device, copy=copy) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device, copy=copy) for v in x)
    return x


class ConvertedStack:
    """Per-layer integer deployment params + float-side extras, one artifact.

    * ``layers``: {name: converted dict} from :func:`convert_layer`.
    * ``extras``: what the integer core does not own (FP edge layers, the
      ``entry`` quantizer scale, the ``s_out_last`` decode scale). Where
      ``s_out_last`` is present and the output is coded, the stack adds
      ``decode_scale`` = e^{s_out_last} / n, derived here whenever a stack
      is made (so :meth:`rederive` and :meth:`to` keep it in step), so that
      ``int_apply`` decodes with one multiply and no ``exp`` per request.
    * ``specs``/``qcfg``: the static conversion recipe, so the stack can
      re-derive itself from updated float weights (:meth:`rederive`).

    * ``handoff_edges``: None for a chain (the hand-off checked pairwise
      over the specs), or ``(src, src_field, dst, dst_field)`` scale ties
      of a residual-add DAG (the integer LM's stream), checked by
      :meth:`rederive` and kept by :meth:`to`.

    ``stack["conv0"]`` resolves layers first, then extras.
    """

    def __init__(self, qcfg: QuantConfig, specs: Sequence[LayerSpec],
                 layers: Dict[str, dict], extras: Dict[str, Any],
                 handoff_edges: Optional[Sequence[Edge]] = None):
        self.qcfg = qcfg
        self.specs = tuple(specs)
        self.layers = dict(layers)
        self.extras = dict(extras)
        self.handoff_edges = (None if handoff_edges is None
                              else tuple(tuple(e) for e in handoff_edges))
        if "s_out_last" in self.extras and qcfg.bits_out is not None:
            self.extras["decode_scale"] = decode_scale(
                self.extras["s_out_last"], qcfg.bits_out)

    def __getitem__(self, key: str):
        if key in self.layers:
            return self.layers[key]
        return self.extras[key]

    def get(self, key: str, default=None):
        return self[key] if key in self else default

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

    def to(self, device, *, copy: bool = False) -> "ConvertedStack":
        """A stack with every tensor on ``device`` (statics unchanged); a
        tensor already on ``device`` is shared unless ``copy``."""
        return ConvertedStack(self.qcfg, self.specs,
                              to_device(self.layers, device, copy=copy),
                              to_device(self.extras, device, copy=copy),
                              handoff_edges=self.handoff_edges)

    def rederive(self, layer_params: Dict[str, dict], *, extras=None,
                 check_handoff: bool = True) -> "ConvertedStack":
        """Updated float layer params -> a freshly converted stack.

        Re-runs the same recipe (specs, with their weight formats, and
        qcfg) over ``layer_params``; from unchanged params it gives the same
        codes, bytes and scalars. The extras that are functions of the
        layer params are re-derived too: the ``entry`` scale (first layer's
        s_in, with the port's ``inv_scale`` = e^{-s_in} where the stack
        carries one) and the ``s_out_last`` decode scale. ``extras=None``
        keeps the other extras (FP edge layers). A DAG stack re-checks and
        keeps its ``handoff_edges``.
        """
        if check_handoff:
            if self.handoff_edges is not None:
                _check_handoff_edges(layer_params, self.handoff_edges)
            else:
                _check_handoff(layer_params, self.specs)
        layers = {
            s.name: convert_layer(layer_params[s.name], self.qcfg,
                                  relu_out=s.relu_out, final=s.final,
                                  name=s.name, weight_format=s.weight_format)
            for s in self.specs
        }
        extras = dict(self.extras if extras is None else extras)
        if "entry" in extras:
            s_in = layer_params[self.specs[0].name]["s_in"]
            entry = {"s_in": s_in}
            if "inv_scale" in extras["entry"]:
                entry["inv_scale"] = quant.exp(-torch.as_tensor(s_in))
            extras["entry"] = entry
        if "s_out_last" in extras:
            extras["s_out_last"] = layer_params[self.specs[-1].name]["s_out"]
        return ConvertedStack(self.qcfg, self.specs, layers, extras,
                              handoff_edges=self.handoff_edges)


def place_stack(stack: ConvertedStack, device) -> ConvertedStack:
    """``stack`` with its tensors on ``device``.

    The kernel statics (n_out / lo / n_w / n_a / weight_format) are Python
    values that ride along unchanged, so the placed stack serves the same
    codes and :func:`stack_digest` is placement-invariant."""
    return stack.to(device)


def replicate_stack(stack: ConvertedStack, devices) -> list:
    """One placed copy of ``stack`` per device (the fleet's replica lanes).

    Each copy owns its buffers, also where two lanes share a device (one
    card, several lanes): the reference's CPU simulation shares one backing
    store among its replicas, the port makes real device copies."""
    return [stack.to(d, copy=True) for d in devices]


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


def _check_handoff_edges(layer_params: Dict[str, dict],
                         edges: Sequence[Edge], *, atol: float = 1e-6):
    """Validate the hand-off contract over a scale-tie edge list, the chain
    contract extended to residual-add DAGs: each edge's two scales are
    equal (for a residual add, every branch rejoining the stream
    requantizes onto the stream's scale)."""
    for src, sf, dst, df in edges:
        s_src = torch.as_tensor(layer_params[src][sf]).cpu()
        s_dst = torch.as_tensor(layer_params[dst][df]).cpu()
        if not torch.allclose(s_dst, s_src, atol=atol):
            raise ValueError(
                f"FQ hand-off contract violated on edge {src}.{sf} -> "
                f"{dst}.{df}: {float(s_dst):.6f} != {float(s_src):.6f}. Run "
                "integer_inference.sync_handoff_edges(params, edges) first.")


def sync_handoff_edges(params: Dict[str, dict], edges: Sequence[Edge]):
    """Copy ``src.src_field -> dst.dst_field`` for every edge, in order;
    returns a new dict (the input is not changed). Edges listed in
    topological order propagate ties from one root in one pass."""
    new = dict(params)
    for src, sf, dst, df in edges:
        new[dst] = {**new[dst], df: new[src][sf]}
    return new


def sync_handoff(params: Dict[str, dict], names: Sequence[str]):
    """Enforce s_in[i+1] = s_out[i] along a layer chain; returns a new dict."""
    new = dict(params)
    for a, b in zip(names, names[1:]):
        new[b] = {**new[b], "s_in": new[a]["s_out"]}
    return new


def convert_stack(layer_params: Dict[str, dict], qcfg: QuantConfig, *,
                  specs: Sequence[LayerSpec], extras: Dict[str, Any],
                  weight_format: Optional[str] = None,
                  handoff_edges: Optional[Sequence[Edge]] = None
                  ) -> ConvertedStack:
    """Convert an ordered chain (or DAG) of trained FQ layers into a
    ConvertedStack, after checking the hand-off contract: along the chain,
    or over ``handoff_edges`` (recorded on the stack) for a residual DAG.

    ``weight_format`` overrides every spec's storage format: a format name,
    or "auto" for the densest one that holds bits_w codes (ternary for
    bits_w = 2). The resolved format is recorded on the specs, so
    :meth:`ConvertedStack.rederive` re-packs identically. ``None`` keeps
    each spec's own format.
    """
    specs = tuple(specs)
    if weight_format is not None:
        fmt = (quant.auto_weight_format(n_levels(qcfg.bits_w))
               if weight_format == "auto" else weight_format)
        specs = tuple(dataclasses.replace(s, weight_format=fmt)
                      for s in specs)
    if handoff_edges is not None:
        _check_handoff_edges(layer_params, handoff_edges)
    else:
        _check_handoff(layer_params, specs)
    layers = {
        s.name: convert_layer(layer_params[s.name], qcfg,
                              relu_out=s.relu_out, final=s.final, name=s.name,
                              weight_format=s.weight_format)
        for s in specs
    }
    return ConvertedStack(qcfg, specs, layers, extras,
                          handoff_edges=handoff_edges)


def stack_digest(stack: ConvertedStack) -> str:
    """Short content digest of a deployment artifact.

    The reference's function, byte for byte: the qcfg label, the specs
    (with their weight formats), then every layer's and every extra's
    leaves in sorted-key order, a python number as its ``repr`` and an
    array as dtype, shape and bytes. So a stack carried across with
    ``interop`` digests to the reference's hex. Each tensor is hashed as
    the numpy array the reference would hold (same dtype, shape and
    C-order bytes, whatever its device). The port's ``entry.inv_scale``
    (e^{-s_in}, carried so the entry quantizer needs no ``exp``) has no
    reference leaf: it is a function of the hashed ``s_in`` and is left
    out, as is ``decode_scale``, a function of ``s_out_last``. A packed
    stack digests apart from its int8 twin: the format is in
    the specs and the bytes differ. A DAG stack folds its edges in after
    the specs; a chain (edges None) hashes as it did before edges existed.
    """
    h = hashlib.blake2s(digest_size=10)
    h.update(stack.qcfg.label().encode())
    for s in stack.specs:
        h.update(f"{s.name}:{int(s.relu_out)}:{int(s.final)}"
                 f":{s.weight_format}".encode())
    for e in stack.handoff_edges or ():
        h.update(":".join(e).encode())

    def leaf(x):
        if isinstance(x, (int, float, bool)):
            h.update(repr(x).encode())
            return
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(x))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            leaf(x)

    for name in stack.layer_names:
        h.update(name.encode())
        walk(stack.layers[name])
    extras = dict(stack.extras)
    extras.pop("decode_scale", None)
    if "entry" in extras:
        extras["entry"] = {k: v for k, v in extras["entry"].items()
                           if k != "inv_scale"}
    walk(extras)
    return h.hexdigest()


def entry_codes(x, p, qcfg: QuantConfig, *, b_in: float = RELU_BOUND):
    """Quantize a float tensor entering the integer stack to int8 codes.

    Uses the stack's carried ``inv_scale`` (e^{-s_in}) when present.
    """
    return ops.quantize_to_codes(x, p["s_in"], bits=qcfg.bits_a, b=b_in,
                                 inv_scale=p.get("inv_scale"))


def noisy_operands(ip, codes, noise: Optional[NoiseConfig], rng, *,
                   a_lo: int = 0):
    """The paper's §4.4 noise model at an integer layer boundary.

    Returns ``(w_codes, a_codes, sigma_acc, seed)``: the weight codes
    perturbed in code units (memory-cell noise, clipped to [-n_w, n_w];
    packed weights are unpacked, perturbed, re-packed: the perturbed pad
    lanes meet zero activations on every impl), the input codes perturbed
    (DAC noise, clipped to [a_lo, max(n_a, n_out)]), and the ADC noise std
    in accumulator units, sigma_mac / rescale (float32 tensor), with the
    uint32 seed of its field. ``rng`` splits into the three keys in that
    order, as the reference's does.

    With ``noise`` None or all-zero, or ``rng`` None, the operands come back
    untouched with ``(None, None)``, nothing is drawn and the clean kernels
    run.
    """
    if noise is None or not noise.enabled or rng is None:
        return ip["w_codes"], codes, None, None
    k_w, k_a, k_mac = prng.split(rng.to(codes.device), 3)
    n_w = ip.get("n_w", 127)
    a_hi = max(ip.get("n_a", 127), ip.get("n_out", 127))
    fmt = ip.get("weight_format", "int8")
    w_codes = quant.unpack_codes(ip["w_codes"], fmt)
    w_codes = perturb_codes(w_codes, k_w, noise.sigma_w, lo=-n_w, hi=n_w)
    if fmt != "int8":
        w_codes = quant.pack_codes(w_codes, fmt)
    a_codes = perturb_codes(codes, k_a, noise.sigma_a, lo=a_lo, hi=a_hi)
    if noise.sigma_mac > 0:
        rescale = ip["rescale"]
        sigma_acc = torch.div(torch.full_like(rescale, noise.sigma_mac),
                              rescale)
        return w_codes, a_codes, sigma_acc, derive_seed(k_mac)
    return w_codes, a_codes, None, None


def int_linear(ip, codes, *, noise: Optional[NoiseConfig] = None, rng=None,
               mac_chunks: int = 1, a_lo: int = 0):
    w_codes, codes, sig, seed = noisy_operands(ip, codes, noise, rng,
                                               a_lo=a_lo)
    return ops.int_matmul(codes, w_codes, ip["rescale"],
                          epilogue="requant", n_out=ip["n_out"], lo=ip["lo"],
                          noise_sigma_acc=sig, noise_seed=seed,
                          mac_chunks=mac_chunks,
                          weight_format=ip.get("weight_format", "int8"))


def int_residual_add(a_codes, b_codes, *, n_out: int,
                     lo: Optional[int] = None):
    """Code-domain residual add at a common scale: both operands are codes
    of the same output quantizer (what a DAG's requant-to-common-scale
    edges guarantee), so the add is a saturating integer add: widen to
    int32, clip to [lo, n_out] (lo = -n_out by default), narrow to int8."""
    lo = -n_out if lo is None else lo
    acc = a_codes.to(torch.int32) + b_codes.to(torch.int32)
    return torch.clamp(acc, lo, n_out).to(torch.int8)


def int_linear_final(ip, codes):
    return ops.int_matmul(codes, ip["w_codes"], ip["alpha"],
                          epilogue="dequant",
                          weight_format=ip.get("weight_format", "int8"))


def int_conv1d(ip, codes, *, ksize: int, dilation: int = 1, impl=None,
               noise: Optional[NoiseConfig] = None, rng=None,
               mac_chunks: int = 1):
    w_codes, codes, sig, seed = noisy_operands(ip, codes, noise, rng)
    return ops.fq_conv1d_int(codes, w_codes, ip["rescale"],
                             ksize=ksize, dilation=dilation,
                             n_out=ip["n_out"], lo=ip["lo"], impl=impl,
                             noise_sigma_acc=sig, noise_seed=seed,
                             mac_chunks=mac_chunks,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv1d_final(ip, codes, *, ksize: int, dilation: int = 1, impl=None):
    return ops.fq_conv1d_int(codes, ip["w_codes"], ip["alpha"],
                             ksize=ksize, dilation=dilation,
                             epilogue="dequant", impl=impl,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv2d(ip, codes, *, ksize: int, stride: int = 1, padding: int = 0,
               dilation: int = 1, impl=None,
               noise: Optional[NoiseConfig] = None, rng=None,
               mac_chunks: int = 1):
    w_codes, codes, sig, seed = noisy_operands(ip, codes, noise, rng)
    return ops.fq_conv2d_int(codes, w_codes, ip["rescale"],
                             ksize=ksize, stride=stride, padding=padding,
                             dilation=dilation, n_out=ip["n_out"],
                             lo=ip["lo"], impl=impl, noise_sigma_acc=sig,
                             noise_seed=seed, mac_chunks=mac_chunks,
                             weight_format=ip.get("weight_format", "int8"))


def int_conv2d_pool(ip, codes, *, ksize: int, stride: int = 1,
                    padding: int = 0, dilation: int = 1, pool: int = 2,
                    impl=None, noise: Optional[NoiseConfig] = None, rng=None,
                    mac_chunks: int = 1):
    """Conv + non-overlapping max-pool as one integer op.

    On the fused path the pool runs on the int32 accumulator in the conv
    kernel's epilogue (K3b) and the unpooled codes never reach device
    memory; the im2col path is the unfused conv + code-domain pool. ADC
    noise perturbs the pre-pool accumulator on both.
    """
    w_codes, codes, sig, seed = noisy_operands(ip, codes, noise, rng)
    return ops.fq_conv2d_pool_int(codes, w_codes, ip["rescale"],
                                  ksize=ksize, stride=stride,
                                  padding=padding, dilation=dilation,
                                  pool=pool, n_out=ip["n_out"], lo=ip["lo"],
                                  impl=impl, noise_sigma_acc=sig,
                                  noise_seed=seed, mac_chunks=mac_chunks,
                                  weight_format=ip.get("weight_format",
                                                       "int8"))


def int_maxpool2d(codes, *, window: int = 2, stride: int = 2):
    """Max-pool directly on int8 codes (NHWC): exact, because the learned
    quantizer is monotone, so pooling commutes with requantization."""
    return ops.maxpool2d(codes, window=window, stride=stride)


def decode_scale(s_out, bits_out: int) -> torch.Tensor:
    """e^{s_out} / n, the multiplier that decodes final-layer codes, on
    ``s_out``'s device (n as a tensor there: no host number divides)."""
    e = quant.exp(torch.as_tensor(s_out))
    return torch.div(e, torch.full_like(e, n_levels(bits_out)))


def decode_output(codes_or_float, s_out, bits_out: Optional[int], *,
                  scale=None):
    """Final-layer codes -> real values: e^s / n * codes (paper §3.4).

    ``scale`` is :func:`decode_scale` of ``s_out`` when the caller carries
    it (a converted stack's ``decode_scale``); otherwise it is computed
    here, as deploy-QAT does, whose ``s_out`` changes every step."""
    if bits_out is None:
        return codes_or_float
    if scale is None:
        scale = decode_scale(
            torch.as_tensor(s_out, device=codes_or_float.device), bits_out)
    return scale * codes_or_float.to(torch.float32)
