"""Learned quantization (paper eq. 1 & 2): the integer-inference subset.

Counterpart of ``repro.core.quant``:

    quantize(x) = round(clip(x, b, 1) * n) / n              (1)
    Q(x)        = e^s * quantize(x / e^s)                   (2)

with ``b`` the clip lower bound (-1 for weights / linear outputs, 0 for
quantized ReLUs) and ``n = 2^(nb-1) - 1`` positive levels for ``nb`` bits.
``torch.round`` rounds half to even, like ``jnp.round``, so codes that sit
exactly on a half-LSB land on the same integer as in the reference.

The training side follows the reference expression by expression, so the
forward values are the reference's bit for bit wherever ``torch.exp``
rounds e^s as XLA does (C1), and the straight-through gradients are its
gradients:

  * the clip is ``minimum(maximum(x, b), 1)``, as ``jnp.clip`` is written:
    at a bound each side takes half the gradient (``torch.clamp`` would
    pass all of it);
  * ``ste_round`` and ``_grad_scale`` keep the reference's
    ``v + stop_gradient(.)`` forms with ``.detach()``: ``_grad_scale`` is
    not an identity in float32;
  * every division is tensor by tensor: CUDA turns ``t / <python number>``
    into a multiply by the reciprocal, 1 ulp off in some outputs.

Beside them, the packed weight formats (``int4``, ``ternary``): storage of
several weight codes per byte, the layout the kernels' packed prologue
(K5) reads; and ``LADDERS``, the paper's gradual-quantization ladders.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import tracing

WEIGHT_BOUND = -1.0  # b for weights / conv outputs / network inputs
RELU_BOUND = 0.0     # b for quantized ReLUs


def n_levels(bits: int) -> int:
    """Number of positive quantization levels, n = 2^(nb-1) - 1 (paper §3.1)."""
    if bits < 2:
        raise ValueError(f"bits must be >= 2 (got {bits}); bits=2 is ternary")
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Bitwidths for one gradual-quantization ladder stage.

    ``None`` means full precision. ``fq`` marks the fully quantized mode in
    which the output quantizer doubles as the nonlinearity.
    """

    bits_w: Optional[int] = None
    bits_a: Optional[int] = None
    bits_out: Optional[int] = None
    fq: bool = False

    @property
    def is_fp(self) -> bool:
        return self.bits_w is None and self.bits_a is None

    def label(self) -> str:
        def f(v):
            return "32" if v is None else str(v)

        base = f"W{f(self.bits_w)}A{f(self.bits_a)}"
        return ("FQ" if self.fq else "Q") + base


def _const(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float tensor of ``v`` on ``like``'s device, in its dtype."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


# XLA's float32 exp on the CPU (the reference's): Cephes' expf with every
# multiply-add fused. Each fma is taken in float64, where the product of two
# float32 values is exact, then rounded to float32. At the edges XLA is not
# Cephes: the input is clamped just past ln(FLT_MAX) and n = round(s log2 e)
# at 127, so e^s stays finite up to 88.7228 (r runs up to ln 2 there); and
# results below FLT_MIN are flushed to 0 (XLA runs with denormals off).
# Both edges checked against ``jnp.exp`` over every float32 in
# [88.3, 88.8] and [-87.8, -87.2].
_EXP_LO, _EXP_HI = -88.3762626647949, 88.73
_FLT_MIN = 1.1754943508222875e-38
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f32(v: float) -> float:
    """A Python number rounded to the nearest float32."""
    return float(torch.tensor(v, dtype=torch.float32))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (a, b, c float32 values)."""
    return (a.double() * b + c).float()


class _ExpXLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s):
        x = torch.clamp(s.float(), _f32(_EXP_LO), _f32(_EXP_HI))
        fx = torch.clamp(torch.floor(_fma32(x, _f32(_LOG2E), 0.5)), max=127.0)
        r = _fma32(fx, -_f32(_LN2_HI), x.double())
        r = _fma32(fx, -_f32(_LN2_LO), r.double())
        y = torch.full_like(r, _f32(_EXP_POLY[0]))
        for p in _EXP_POLY[1:]:
            y = _fma32(y, r.double(), _f32(p))
        y = _fma32(y, (r * r).double(), r.double()) + 1.0
        two_n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
        out = y * two_n
        out = torch.where(out < _FLT_MIN, torch.zeros_like(out), out)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return g * out


def exp(s: torch.Tensor) -> torch.Tensor:
    """float32 e^s bit for bit as the reference computes it (XLA on the CPU;
    ``torch.exp`` is 1 ulp off in ~9.6% of inputs, C1), on any device and
    over the whole float32 range; its gradient is e^s. For the log-scales
    of the quantizers and the integer folds, where an ulp of e^s moves a
    value across a rounding boundary or a clip bound."""
    return _ExpXLA.apply(s)


# XLA's float32 log on the CPU (the reference's): Cephes' logf as XLA's CPU
# backend emits it, the mantissa m in [0.5, 1) shifted to [sqrt(1/2) - 1,
# sqrt(2) - 1), the degree-8 polynomial in three Horner chains joined by
# x^3, every multiply-add fused (in float64, where the product of two
# float32 values is exact, then rounded to float32), the y * x^3 product
# fused with the add of -2.12194440e-4 * e. Inputs below FLT_MIN are 0
# (XLA runs with denormals off): log gives -inf there, NaN below -0, +inf
# at +inf. Checked against ``jnp.log`` bit for bit over every float32 of
# bands across [FLT_MIN, 1] and [e^-12, e^8] (tests/test_torch_decode.py).
_SQRTHF = 0.707106781186547524
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log bit for bit as the reference computes it (XLA on
    the CPU; ``torch.log`` is an ulp off in ~4% of inputs, C11), on any
    device. For the Gumbel draws of sampled decoding, whose tokens must be
    the reference's. No gradient."""
    x = x.float()
    t = torch.maximum(x, torch.full_like(x, _FLT_MIN))
    bits = t.view(torch.int32)
    t = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    small = t < _f32(_SQRTHF)
    e = e - small.float()
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c) for c in _LOG_POLY]
    td = t.double()
    y = _fma32(td, p[0], p[1])
    y1 = _fma32(td, p[3], p[4])
    y2 = _fma32(td, p[6], p[7])
    y = _fma32(y, td, p[2])
    y1 = _fma32(y1, td, p[5])
    y2 = _fma32(y2, td, p[8])
    x3d = x3.double()
    y = _fma32(y, x3d, y1.double())
    y = _fma32(y, x3d, y2.double())
    y = _fma32(y, x3d, (e * _f32(_LOG_Q1)).double())
    t = _fma32(x2, -0.5, t.double())
    t = t + y
    t = _fma32(e, _f32(_LOG_Q2), t.double())
    zero = x.abs() < _FLT_MIN
    t = torch.where(x > 0, t, torch.full_like(t, float("nan")))
    t = torch.where(zero, torch.full_like(t, float("-inf")), t)
    return torch.where(x == float("inf"), x, t)


def ste_round(v: torch.Tensor) -> torch.Tensor:
    """round() in the forward pass, identity in the backward pass."""
    return v + (torch.round(v) - v).detach()


def quantize_unit(x: torch.Tensor, b: float, n: int) -> torch.Tensor:
    """Paper eq. (1): uniform quantization in the standardized [b, 1] range."""
    clipped = torch.minimum(torch.maximum(x, _const(b, x)), _const(1.0, x))
    return torch.div(ste_round(clipped * n), _const(n, x))


def _grad_scale(v: torch.Tensor, g: float) -> torch.Tensor:
    """v in the forward pass; gradient scaled by g in the backward pass."""
    return v * g + (v * (1.0 - g)).detach()


def learned_quantize(x: torch.Tensor, s: torch.Tensor, *,
                     bits: Optional[int], b: float,
                     stabilize: bool = True) -> torch.Tensor:
    """Paper eq. (2): Q(x) = e^s * quantize(x / e^s). bits=None -> identity.

    ``stabilize`` scales the gradient of ``s`` by 1/sqrt(numel * n) (LSQ,
    Esser et al. 2020), as the reference does; forward values are the same.
    """
    if bits is None or bits >= 32:
        return x
    n = n_levels(bits)
    if stabilize:
        s = _grad_scale(s, 1.0 / math.sqrt(max(x.numel(), 1) * n))
    scale = exp(s).to(x.dtype)
    return scale * quantize_unit(torch.div(x, scale), b, n)


def lsb(s: torch.Tensor, bits: int) -> torch.Tensor:
    """One quantization interval in real units, e^s / n (the noise unit)."""
    e = exp(s)
    return torch.div(e, _const(n_levels(bits), e))


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, *, bits: int, b: float,
                    dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Integer codes round(clip(x/e^s, b, 1) * n); real value = e^s / n * code."""
    n = n_levels(bits)
    scale = exp(torch.as_tensor(s, device=x.device)).to(x.dtype)
    return torch.round(torch.clamp(torch.div(x, scale), b, 1.0)
                       * n).to(dtype)


def dequantize_int(codes: torch.Tensor, s: torch.Tensor, *,
                   bits: int) -> torch.Tensor:
    """Inverse of :func:`quantize_to_int`: e^s * code / n."""
    v = exp(torch.as_tensor(s, device=codes.device)) * codes.to(torch.float32)
    return torch.div(v, torch.full_like(v, n_levels(bits)))


# ---------------------------------------------------------------------------
# Packed weight storage (ternary / int4 formats)
# ---------------------------------------------------------------------------
#
# Weight codes live in [-n, n] with n = n_levels(bits_w); the paper's
# headline nets are ternary (bits_w = 2, n = 1). Storage:
#
#   format    bits/code  codes/byte  stored range   quantizer range
#   "int8"        8          1        [-128, 127]      [-127, 127]
#   "int4"        4          2        [-8, 7]          [-7, 7]
#   "ternary"     2          4        [-2, 1]          [-1, 1]
#
# Byte r of a packed (ceil(K/factor), N) uint8 array holds rows
# r*factor + i in bit field i, little-endian in the byte, each field a
# two's-complement value; rows are padded with code 0 to a factor
# multiple, and zero fields decode to code 0. The arithmetic is int32 on
# torch tensors, so the bytes equal the reference's for every code.

WEIGHT_FORMATS = ("int8", "int4", "ternary")

_FORMAT_BITS = {"int8": 8, "int4": 4, "ternary": 2}


def _check_format(fmt: str) -> None:
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(
            f"unknown weight_format {fmt!r}; expected one of {WEIGHT_FORMATS}")


def format_factor(fmt: str) -> int:
    """Codes stored per byte."""
    _check_format(fmt)
    return 8 // _FORMAT_BITS[fmt]


def format_range(fmt: str) -> int:
    """Largest symmetric quantizer level +-n the format can represent."""
    _check_format(fmt)
    return 2 ** (_FORMAT_BITS[fmt] - 1) - 1


def format_interval(fmt: str):
    """(lo, hi) of every value a sign-extended field can decode to (one
    level below -format_range: two's complement)."""
    _check_format(fmt)
    b = _FORMAT_BITS[fmt]
    return (-(2 ** (b - 1)), 2 ** (b - 1) - 1)


def auto_weight_format(n_w: int) -> str:
    """Densest format whose quantizer range covers codes in [-n_w, n_w]."""
    if n_w <= 1:
        return "ternary"
    if n_w <= 7:
        return "int4"
    return "int8"


def pack_codes(codes: torch.Tensor, fmt: str) -> torch.Tensor:
    """Pack (K, N) integer weight codes into (ceil(K/factor), N) uint8.

    Codes outside +-format_range(fmt) raise ValueError: packing never clips
    a trained code. Under a trace (``device.tracing``) the values are not
    read back, as the reference skips the check for traced codes.
    ``fmt == "int8"`` is the identity format (int8 out).
    """
    _check_format(fmt)
    if codes.dim() != 2:
        raise ValueError(f"pack_codes expects (K, N) codes, got "
                         f"{tuple(codes.shape)}")
    r = format_range(fmt)
    if codes.numel() and not tracing():
        lo, hi = int(codes.min()), int(codes.max())
        if lo < -r or hi > r:
            raise ValueError(
                f"codes out of range for weight_format={fmt!r}: "
                f"[{lo}, {hi}] vs allowed [-{r}, {r}]")
    if fmt == "int8":
        return codes.to(torch.int8)
    bits, factor = _FORMAT_BITS[fmt], format_factor(fmt)
    rows, n = codes.shape
    c = codes.to(torch.int32)
    pad = -rows % factor
    if pad:
        c = torch.cat([c, c.new_zeros((pad, n))])
    grouped = c.reshape(-1, factor, n)
    mask = (1 << bits) - 1
    packed = torch.zeros_like(grouped[:, 0])
    for i in range(factor):
        packed = packed | ((grouped[:, i] & mask) << (i * bits))
    return packed.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, fmt: str,
                 rows: Optional[int] = None) -> torch.Tensor:
    """Invert :func:`pack_codes`: (Kp, N) uint8 -> (Kp*factor, N) int8.

    ``rows`` trims trailing pad rows. Shift, mask, then xor-subtract sign
    extension: the expression the kernels' packed prologue evaluates.
    """
    _check_format(fmt)
    if fmt == "int8":
        out = packed.to(torch.int8)
        return out if rows is None else out[:rows]
    bits, factor = _FORMAT_BITS[fmt], format_factor(fmt)
    mask, sign = (1 << bits) - 1, 1 << (bits - 1)
    p = packed.to(torch.int32)
    fields = [(((p >> (i * bits)) & mask) ^ sign) - sign
              for i in range(factor)]
    out = torch.stack(fields, dim=1).reshape(p.shape[0] * factor, p.shape[1])
    out = out.to(torch.int8)
    return out if rows is None else out[:rows]


def pack_im2col_codes(w_codes: torch.Tensor, taps: int,
                      fmt: str) -> torch.Tensor:
    """Pack (taps*cin, N) tap-major im2col weight codes, cin padded with
    zero codes per tap up to the pack factor (cin_p), so every tap owns
    whole byte rows: (taps*cin_p/factor, N) uint8."""
    _check_format(fmt)
    if fmt == "int8":
        return pack_codes(w_codes, fmt)
    k, n = w_codes.shape
    if k % taps:
        raise ValueError(f"rows {k} not divisible by taps {taps}")
    cin = k // taps
    pad = -cin % format_factor(fmt)
    w = w_codes
    if pad:
        w = w.reshape(taps, cin, n)
        w = torch.cat([w, w.new_zeros((taps, pad, n))], dim=1)
        w = w.reshape(taps * (cin + pad), n)
    return pack_codes(w, fmt)


def unpack_im2col_codes(packed: torch.Tensor, taps: int, cin: int,
                        fmt: str) -> torch.Tensor:
    """Invert :func:`pack_im2col_codes`, dropping the per-tap pad lanes:
    back to (taps*cin, N) int8 im2col weights, the parity oracle's
    layout."""
    _check_format(fmt)
    if fmt == "int8":
        return unpack_codes(packed, fmt)
    w = unpack_codes(packed, fmt)
    cin_p = w.shape[0] // taps
    if cin_p != cin:
        w = w.reshape(taps, cin_p, -1)[:, :cin, :].reshape(taps * cin, -1)
    return w


def _percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(a, percentile)`` (linear) of a flat float32 tensor,
    in the reference's float32 steps: q = p / 100 * (n - 1), the values at
    floor(q) and ceil(q) weighted 1 - (q - floor q) and q - floor q.
    ``torch.quantile`` lerps in another order and refuses more than 2^24
    elements; ``kthvalue`` has no such limit."""
    f32 = dict(dtype=torch.float32, device=a.device)
    n = a.numel()
    q = torch.div(torch.tensor(percentile, **f32), torch.tensor(100.0, **f32))
    q = q * (torch.tensor(float(n), **f32) - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1 - w_hi
    top = torch.tensor(float(n), **f32) - 1
    lo, hi = (int(torch.clamp(v, torch.zeros_like(top), top)) for v in (lo, hi))
    v_lo = torch.kthvalue(a, lo + 1).values
    v_hi = torch.kthvalue(a, hi + 1).values
    return v_lo * w_lo + v_hi * w_hi


def init_scale(x: torch.Tensor, *, percentile: float = 100.0) -> torch.Tensor:
    """Log-scale s with e^s covering max|x| (or a percentile of |x|)."""
    a = torch.abs(x.detach().to(torch.float32))
    m = torch.max(a) if percentile >= 100.0 else \
        _percentile(a.flatten(), percentile)
    return host_log(torch.clamp(m, min=1e-8))


def host_log(v: torch.Tensor) -> torch.Tensor:
    """float32 log of a scalar, taken on the host and placed back on v's
    device: a log-scale set at initialisation, BN folding or calibration
    then has the same bits on every device."""
    return torch.log(v.detach().to("cpu", torch.float32)).to(v.device)


# The paper's ladders (Tables 1, 3, 4, 6), selectable by name: the
# reference's dict, entry for entry.
LADDERS = {
    # Table 1 — ResNet-20 / CIFAR-10: FP0 -> Q88 -> ... -> Q22
    "cifar10": [
        QuantConfig(),
        QuantConfig(8, 8),
        QuantConfig(6, 6),
        QuantConfig(5, 5),
        QuantConfig(4, 4),
        QuantConfig(3, 3),
        QuantConfig(2, 2),
    ],
    # Table 4 — KWS: FP -> Q66 -> Q45 -> Q35 -> Q24 -> FQ24
    "kws": [
        QuantConfig(),
        QuantConfig(6, 6),
        QuantConfig(4, 5),
        QuantConfig(3, 5),
        QuantConfig(2, 4),
        QuantConfig(2, 4, 4, fq=True),
    ],
    # Table 6 — ResNet-32 / CIFAR-100: FP0 -> Q88 -> Q66 -> ... -> Q25 -> FQ25
    "cifar100": [
        QuantConfig(),
        QuantConfig(8, 8),
        QuantConfig(6, 6),
        QuantConfig(5, 5),
        QuantConfig(4, 5),
        QuantConfig(3, 5),
        QuantConfig(2, 5),
        QuantConfig(2, 5, 5, fq=True),
    ],
    # Table 3 — DarkNet-19 / ImageNet
    "imagenet": [
        QuantConfig(),
        QuantConfig(8, 8),
        QuantConfig(7, 7),
        QuantConfig(6, 6),
        QuantConfig(5, 5),
        QuantConfig(4, 5),
        QuantConfig(3, 5),
        QuantConfig(2, 5),
    ],
}
