"""Learned quantization (paper eq. 1 & 2): the integer-inference subset.

Counterpart of ``repro.core.quant``:

    quantize(x) = round(clip(x, b, 1) * n) / n              (1)
    Q(x)        = e^s * quantize(x / e^s)                   (2)

with ``b`` the clip lower bound (-1 for weights / linear outputs, 0 for
quantized ReLUs) and ``n = 2^(nb-1) - 1`` positive levels for ``nb`` bits.
``torch.round`` rounds half to even, like ``jnp.round``, so codes that sit
exactly on a half-LSB land on the same integer as in the reference.

Beside them, the packed weight formats (``int4``, ``ternary``): storage of
several weight codes per byte, the layout the kernels' packed prologue
(K5) reads. The training-side helpers (STE, learned_quantize) belong to a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, *, bits: int, b: float,
                    dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Integer codes round(clip(x/e^s, b, 1) * n); real value = e^s / n * code."""
    n = n_levels(bits)
    scale = torch.exp(torch.as_tensor(s, device=x.device)).to(x.dtype)
    return torch.round(torch.clamp(x / scale, b, 1.0) * n).to(dtype)


def dequantize_int(codes: torch.Tensor, s: torch.Tensor, *,
                   bits: int) -> torch.Tensor:
    """Inverse of :func:`quantize_to_int`: e^s * code / n."""
    n = n_levels(bits)
    s = torch.as_tensor(s, device=codes.device)
    return torch.exp(s) * codes.to(torch.float32) / n


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
    a trained code. ``fmt == "int8"`` is the identity format (int8 out).
    """
    _check_format(fmt)
    if codes.dim() != 2:
        raise ValueError(f"pack_codes expects (K, N) codes, got "
                         f"{tuple(codes.shape)}")
    r = format_range(fmt)
    if codes.numel():
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


def init_scale(x: torch.Tensor) -> torch.Tensor:
    """Log-scale s with e^s covering max|x|.

    The reference's ``percentile`` option is not on the serving path and
    is not ported yet.
    """
    m = torch.max(torch.abs(x.to(torch.float32)))
    return torch.log(torch.clamp(m, min=1e-8))
