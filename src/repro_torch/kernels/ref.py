"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

Each function repeats its kernel's arithmetic with ordinary tensor ops. The
kernel wrappers use them for CPU tensors, and the tests and ``chip_smoke.py``
hold the CUDA kernels against them on the card. They are no yardstick of
speed.

Packed weights (``weight_format`` "int4" or "ternary") are unpacked to the
int8 layout first; the int8 arithmetic then runs unchanged.

ADC noise (``noise_sigma_acc``, ``noise_seed``, ``mac_chunks``; K4 on the
card): ``core.noise.mac_noise_field`` at each output's global index
``row * n_true + col`` is added to f32(acc), before the pool and the
epilogue, which then run on the noisy float32 value.

Integer products run in float64 and are cast back to int32: CUDA has no
int32 ``torch.matmul``, and the float64 sum is exact in any order because
|acc| <= 127 * 127 * K < 2^53 for every K this package meets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.noise import mac_noise_field, output_index
from ..core.quant import unpack_codes, unpack_im2col_codes


def apply_epilogue(acc: torch.Tensor, scale: torch.Tensor, *, epilogue: str,
                   n_out: int, lo: int) -> torch.Tensor:
    """The requant/dequant "ADC" epilogue on an int32 accumulator, or on a
    float32 one (the noisy accumulator).

    requant: clip(round(f32(acc) * scale), lo, n_out) -> int8, round half to
    even; dequant: f32(acc) * scale -> f32.
    """
    accf = acc.to(torch.float32) * scale
    if epilogue == "requant":
        return torch.clamp(torch.round(accf), lo, n_out).to(torch.int8)
    if epilogue == "dequant":
        return accf
    raise ValueError(f"epilogue must be 'requant' or 'dequant', got "
                     f"{epilogue!r}")


def int_accumulate(a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) integer codes -> exact int32 accumulator."""
    acc = torch.matmul(a_codes.to(torch.float64), b_codes.to(torch.float64))
    return acc.to(torch.int32)


def add_mac_noise(acc: torch.Tensor, noise_sigma_acc, noise_seed,
                  mac_chunks: int) -> torch.Tensor:
    """f32(acc) + the ADC-noise field of an (M, N) accumulator, at the
    global index ``row * N + col``; the int32 acc itself without noise."""
    if noise_sigma_acc is None:
        return acc
    if noise_seed is None:
        raise ValueError("noise_seed is required with noise_sigma_acc")
    m, n = acc.shape
    return acc.to(torch.float32) + mac_noise_field(
        output_index(m, n, acc.device), noise_seed, noise_sigma_acc,
        chunks=mac_chunks)


def ref_fq_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor,
                  scale: torch.Tensor, *, epilogue: str = "requant",
                  n_out: int = 7, lo: int = 0,
                  weight_format: str = "int8", noise_sigma_acc=None,
                  noise_seed=None, mac_chunks: int = 1) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32, the ADC noise when
    ``noise_sigma_acc`` is given, then the fused epilogue.

    Packed B is (ceil(K/factor), N) uint8 (``core.quant.pack_codes``); its
    pad rows past K are dropped.
    """
    if weight_format != "int8":
        b_codes = unpack_codes(b_codes, weight_format,
                               rows=a_codes.shape[1])
    acc = add_mac_noise(int_accumulate(a_codes, b_codes), noise_sigma_acc,
                        noise_seed, mac_chunks)
    return apply_epilogue(acc, scale, epilogue=epilogue, n_out=n_out, lo=lo)


def ref_quantize_codes(x: torch.Tensor, inv_scale: torch.Tensor, *, n: int,
                       b: float) -> torch.Tensor:
    """codes = round(clip(x * inv_scale, b, 1) * n) -> int8."""
    u = x.to(torch.float32) * inv_scale
    return torch.round(torch.clamp(u, b, 1.0) * n).to(torch.int8)


def ref_fq_conv2d(a_codes: torch.Tensor, w_codes: torch.Tensor,
                  scale: torch.Tensor, *, kh: int, kw: int,
                  stride: Tuple[int, int] = (1, 1),
                  padding: Tuple[int, int] = (0, 0),
                  dilation: Tuple[int, int] = (1, 1),
                  pool: Optional[Tuple[int, int]] = None,
                  epilogue: str = "requant", n_out: int = 7,
                  lo: int = 0, weight_format: str = "int8",
                  noise_sigma_acc=None, noise_seed=None,
                  mac_chunks: int = 1) -> torch.Tensor:
    """NHWC int8 conv as a sum over taps of window @ tap weights.

    a_codes (B, H, W, Cin); w_codes (kh*kw*Cin, Cout), tap-major (row
    t*Cin + c is tap (t // kw, t % kw), channel c); zero padding. Packed
    weights are (kh*kw*cin_p/factor, Cout) uint8, cin padded per tap to
    cin_p (``core.quant.pack_im2col_codes``).

    ``pool=(ph, pw)`` takes the max of the int32 accumulator over
    non-overlapping (ph, pw) windows, floor mode (rows and columns past
    (Ho // ph) * ph and (Wo // pw) * pw are dropped), before the epilogue:
    the order of the fused max-pool epilogue. With ADC noise, each conv
    output (b, h, w, c) takes the field at its unpooled index
    ((b * Ho + h) * Wo + w) * Cout + c, and the max runs on the noisy
    float32 accumulator.
    """
    b, h, w, cin = a_codes.shape
    if weight_format != "int8":
        w_codes = unpack_im2col_codes(w_codes, kh * kw, cin, weight_format)
    cout = w_codes.shape[1]
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    x = F.pad(a_codes.to(torch.float64), (0, 0, pw, pw, ph, ph))
    ho = (h + 2 * ph - (kh - 1) * dh - 1) // sh + 1
    wo = (w + 2 * pw - (kw - 1) * dw - 1) // sw + 1
    wf = w_codes.to(torch.float64)
    acc = torch.zeros(b * ho * wo, cout, dtype=torch.float64,
                      device=a_codes.device)
    for th in range(kh):
        for tw in range(kw):
            t = th * kw + tw
            win = x[:, th * dh: th * dh + (ho - 1) * sh + 1: sh,
                    tw * dw: tw * dw + (wo - 1) * sw + 1: sw, :]
            acc += win.reshape(-1, cin) @ wf[t * cin:(t + 1) * cin]
    acc = add_mac_noise(acc.to(torch.int32), noise_sigma_acc, noise_seed,
                        mac_chunks).reshape(b, ho, wo, cout)
    if pool is not None:
        qh, qw = pool
        hp, wp = ho // qh, wo // qw
        acc = acc[:, :hp * qh, :wp * qw].reshape(b, hp, qh, wp, qw, cout)
        acc = acc.amax(dim=(2, 4))
    return apply_epilogue(acc, scale, epilogue=epilogue, n_out=n_out, lo=lo)


def ref_splitk_partials(a_codes: torch.Tensor, w_codes: torch.Tensor, *,
                        kh: int, kw: int, bc: int,
                        stride: Tuple[int, int] = (1, 1),
                        padding: Tuple[int, int] = (0, 0),
                        dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """K3's split-K partial sums: (cin // bc, B*Ho*Wo, Cout) int32, split z
    the sum over the codes [z kspan, (z + 1) kspan) of the tap-major
    reduction (row t*Cin + c of the int8 weights), kspan = kh*kw*bc."""
    b, h, w, cin = a_codes.shape
    if cin % bc:
        raise ValueError(f"bc={bc} must divide cin={cin}")
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    x = F.pad(a_codes.to(torch.float64), (0, 0, pw, pw, ph, ph))
    ho = (h + 2 * ph - (kh - 1) * dh - 1) // sh + 1
    wo = (w + 2 * pw - (kw - 1) * dw - 1) // sw + 1
    patches = torch.cat([
        x[:, th * dh: th * dh + (ho - 1) * sh + 1: sh,
          tw * dw: tw * dw + (wo - 1) * sw + 1: sw, :]
        for th in range(kh) for tw in range(kw)], -1).reshape(b * ho * wo, -1)
    wf = w_codes.to(torch.float64)
    kspan = kh * kw * bc
    return torch.stack([
        patches[:, z * kspan:(z + 1) * kspan] @ wf[z * kspan:(z + 1) * kspan]
        for z in range(cin // bc)]).to(torch.int32)


def ref_splitk_epilogue(partials: torch.Tensor, scale: torch.Tensor, *,
                        epilogue: str = "requant", n_out: int = 7,
                        lo: int = 0, noise_sigma_acc=None, noise_seed=None,
                        mac_chunks: int = 1) -> torch.Tensor:
    """The split-K epilogue pass: (split, M, N) int32 partials -> their
    int32 sum, the ADC noise at the global index ``row * N + col`` when
    ``noise_sigma_acc`` is given, then the fused epilogue; (M, N)."""
    acc = partials.sum(dim=0, dtype=torch.int32)
    acc = add_mac_noise(acc, noise_sigma_acc, noise_seed, mac_chunks)
    return apply_epilogue(acc, scale, epilogue=epilogue, n_out=n_out, lo=lo)
