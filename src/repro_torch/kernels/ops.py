"""Integer ops behind one dispatch point (counterpart of ``repro.kernels.ops``).

  * rescale/alpha folding (paper eq. 4's scalar factor),
  * ``int_matmul`` / ``quantize_to_codes`` over the K2 / K1 kernels,
  * FQ conv1d/conv2d with two implementations: ``"fused"`` is the implicit
    GEMM kernel K3, ``"im2col"`` builds patches and runs K2 (the parity
    oracle, as in the reference). Unset means fused on CUDA and im2col on
    the CPU.
  * conv2d + max-pool: ``"fused"`` is K3b (the pool on the int32
    accumulator in the conv's epilogue), ``"im2col"`` is K2 followed by
    :func:`maxpool2d` on the codes.
  * packed weights (``weight_format`` "int4" or "ternary"): the fused
    kernels read the packed bytes (K5, their packed prologue); im2col
    unpacks them to the int8 layout first and stays the parity oracle for
    every format, as in the reference.
  * ADC noise (``noise_sigma_acc``, ``noise_seed``, ``mac_chunks``; K4)
    on every impl: the field is indexed by global output elements, so
    the im2col oracle (K2's noisy epilogue over the patch matrix, N =
    Cout, then the code pool) and the fused kernels stay bit-identical.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.quant import exp, n_levels, unpack_im2col_codes
from .fq_conv import check_weights, conv_out_size, fq_conv1d, fq_conv2d
from .fq_matmul import fq_matmul
from .quantize import quantize_codes


def oracle_weights(what: str, w_codes, taps: int, cin: int,
                   weight_format: str):
    """The im2col oracle's int8 (taps*cin, Cout) weights: checked as the
    fused kernels check them, and unpacked when packed."""
    if check_weights(what, w_codes, taps, cin, weight_format) == 1:
        return w_codes
    return unpack_im2col_codes(w_codes, taps, cin, weight_format)


def conv_impl(explicit: Optional[str] = None,
              device: Optional[torch.device] = None) -> str:
    """"fused" or "im2col"; unset picks fused on CUDA, im2col elsewhere."""
    if explicit not in (None, "fused", "im2col"):
        raise ValueError(f"impl must be 'fused', 'im2col' or unset, got "
                         f"{explicit!r}")
    if explicit is not None:
        return explicit
    return "fused" if device is not None and device.type == "cuda" else "im2col"


# The folds are the reference's expressions in its order of operations,
# e^s by ``core.quant.exp`` (XLA's) and every division tensor by tensor
# (CUDA turns ``t / <python number>`` into a reciprocal multiply), so the
# folded scalars are the reference's bit for bit on any device. Constants
# are filled on the device (``full_like``): no host copy, so the integer
# path stays capturable in a CUDA graph.


def fold_rescale(s_a, s_w, s_out, *, bits_a: int, bits_w: int, bits_out: int):
    """rescale = e^(s_a + s_w - s_out) * n_out / (n_a * n_w), one scalar."""
    n_a, n_w, n_o = (n_levels(b) for b in (bits_a, bits_w, bits_out))
    e = exp(s_a + s_w - s_out)
    return e * torch.full_like(e, n_o / (n_a * n_w))


def fold_alpha(s_a, s_w, *, bits_a: int, bits_w: int):
    """alpha = e^(s_a + s_w) / (n_a n_w): int32 accumulator -> real value."""
    n_a, n_w = n_levels(bits_a), n_levels(bits_w)
    e = exp(s_a + s_w)
    return torch.div(e, torch.full_like(e, n_a * n_w))


def int_matmul(a_codes, b_codes, scale, *, epilogue="requant", n_out=7, lo=0,
               noise_sigma_acc=None, noise_seed=None, mac_chunks=1,
               weight_format="int8"):
    """K2; packed B ((ceil(K/factor), N) uint8) goes to the kernel as is."""
    return fq_matmul(a_codes, b_codes, scale, epilogue=epilogue, n_out=n_out,
                     lo=lo, weight_format=weight_format,
                     noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                     mac_chunks=mac_chunks)


def quantize_to_codes(x, s, *, bits: int, b: float, inv_scale=None):
    """Float activations -> int8 codes through K1.

    ``inv_scale`` is e^{-s} when the caller carries it (a converted stack
    does); otherwise it is computed here with ``core.quant.exp``.
    """
    if inv_scale is None:
        inv_scale = exp(-s)
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    codes = quantize_codes(flat, inv_scale, n=n_levels(bits), b=b)
    return codes.reshape(x.shape)


def _im2col_1d(x, ksize: int, dilation: int):
    """(B, T, C) -> (B, T_out, ksize*C); valid padding (paper's KWS net)."""
    t_out = x.shape[1] - dilation * (ksize - 1)
    cols = [x[:, i * dilation: i * dilation + t_out, :] for i in range(ksize)]
    return torch.cat(cols, dim=-1), t_out


def _im2col_2d(x, ksize: int, stride: int, padding: int, dilation: int = 1):
    """(B, H, W, C) -> (B, Ho, Wo, ksize*ksize*C), tap-major, zero padding."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    h, w = x.shape[1], x.shape[2]
    ho = conv_out_size(h, ksize, stride, 0, dilation)
    wo = conv_out_size(w, ksize, stride, 0, dilation)
    cols = []
    for di in range(ksize):
        for dj in range(ksize):
            oi, oj = di * dilation, dj * dilation
            cols.append(x[:, oi: oi + (ho - 1) * stride + 1: stride,
                          oj: oj + (wo - 1) * stride + 1: stride, :])
    return torch.cat(cols, dim=-1), ho, wo


def fq_conv1d_int(a_codes, w_codes, scale, *, ksize: int, dilation: int = 1,
                  epilogue="requant", n_out=7, lo=0, impl=None,
                  noise_sigma_acc=None, noise_seed=None, mac_chunks=1,
                  weight_format="int8"):
    """int8 1-D convolution (B, T, Cin) -> (B, T_out, Cout), VALID, dilated.

    w_codes: (ksize*Cin, Cout) int8, tap-major, or the ``weight_format``
    packed uint8 layout (``core.quant.pack_im2col_codes``).
    """
    noise = dict(noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                 mac_chunks=mac_chunks)
    if conv_impl(impl, a_codes.device) == "fused":
        return fq_conv1d(a_codes, w_codes, scale, ksize=ksize,
                         dilation=dilation, epilogue=epilogue, n_out=n_out,
                         lo=lo, weight_format=weight_format, **noise)
    w_codes = oracle_weights("fq_conv1d_int", w_codes, ksize,
                             a_codes.shape[-1], weight_format)
    b = a_codes.shape[0]
    patches, t_out = _im2col_1d(a_codes, ksize, dilation)
    y = fq_matmul(patches.reshape(b * t_out, -1), w_codes, scale,
                  epilogue=epilogue, n_out=n_out, lo=lo, **noise)
    return y.reshape(b, t_out, -1)


def fq_conv2d_int(a_codes, w_codes, scale, *, ksize: int, stride: int = 1,
                  padding: int = 0, dilation: int = 1, epilogue="requant",
                  n_out=7, lo=0, impl=None, noise_sigma_acc=None,
                  noise_seed=None, mac_chunks=1, weight_format="int8"):
    """int8 2-D convolution (NHWC); w_codes (ksize*ksize*Cin, Cout) int8, or
    the ``weight_format`` packed uint8 layout, which im2col unpacks first."""
    noise = dict(noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                 mac_chunks=mac_chunks)
    if conv_impl(impl, a_codes.device) == "fused":
        return fq_conv2d(a_codes, w_codes, scale, kh=ksize, kw=ksize,
                         stride=(stride, stride), padding=(padding, padding),
                         dilation=(dilation, dilation), epilogue=epilogue,
                         n_out=n_out, lo=lo, weight_format=weight_format,
                         **noise)
    w_codes = oracle_weights("fq_conv2d_int", w_codes, ksize * ksize,
                             a_codes.shape[-1], weight_format)
    b = a_codes.shape[0]
    patches, ho, wo = _im2col_2d(a_codes, ksize, stride, padding, dilation)
    y = fq_matmul(patches.reshape(b * ho * wo, -1), w_codes, scale,
                  epilogue=epilogue, n_out=n_out, lo=lo, **noise)
    return y.reshape(b, ho, wo, -1)


def maxpool2d(y, *, window: int = 2, stride: int = 2):
    """VALID max-pool, floor mode, on int8 codes or f32 activations (NHWC).

    On codes this is exact because the learned quantizer is monotone: max
    commutes with requantization. Plain PyTorch: the reference computes it
    with ``reduce_window``, outside any Pallas kernel. Floats take
    ``F.max_pool2d``, whose gradient goes to the first maximum of each
    window, as ``reduce_window``'s does (decoded codes tie often; ``amax``
    would split the gradient between ties). Codes take a strided window
    view and ``amax``: ``F.max_pool2d`` has no int8 CUDA kernel, and codes
    carry no gradient.
    """
    if y.is_floating_point():
        return F.max_pool2d(y.movedim(-1, 1), window, stride).movedim(
            1, -1).contiguous()
    win = y.unfold(1, window, stride).unfold(2, window, stride)
    return win.amax(dim=(-2, -1)).contiguous()


def fq_conv2d_pool_int(a_codes, w_codes, scale, *, ksize: int,
                       stride: int = 1, padding: int = 0, dilation: int = 1,
                       pool: int = 2, epilogue="requant", n_out=7, lo=0,
                       impl=None, noise_sigma_acc=None, noise_seed=None,
                       mac_chunks=1, weight_format="int8"):
    """int8 conv2d + non-overlapping (pool, pool) max-pool.

    "fused" pools the int32 accumulator in the conv kernel's epilogue
    (K3b), so only the pooled codes reach device memory; "im2col" runs the
    unfused conv and :func:`maxpool2d` on its output, the parity oracle
    (bit-exact because the epilogue is monotone for scale > 0). With ADC
    noise, both perturb the pre-pool accumulator, so they stay identical.
    """
    noise = dict(noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                 mac_chunks=mac_chunks)
    if conv_impl(impl, a_codes.device) == "fused":
        return fq_conv2d(a_codes, w_codes, scale, kh=ksize, kw=ksize,
                         stride=(stride, stride), padding=(padding, padding),
                         dilation=(dilation, dilation), pool=(pool, pool),
                         epilogue=epilogue, n_out=n_out, lo=lo,
                         weight_format=weight_format, **noise)
    y = fq_conv2d_int(a_codes, w_codes, scale, ksize=ksize, stride=stride,
                      padding=padding, dilation=dilation, epilogue=epilogue,
                      n_out=n_out, lo=lo, impl="im2col",
                      weight_format=weight_format, **noise)
    return maxpool2d(y, window=pool, stride=pool)
