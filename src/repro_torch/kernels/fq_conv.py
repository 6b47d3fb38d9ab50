"""K3: fused fully quantized convolution (implicit GEMM), NHWC int8, and
K3b: the same conv with the fused max-pool epilogue.

Counterpart of ``repro.kernels.fq_conv`` (Pallas). Layout contract, as in
the reference and the im2col path:

  * activations  (B, H, W, Cin) int8 codes, NHWC,
  * weights      (kh*kw*Cin, Cout) int8 codes, tap-major (row t*Cin + c is
                 tap (t // kw, t % kw), channel c); packed (``weight_format``
                 "int4" or "ternary", K5): (kh*kw*cin_p/factor, Cout) uint8,
                 cin padded per tap to cin_p, a multiple of the factor
                 (``core.quant.pack_im2col_codes``),
  * output       (B, Ho, Wo, Cout) int8 codes (requant) or f32 (dequant);
                 (B, Ho // ph, Wo // pw, Cout) with ``pool=(ph, pw)``.

For a CUDA tensor the wrapper launches ``csrc/fq_conv.cu``, which gathers
each window in place with zero padding by bounds check; for a CPU tensor it
runs the plain version, :func:`fq_conv2d_plain`. The reference's block
picker and autotune table have no counterpart yet: the CUDA kernel's tile
is fixed. K3 and K3b run on the tensor cores; their A operand takes the
loader :func:`a_loader` picks per launch, and ``vector_launches`` (on
:func:`fq_conv2d` and on :func:`fq_conv2d_pool`) counts the launches that
took the vector one. With packed weights the kernel reduces over taps x
cin_p and decodes the bytes in its tile loop; the activations are not
padded. ``launches`` counts every launch, ``packed_launches[fmt]`` the
packed ones.

ADC noise (K4), as in K2: the field at the conv output's global index
((b * Ho + h) * Wo + w) * Cout + c goes onto f32(acc) before the pool and
the epilogue; with ``pool=`` the max runs on the noisy float32
accumulator, each window position with the field of its unpooled index.
``noisy_launches`` counts those launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.quant import format_factor
from . import _build
from .fq_matmul import (VECTOR_BYTES, b_vector, check_noise, check_operands,
                        noise_pointers, packed_counts)
from .ref import ref_fq_conv2d as fq_conv2d_plain

_CONV_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
_SIG = {"fq_conv2d_s8": _CONV_ARGS + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "fq_conv2d_pool_s8": _CONV_ARGS + [ctypes.c_int] * 9
        + [ctypes.c_void_p]}


def conv_out_size(size: int, k: int, stride: int, padding: int,
                  dilation: int) -> int:
    return (size + 2 * padding - (k - 1) * dilation - 1) // stride + 1


def a_loader(cin: int, x_ptr: int) -> str:
    """The A loader of K3 and K3b (``pool=``): ``"vector"`` when a 16-byte
    chunk of a reduction row is one tap's channels of one pixel, at an
    aligned address (Cin % 16 == 0 and the activations 16-byte aligned),
    else ``"byte"``."""
    ok = cin % VECTOR_BYTES == 0 and x_ptr % VECTOR_BYTES == 0
    return "vector" if ok else "byte"


def check_weights(what: str, w_codes: torch.Tensor, taps: int, cin: int,
                  weight_format: str) -> int:
    """Check conv weights against their format's layout, (taps*cin, Cout)
    int8 or (taps*cin_p/factor, Cout) packed uint8; returns the factor."""
    factor = format_factor(weight_format)
    cin_p = -(-cin // factor) * factor
    if w_codes.shape[0] * factor != taps * cin_p:
        raise ValueError(f"{what}: weights {tuple(w_codes.shape)} do not "
                         f"match {taps} taps x cin={cin} ({weight_format}, "
                         f"cin_p={cin_p})")
    if factor > 1 and w_codes.dtype != torch.uint8:
        raise ValueError(f"{what}: {weight_format} weights are packed "
                         f"uint8, got {w_codes.dtype}")
    return factor


def fq_conv2d(a_codes: torch.Tensor, w_codes: torch.Tensor,
              scale: torch.Tensor, *, kh: int, kw: int,
              stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0),
              dilation: Tuple[int, int] = (1, 1),
              pool: Optional[Tuple[int, int]] = None,
              epilogue: str = "requant", n_out: int = 7,
              lo: int = 0, weight_format: str = "int8",
              noise_sigma_acc=None, noise_seed=None,
              mac_chunks: int = 1) -> torch.Tensor:
    """Fused int8 NHWC conv2d with the requant/dequant epilogue.

    ``pool=(ph, pw)`` fuses a non-overlapping max-pool, floor mode, on the
    int32 accumulator before the epilogue (K3b); its launches are counted
    on :func:`fq_conv2d_pool`. ``weight_format`` "int4" or "ternary" takes
    packed weights, (kh*kw*cin_p/factor, Cout) uint8. ``noise_sigma_acc``,
    ``noise_seed`` and ``mac_chunks`` turn on the ADC noise, as in
    :func:`.fq_matmul.fq_matmul`.
    """
    what = "fq_conv2d" if pool is None else "fq_conv2d_pool"
    noisy = check_noise(what, noise_sigma_acc, noise_seed, mac_chunks)
    b, h, w, cin = a_codes.shape
    cout = w_codes.shape[1]
    factor = check_weights("fq_conv2d", w_codes, kh * kw, cin, weight_format)
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    if ho <= 0 or wo <= 0:
        raise ValueError(f"fq_conv2d: empty output for input "
                         f"{tuple(a_codes.shape)}, kernel ({kh}, {kw}), "
                         f"stride {stride}, padding {padding}, dilation "
                         f"{dilation}")
    if pool is not None:
        if min(pool) < 1 or ho < pool[0] or wo < pool[1]:
            raise ValueError(f"fq_conv2d: pool {pool} does not fit the conv "
                             f"output ({ho}, {wo})")
    if a_codes.device.type == "cpu":
        return fq_conv2d_plain(a_codes, w_codes, scale, kh=kh, kw=kw,
                               stride=stride, padding=padding,
                               dilation=dilation, pool=pool,
                               epilogue=epilogue, n_out=n_out, lo=lo,
                               weight_format=weight_format,
                               noise_sigma_acc=noise_sigma_acc,
                               noise_seed=noise_seed, mac_chunks=mac_chunks)
    check_operands(what, scale, epilogue, a_codes, w_codes, weight_format)
    sigma, seed = (noise_pointers(what, a_codes.device, noise_sigma_acc,
                                  noise_seed) if noisy else (None, None))
    if a_codes.numel() >= 2 ** 31:
        raise ValueError(f"{what}: the CUDA kernel indexes activations "
                         "with 32-bit offsets (< 2^31 elements)")
    dequant = epilogue == "dequant"
    oh, ow = (ho, wo) if pool is None else (ho // pool[0], wo // pool[1])
    out = torch.empty((b, oh, ow, cout), device=a_codes.device,
                      dtype=torch.float32 if dequant else torch.int8)
    lib = _build.library("fq_conv", _SIG)
    shape = (b, h, w, cin, cout, kh, kw, *stride, *padding, *dilation, ho, wo)
    tail = (factor, int(dequant), int(lo), int(n_out), mac_chunks)
    vector = a_loader(cin, a_codes.data_ptr()) == "vector"
    bvec = b_vector(cout, w_codes.data_ptr())
    with torch.cuda.device(a_codes.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (_build.ptr(a_codes), _build.ptr(w_codes), _build.ptr(scale),
                _build.ptr(out), sigma, seed)
        if pool is None:
            err = lib.fq_conv2d_s8(*ptrs, *shape, *tail, int(vector),
                                   int(bvec), stream)
        else:
            err = lib.fq_conv2d_pool_s8(*ptrs, *shape, *pool, *tail,
                                        int(vector), int(bvec), stream)
    _build.check(err, what, lib)
    counted = fq_conv2d if pool is None else fq_conv2d_pool
    counted.launches += 1
    if factor > 1:
        counted.packed_launches[weight_format] += 1
    if noisy:
        counted.noisy_launches += 1
    if vector:
        counted.vector_launches += 1
    return out


fq_conv2d.launches = 0
fq_conv2d.packed_launches = packed_counts()
fq_conv2d.noisy_launches = 0
fq_conv2d.vector_launches = 0


def fq_conv2d_pool(a_codes: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor, *, kh: int, kw: int,
                   pool: Tuple[int, int], **opts) -> torch.Tensor:
    """K3b: :func:`fq_conv2d` with the fused max-pool epilogue."""
    return fq_conv2d(a_codes, w_codes, scale, kh=kh, kw=kw, pool=pool,
                     **opts)


fq_conv2d_pool.launches = 0
fq_conv2d_pool.packed_launches = packed_counts()
fq_conv2d_pool.noisy_launches = 0
fq_conv2d_pool.vector_launches = 0


def fq_conv1d(a_codes: torch.Tensor, w_codes: torch.Tensor,
              scale: torch.Tensor, *, ksize: int, dilation: int = 1,
              epilogue: str = "requant", n_out: int = 7,
              lo: int = 0, weight_format: str = "int8",
              noise_sigma_acc=None, noise_seed=None,
              mac_chunks: int = 1) -> torch.Tensor:
    """Fused int8 1-D conv (VALID, dilated: the paper's KWS layers).

    A (ksize, 1) conv2d over a width-1 axis: conv1d's tap-major weights are
    exactly the kw=1 conv2d layout, and the views below copy nothing. The
    output index (b * T_out + t) * Cout + c is the conv2d one at Wo = 1.
    """
    y = fq_conv2d(a_codes.unsqueeze(2), w_codes, scale, kh=ksize, kw=1,
                  dilation=(dilation, 1), epilogue=epilogue, n_out=n_out,
                  lo=lo, weight_format=weight_format,
                  noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                  mac_chunks=mac_chunks)
    return y.squeeze(2)
