"""K1: learned quantization to int8 codes (paper eq. 1 + 2).

Counterpart of ``repro.kernels.quantize.quantize_codes`` (Pallas). For a
CUDA tensor the wrapper launches ``csrc/quantize.cu``; for a CPU tensor it
runs the plain version, :func:`quantize_codes_plain`. The TPU kernel's row
tiling has no counterpart: the CUDA kernel streams elements.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ref_quantize_codes as quantize_codes_plain

_SIG = {"fq_quantize_codes": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def quantize_codes(x: torch.Tensor, inv_scale: torch.Tensor, *, n: int,
                   b: float) -> torch.Tensor:
    """codes = round(clip(x * inv_scale, b, 1) * n) -> int8, elementwise.

    ``inv_scale`` = e^{-s} is a one-element float32 tensor on x's device;
    the kernel reads it from device memory, so no host sync is needed.
    """
    if x.device.type == "cpu":
        return quantize_codes_plain(x, inv_scale, n=n, b=b)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_codes: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("quantize_codes: x must be contiguous float32, got "
                         f"{x.dtype} contiguous={x.is_contiguous()}")
    if (inv_scale.device != x.device or inv_scale.dtype != torch.float32
            or inv_scale.numel() != 1):
        raise ValueError("quantize_codes: inv_scale must be one float32 "
                         f"element on {x.device}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _build.library("quantize", _SIG)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fq_quantize_codes(
            _build.ptr(x), _build.ptr(inv_scale), _build.ptr(out),
            x.numel(), float(b), int(n), ctypes.c_void_p(stream))
    _build.check(err, "quantize_codes", lib)
    quantize_codes.launches += 1
    return out


quantize_codes.launches = 0
