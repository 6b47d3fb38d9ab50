"""K1: learned quantization to int8 codes (paper eq. 1 + 2).

Counterpart of ``repro.kernels.quantize.quantize_codes`` (Pallas). For a
CUDA tensor the wrapper launches ``csrc/quantize.cu``; for a CPU tensor it
runs the plain version, :func:`quantize_codes_plain`. The TPU kernel's row
tile (``block_rows``, a VMEM block) has no counterpart: each CUDA thread
takes 8 elements as two 16-byte loads and one 8-byte store, on a grid of
at most ``BLOCKS_PER_SM`` blocks per SM, and any pointer offset or length
goes through the same kernel (one more block takes the unaligned head and
the tail).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ref_quantize_codes as quantize_codes_plain

BLOCKS_PER_SM = 8   # 256-thread blocks: a full SM's 2,048 threads
THREADS, PER_THREAD = 256, 8   # a block's threads; elements a thread step
_SIG = {"fq_quantize_codes": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p],
        "fq_launch_floor": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


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
            x.numel(), float(b), int(n),
            BLOCKS_PER_SM * _build.sm_count(x.device),
            ctypes.c_void_p(stream))
    _build.check(err, "quantize_codes", lib)
    quantize_codes.launches += 1
    return out


quantize_codes.launches = 0


def launch_floor(device: torch.device, blocks: int = 1,
                 threads: int = 32) -> None:
    """Launch one empty kernel of ``blocks`` x ``threads`` on ``device``'s
    current stream: the floor that K1's device times are read against."""
    lib = _build.library("quantize", _SIG)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fq_launch_floor(int(blocks), int(threads),
                                  ctypes.c_void_p(stream))
    _build.check(err, "launch_floor", lib)
