"""K2: fully quantized integer matmul (paper eq. 4).

    w . a = (s^w s^a / n^w n^a) * sum_i w_i^int a_i^int

Counterpart of ``repro.kernels.fq_matmul`` (Pallas). (M, K) int8 codes x
(K, N) int8 codes -> int32 accumulator, then the fused epilogue
(:func:`apply_epilogue`): ``requant`` gives the next layer's int8 codes,
``dequant`` gives f32 values. For a CUDA tensor the wrapper launches
``csrc/fq_matmul.cu``; for a CPU tensor it runs the plain version,
:func:`fq_matmul_plain`.

Packed weights (``weight_format`` "int4" or "ternary", K5): B is
(ceil(K/factor), N) uint8 from ``core.quant.pack_codes`` and the kernel
decodes it in its tile loop. ``fq_matmul.launches`` counts every launch,
``fq_matmul.packed_launches[fmt]`` the packed ones.

ADC noise (K4): with ``noise_sigma_acc`` (sigma in accumulator units) and
``noise_seed``, the epilogue adds ``core.noise.mac_noise_field`` at the
global index ``row * N + col`` to f32(acc) and requantizes the float32
value; ``fq_matmul.noisy_launches`` counts those launches.

The kernel's tile loop runs on the tensor cores (``csrc/igemm_tc.cuh``).
Its A operand takes one of two loaders, which :func:`a_loader` picks per
launch from the shape and the address: ``"vector"`` (16-byte ``cp.async``)
or ``"byte"`` (a masked gather); ``fq_matmul.vector_launches`` counts the
launches that took the vector loader. A misaligned A (a view at an odd
offset) takes the byte loader: nothing is refused for its alignment.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.quant import WEIGHT_FORMATS, format_factor
from . import _build
from .ref import apply_epilogue, ref_fq_matmul as fq_matmul_plain

__all__ = ["apply_epilogue", "fq_matmul", "fq_matmul_plain"]

_SIG = {"fq_matmul_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
        + [ctypes.c_void_p]}
VECTOR_BYTES = 16   # one cp.async of the A loader


def a_loader(k: int, a_ptr: int) -> str:
    """K2's A loader: ``"vector"`` when every 16-byte chunk of a reduction
    row is one aligned load (K % 16 == 0 and A 16-byte aligned), else
    ``"byte"``."""
    ok = k % VECTOR_BYTES == 0 and a_ptr % VECTOR_BYTES == 0
    return "vector" if ok else "byte"


def b_vector(n: int, w_ptr: int) -> bool:
    """Whether the B loader copies 16-byte chunks of weight rows with
    ``cp.async``: N % 16 == 0 and the weights 16-byte aligned; else it
    loads masked bytes."""
    return n % VECTOR_BYTES == 0 and w_ptr % VECTOR_BYTES == 0


def packed_counts() -> dict:
    """A fresh per-format counter of packed launches."""
    return {f: 0 for f in WEIGHT_FORMATS if f != "int8"}


def check_operands(what: str, scale: torch.Tensor, epilogue: str,
                   a_codes: torch.Tensor, w: torch.Tensor,
                   weight_format: str = "int8") -> None:
    """Validate what the CUDA kernels take: contiguous int8 activation codes,
    contiguous weights in the format's dtype (int8, or uint8 when packed)
    and a one-element float32 scale, all on one CUDA device."""
    dev = a_codes.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    w_dtype = torch.int8 if weight_format == "int8" else torch.uint8
    for c, dtype in ((a_codes, torch.int8), (w, w_dtype)):
        if c.dtype != dtype or not c.is_contiguous() or c.device != dev:
            raise ValueError(f"{what}: operands must be contiguous {dtype} "
                             f"on {dev}, got {c.dtype} on {c.device}")
    if (scale.device != dev or scale.dtype != torch.float32
            or scale.numel() != 1):
        raise ValueError(f"{what}: scale must be one float32 element on {dev}")
    if epilogue not in ("requant", "dequant"):
        raise ValueError(f"{what}: epilogue must be 'requant' or 'dequant', "
                         f"got {epilogue!r}")


def check_noise(what: str, noise_sigma_acc, noise_seed,
                mac_chunks: int) -> bool:
    """True when the ADC noise is on; raises for a sigma without a seed
    (as the reference asserts) and for mac_chunks < 1."""
    if noise_sigma_acc is None:
        return False
    if noise_seed is None:
        raise ValueError(f"{what}: noise_seed is required with "
                         "noise_sigma_acc")
    if not isinstance(mac_chunks, int) or mac_chunks < 1:
        raise ValueError(f"{what}: mac_chunks must be an int >= 1, got "
                         f"{mac_chunks!r}")
    return True


def noise_pointers(what: str, dev: torch.device, noise_sigma_acc,
                   noise_seed):
    """The CUDA kernels' noise operands, checked: sigma one float32 and the
    seed one uint32 element on ``dev``, read by the kernel on the device."""
    for t, dtype, name in ((noise_sigma_acc, torch.float32, "sigma"),
                           (noise_seed, torch.uint32, "seed")):
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != dtype or t.numel() != 1):
            raise ValueError(f"{what}: noise {name} must be one {dtype} "
                             f"element on {dev}")
    return _build.ptr(noise_sigma_acc), _build.ptr(noise_seed)


def fq_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor,
              scale: torch.Tensor, *, epilogue: str = "requant",
              n_out: int = 7, lo: int = 0, weight_format: str = "int8",
              noise_sigma_acc=None, noise_seed=None,
              mac_chunks: int = 1) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) with the fused requant/dequant epilogue.

    ``scale`` is the folded rescale (requant) or alpha (dequant), a
    one-element float32 tensor on the codes' device. Packed B
    (``weight_format`` "int4" or "ternary") is (rows_p, N) uint8 with
    0 <= rows_p * factor - K < factor. ``noise_sigma_acc`` (float32) and
    ``noise_seed`` (uint32), one-element tensors on the codes' device, turn
    on the ADC noise, ``mac_chunks`` draws per output.
    """
    noisy = check_noise("fq_matmul", noise_sigma_acc, noise_seed, mac_chunks)
    factor = format_factor(weight_format)
    m, k = a_codes.shape
    rows, n = b_codes.shape
    if not 0 <= rows * factor - k < factor:
        raise ValueError(f"fq_matmul: {tuple(a_codes.shape)} x "
                         f"{tuple(b_codes.shape)} ({weight_format})")
    if factor > 1 and b_codes.dtype != torch.uint8:
        raise ValueError(f"fq_matmul: {weight_format} weights are packed "
                         f"uint8, got {b_codes.dtype}")
    if a_codes.device.type == "cpu":
        return fq_matmul_plain(a_codes, b_codes, scale, epilogue=epilogue,
                               n_out=n_out, lo=lo,
                               weight_format=weight_format,
                               noise_sigma_acc=noise_sigma_acc,
                               noise_seed=noise_seed, mac_chunks=mac_chunks)
    check_operands("fq_matmul", scale, epilogue, a_codes, b_codes,
                   weight_format)
    sigma, seed = (noise_pointers("fq_matmul", a_codes.device,
                                  noise_sigma_acc, noise_seed)
                   if noisy else (None, None))
    dequant = epilogue == "dequant"
    vector = a_loader(k, a_codes.data_ptr()) == "vector"
    out = torch.empty((m, n), device=a_codes.device,
                      dtype=torch.float32 if dequant else torch.int8)
    lib = _build.library("fq_matmul", _SIG)
    with torch.cuda.device(a_codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fq_matmul_s8(
            _build.ptr(a_codes), _build.ptr(b_codes), _build.ptr(scale),
            _build.ptr(out), sigma, seed, m, n, k, factor, int(dequant),
            int(lo), int(n_out), mac_chunks, int(vector),
            int(b_vector(n, b_codes.data_ptr())), ctypes.c_void_p(stream))
    _build.check(err, "fq_matmul", lib)
    fq_matmul.launches += 1
    if vector:
        fq_matmul.vector_launches += 1
    if factor > 1:
        fq_matmul.packed_launches[weight_format] += 1
    if noisy:
        fq_matmul.noisy_launches += 1
    return out


fq_matmul.launches = 0
fq_matmul.packed_launches = packed_counts()
fq_matmul.noisy_launches = 0
fq_matmul.vector_launches = 0
