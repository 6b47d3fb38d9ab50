"""K2, K3 and K3b as ``torch.library`` operators, and their contracts.

A trace (``torch.fx.experimental.proxy_tensor.make_fx``) sees neither a
ctypes launch nor, on the CPU, anything but the plain version's float64
``mm``. So while a trace is active (``device.tracing``) the wrappers
``fq_matmul.fq_matmul`` and ``fq_conv.fq_conv2d`` call these operators
instead, and the trace records each kernel call as one node:

  * ``repro_torch::fq_matmul``: K2;
  * ``repro_torch::fq_conv2d``: K3, with the ``bc`` the tile policy picks
    (below Cin: split-K);
  * ``repro_torch::fq_conv2d_pool``: K3b.

On CPU tensors an operator runs its kernel's plain version, on CUDA tensors
the kernel's launch (counted on the wrapper's ``launches`` as ever);
``register_fake`` gives shapes and dtypes. Outside a trace nothing here
runs: :data:`op_calls` counts the operator calls and reads 0 after any
eager run.

:data:`CONTRACTS` holds what ``analysis.absint`` may assume of each
kernel, the node standing in for the kernel body: operand dtypes, the
accumulator dtype with the lines of ``csrc/`` that fix it, the reduction
depth (split-K slices included), the weight format and the epilogue's
output range.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.quant import format_factor
from .fq_conv import conv_out_size, fq_conv2d_plain
from .fq_conv import launch as fq_conv_launch
from .fq_matmul import fq_matmul_plain
from .fq_matmul import launch as fq_matmul_launch

op_calls: Dict[str, int] = {"fq_matmul": 0, "fq_conv2d": 0,
                            "fq_conv2d_pool": 0}


def reset_op_calls() -> None:
    for k in op_calls:
        op_calls[k] = 0


# ---------------------------------------------------------------------------
# The operators
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::fq_matmul", mutates_args=(),
                         device_types="cpu")
def fq_matmul_op(a_codes: torch.Tensor, b_codes: torch.Tensor,
                 scale: torch.Tensor, epilogue: str, n_out: int, lo: int,
                 weight_format: str, noise_sigma_acc: Optional[torch.Tensor],
                 noise_seed: Optional[torch.Tensor],
                 mac_chunks: int) -> torch.Tensor:
    op_calls["fq_matmul"] += 1
    return fq_matmul_plain(
        a_codes, b_codes, scale, epilogue=epilogue, n_out=n_out, lo=lo,
        weight_format=weight_format, noise_sigma_acc=noise_sigma_acc,
        noise_seed=noise_seed, mac_chunks=mac_chunks)


@fq_matmul_op.register_kernel("cuda")
def _fq_matmul_cuda(a_codes, b_codes, scale, epilogue, n_out, lo,
                    weight_format, noise_sigma_acc, noise_seed, mac_chunks):
    op_calls["fq_matmul"] += 1
    return fq_matmul_launch(
        a_codes, b_codes, scale, epilogue=epilogue, n_out=n_out, lo=lo,
        weight_format=weight_format, noise_sigma_acc=noise_sigma_acc,
        noise_seed=noise_seed, mac_chunks=mac_chunks)


@fq_matmul_op.register_fake
def _fq_matmul_fake(a_codes, b_codes, scale, epilogue, n_out, lo,
                    weight_format, noise_sigma_acc, noise_seed, mac_chunks):
    return a_codes.new_empty((a_codes.shape[0], b_codes.shape[1]),
                             dtype=_out_dtype(epilogue))


def _out_dtype(epilogue: str) -> torch.dtype:
    return torch.float32 if epilogue == "dequant" else torch.int8


def _conv(name: str, a_codes, w_codes, scale, kh, kw, stride, padding,
          dilation, pool, epilogue, n_out, lo, weight_format, bc,
          noise_sigma_acc, noise_seed, mac_chunks):
    op_calls[name] += 1
    kwargs = dict(kh=kh, kw=kw, stride=tuple(stride),
                  padding=tuple(padding), dilation=tuple(dilation),
                  pool=None if pool is None else tuple(pool),
                  epilogue=epilogue, n_out=n_out, lo=lo,
                  weight_format=weight_format,
                  noise_sigma_acc=noise_sigma_acc, noise_seed=noise_seed,
                  mac_chunks=mac_chunks)
    if a_codes.device.type == "cpu":
        return fq_conv2d_plain(a_codes, w_codes, scale, **kwargs)
    return fq_conv_launch(a_codes, w_codes, scale, bc=bc, **kwargs)


def _conv_fake(a_codes, w_codes, kh, kw, stride, padding, dilation, pool,
               epilogue):
    b, h, w, _ = a_codes.shape
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    if pool is not None:
        ho, wo = ho // pool[0], wo // pool[1]
    return a_codes.new_empty((b, ho, wo, w_codes.shape[1]),
                             dtype=_out_dtype(epilogue))


@torch.library.custom_op("repro_torch::fq_conv2d", mutates_args=(),
                         device_types=("cpu", "cuda"))
def fq_conv2d_op(a_codes: torch.Tensor, w_codes: torch.Tensor,
                 scale: torch.Tensor, kh: int, kw: int, stride: List[int],
                 padding: List[int], dilation: List[int], epilogue: str,
                 n_out: int, lo: int, weight_format: str, bc: int,
                 noise_sigma_acc: Optional[torch.Tensor],
                 noise_seed: Optional[torch.Tensor],
                 mac_chunks: int) -> torch.Tensor:
    return _conv("fq_conv2d", a_codes, w_codes, scale, kh, kw, stride,
                 padding, dilation, None, epilogue, n_out, lo, weight_format,
                 bc, noise_sigma_acc, noise_seed, mac_chunks)


@fq_conv2d_op.register_fake
def _fq_conv2d_fake(a_codes, w_codes, scale, kh, kw, stride, padding,
                    dilation, epilogue, n_out, lo, weight_format, bc,
                    noise_sigma_acc, noise_seed, mac_chunks):
    return _conv_fake(a_codes, w_codes, kh, kw, stride, padding, dilation,
                      None, epilogue)


@torch.library.custom_op("repro_torch::fq_conv2d_pool", mutates_args=(),
                         device_types=("cpu", "cuda"))
def fq_conv2d_pool_op(a_codes: torch.Tensor, w_codes: torch.Tensor,
                      scale: torch.Tensor, kh: int, kw: int,
                      stride: List[int], padding: List[int],
                      dilation: List[int], pool: List[int], epilogue: str,
                      n_out: int, lo: int, weight_format: str, bc: int,
                      noise_sigma_acc: Optional[torch.Tensor],
                      noise_seed: Optional[torch.Tensor],
                      mac_chunks: int) -> torch.Tensor:
    return _conv("fq_conv2d_pool", a_codes, w_codes, scale, kh, kw, stride,
                 padding, dilation, pool, epilogue, n_out, lo, weight_format,
                 bc, noise_sigma_acc, noise_seed, mac_chunks)


@fq_conv2d_pool_op.register_fake
def _fq_conv2d_pool_fake(a_codes, w_codes, scale, kh, kw, stride, padding,
                         dilation, pool, epilogue, n_out, lo, weight_format,
                         bc, noise_sigma_acc, noise_seed, mac_chunks):
    return _conv_fake(a_codes, w_codes, kh, kw, stride, padding, dilation,
                      pool, epilogue)


# ---------------------------------------------------------------------------
# The contracts
# ---------------------------------------------------------------------------

# The int32 accumulator, as the sources fix it: (file under csrc/, line,
# text on that line). The tile loop's MMA is s32 += s8 x s8, and the
# epilogue reads the fragment as int.
_TILE_MMA = ("igemm_tc.cuh", 139, "wgmma.mma_async.sync.aligned.m64n32k32"
             ".s32.s8.s8")


@dataclasses.dataclass(frozen=True)
class Contract:
    """What the analysis may assume of one kernel operator.

    ``weights`` names the weight operand; ``acc_sources`` are the lines of
    ``csrc/`` that make the accumulator ``acc_dtype``. The methods take
    the node's arguments by schema name, tensors given by their shapes.
    """

    op: str
    kernel: str
    weights: str
    acc_sources: Tuple[Tuple[str, int, str], ...]
    pooled: bool = False
    a_dtype: torch.dtype = torch.int8
    acc_dtype: torch.dtype = torch.int32

    def depth(self, args: dict) -> int:
        """Codes summed into one accumulator: K for K2, kh*kw*cin_p for K3
        and K3b (cin padded to the pack factor)."""
        if self.op == "fq_matmul":
            return int(args["a_codes"][1])
        factor = format_factor(args["weight_format"])
        cin_p = -(-int(args["a_codes"][3]) // factor) * factor
        return args["kh"] * args["kw"] * cin_p

    def slices(self, args: dict) -> Tuple[int, int]:
        """(split, codes a split): K3 on int8 weights with ``bc`` below
        Cin sums Cin / bc partials of kh*kw*bc codes each in int32; every
        other call is one slice of :meth:`depth`."""
        if self.op == "fq_conv2d" and args["weight_format"] == "int8":
            cin, bc = int(args["a_codes"][3]), args["bc"]
            if bc < cin:
                return cin // bc, args["kh"] * args["kw"] * bc
        return 1, self.depth(args)

    def out_range(self, args: dict) -> Optional[Tuple[int, int]]:
        """[lo, n_out] codes for requant; None (float32) for dequant."""
        if args["epilogue"] == "dequant":
            return None
        return args["lo"], args["n_out"]


CONTRACTS: Dict[str, Contract] = {
    "fq_matmul": Contract("fq_matmul", "K2", "b_codes",
                          (_TILE_MMA, ("fq_matmul.cu", 84, "int acc[16];"))),
    "fq_conv2d": Contract("fq_conv2d", "K3", "w_codes",
                          (_TILE_MMA, ("fq_conv.cu", 351, "int acc[16];"),
                           ("fq_conv.cu", 395, "int acc[16];"))),
    "fq_conv2d_pool": Contract("fq_conv2d_pool", "K3b", "w_codes",
                               (_TILE_MMA,
                                ("fq_conv.cu", 469, "int acc[16];"),
                                ("fq_conv.cu", 517, "int acc[16];")),
                               pooled=True),
}


def op_name(target) -> Optional[str]:
    """The operator a node's target is (``"fq_matmul"`` ...), or None."""
    if getattr(target, "namespace", None) == "repro_torch":
        return target._opname
    return None
