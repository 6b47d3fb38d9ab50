"""Hand-written CUDA kernels for Hopper and the integer ops built on them.

K1 ``quantize.quantize_codes``, K2 ``fq_matmul.fq_matmul``, K3
``fq_conv.fq_conv2d`` and K3b ``fq_conv.fq_conv2d_pool`` (``fq_conv2d``
with ``pool=``) each count their kernel launches in a ``launches``
attribute on the wrapper; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

from .fq_conv import fq_conv2d, fq_conv2d_pool
from .fq_matmul import fq_matmul
from .quantize import quantize_codes

_WRAPPERS = {"quantize_codes": quantize_codes, "fq_matmul": fq_matmul,
             "fq_conv2d": fq_conv2d, "fq_conv2d_pool": fq_conv2d_pool}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
