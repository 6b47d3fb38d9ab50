"""Hand-written CUDA kernels for Hopper and the integer ops built on them.

K1 ``quantize.quantize_codes``, K2 ``fq_matmul.fq_matmul``, K3
``fq_conv.fq_conv2d`` and K3b ``fq_conv.fq_conv2d_pool`` (``fq_conv2d``
with ``pool=``) each count their kernel launches in a ``launches``
attribute on the wrapper; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0. K2, K3 and K3b also count the
launches that took packed weights (K5, the packed prologue) per format in
``packed_launches``, which :func:`packed_launch_counts` reads, and the
launches with the ADC-noise epilogue (K4) in ``noisy_launches``, which
:func:`noisy_launch_counts` reads. K2, K3 and K3b run on the tensor-core
tile loop and count the launches whose A operand took its vector (16-byte
``cp.async``) loader in ``vector_launches``, which
:func:`vector_launch_counts` reads. K3's split-K launches (the tile
policy's ``bc`` below Cin, reduced inside a thread-block cluster) are
counted in ``fq_conv2d.split_launches``, which :func:`split_launch_counts`
reads; a split launch counts in ``launches`` too, once. The integer LM's
attention island (``lm_island.lm_island``, a port-only kernel: the
reference's island is plain jnp) counts its launches the same way, and in
``lm_island.vector_launches`` those that took its 16-byte row loader.
"""
from __future__ import annotations

from typing import Dict

from .fq_conv import fq_conv2d, fq_conv2d_pool
from .fq_matmul import fq_matmul
from .lm_island import lm_island
from .quantize import quantize_codes

_WRAPPERS = {"quantize_codes": quantize_codes, "fq_matmul": fq_matmul,
             "fq_conv2d": fq_conv2d, "fq_conv2d_pool": fq_conv2d_pool,
             "lm_island": lm_island}
PACKED = ("fq_matmul", "fq_conv2d", "fq_conv2d_pool")
NOISY = PACKED
VECTOR = ("fq_matmul", "fq_conv2d", "fq_conv2d_pool")


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, whatever the weight format."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def packed_launch_counts() -> Dict[str, int]:
    """Launches on packed weights, as ``"<kernel>_<format>"``: n."""
    return {f"{name}_{fmt}": n for name in PACKED
            for fmt, n in _WRAPPERS[name].packed_launches.items()}


def noisy_launch_counts() -> Dict[str, int]:
    """Launches with the ADC-noise epilogue, as ``"<kernel>_noisy"``: n."""
    return {f"{name}_noisy": _WRAPPERS[name].noisy_launches
            for name in NOISY}


def vector_launch_counts() -> Dict[str, int]:
    """Launches whose A operand took the vector loader, as
    ``"<kernel>_vector"``: n."""
    return {f"{name}_vector": _WRAPPERS[name].vector_launches
            for name in VECTOR}


def split_launch_counts() -> Dict[str, int]:
    """K3's split-K launches (``fq_conv2d_splitk``: the cluster kernel)."""
    return {"fq_conv2d_splitk": fq_conv2d.split_launches}


def reset_launch_counts() -> None:
    fq_conv2d.split_launches = 0
    lm_island.vector_launches = 0
    for name, fn in _WRAPPERS.items():
        fn.launches = 0
        if name in PACKED:
            fn.packed_launches = dict.fromkeys(fn.packed_launches, 0)
        if name in NOISY:
            fn.noisy_launches = 0
        if name in VECTOR:
            fn.vector_launches = 0
