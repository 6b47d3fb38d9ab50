"""PyTorch + CUDA port of the FQ-Conv reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch.core.quant`` <-> ``repro.core.quant`` and so on) so each
counterpart is easy to find. It imports ``torch`` and never ``jax`` or
``repro``: what it needs from the reference it keeps as its own copy.

Every TPU (Pallas) kernel on a ported path is a hand-written CUDA C++ kernel
for ``sm_90a`` under ``repro_torch/kernels/csrc``, built by ``nvcc`` at first
use. Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version of the same arithmetic for a CPU tensor.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise (see :mod:`.device`).
"""
from .device import has_cuda, resolve_device

__all__ = ["has_cuda", "resolve_device"]
