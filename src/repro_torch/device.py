"""Device selection for the port's entry points.

The port runs on CUDA. The CPU is used only when the caller asks for it by
name (``device="cpu"``, as the CPU parity tests do); a missing GPU is an
error, never a silent fall-back.
"""
from __future__ import annotations

from typing import Union

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

DeviceLike = Union[str, torch.device, None]


def tracing() -> bool:
    """True while ``make_fx`` traces the caller (a proxy mode is active):
    the kernel wrappers then call their ``torch.library`` operators, which
    the trace records as one node each (``kernels.library``), and checks
    that read tensor values back to the host are skipped."""
    return get_proxy_mode() is not None


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises when there is none.
    ``"cpu"`` (or a CPU ``torch.device``) selects the plain PyTorch versions
    of the kernels. A CUDA device raises when CUDA is absent.
    """
    if device is None:
        if not has_cuda():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not has_cuda():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
