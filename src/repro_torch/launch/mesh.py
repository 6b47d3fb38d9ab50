"""Replica placement for the serving lanes.

Counterpart of ``repro.launch.mesh.replica_devices``. The reference's
meshes (``make_mesh``, ``make_serving_mesh``, ``batch_axes``) shard the
float model zoo and the batcher's ``mesh=`` path, neither of which the port
has yet.
"""
from __future__ import annotations

from typing import List

import torch

from ..device import DeviceLike, resolve_device


def replica_devices(n_replicas: int,
                    device: DeviceLike = None) -> List[torch.device]:
    """Devices for ``n_replicas`` logical replica lanes.

    With ``device`` None the lanes round-robin over the CUDA devices that
    PyTorch sees (on one card every lane maps to it: the lanes stay
    logically distinct, with their own windows, streams, graphs and stack
    copies); with no CUDA device this raises. ``device="cpu"`` gives
    ``n_replicas`` CPU devices, as the CPU tests ask for them; a named CUDA
    device pins every lane to it.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas={n_replicas} must be >= 1")
    if device is not None:
        return [resolve_device(device)] * n_replicas
    resolve_device(None)  # raises without a CUDA device
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_replicas)]
