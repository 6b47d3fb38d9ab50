"""Sharding context for the float transformer: the part with no mesh.

Counterpart of ``repro.models.sharding``'s context (``use_mesh``,
``active_mesh``, ``batch_axes``, ``dp_size``) and of ``constrain``, which is
the identity while no mesh is installed, so that the same model code runs
on one device. Under a mesh the reference turns ``constrain`` into a
sharding constraint and derives parameter partition specs (``spec_for``,
``param_specs``, ``named``, ``zero1_spec``, ``serving_constrain``); those
wait for the port's mesh slice, and ``constrain`` raises under a mesh
rather than pass a layout hint over silently.

A mesh here is anything with ``mesh_dim_names`` and a ``mesh`` tensor of
ranks (``torch.distributed.device_mesh.DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

_ctx = threading.local()


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh = None
        _ctx.batch_axes = ("data",)
    return _ctx


@contextlib.contextmanager
def use_mesh(mesh, batch_axes: Tuple[str, ...] = ("data",)):
    st = _state()
    prev = (st.mesh, st.batch_axes)
    st.mesh, st.batch_axes = mesh, batch_axes
    try:
        yield
    finally:
        st.mesh, st.batch_axes = prev


def active_mesh():
    return _state().mesh


def batch_axes() -> Tuple[str, ...]:
    return _state().batch_axes


def dp_size() -> int:
    """Total extent of the active batch axes (1 if no mesh is active)."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in batch_axes():
        if a in names:
            n *= int(mesh.mesh.shape[names.index(a)])
    return n


def constrain(x, *spec):
    """``x`` itself while no mesh is active (the reference's no-op path).

    Under a mesh the reference applies ``with_sharding_constraint(x,
    P(*spec))``; the port's mesh slice has not landed, so that raises."""
    if active_mesh() is None:
        return x
    raise NotImplementedError(
        "sharding.constrain under a mesh is not ported yet (the mesh "
        "slice); run the model with no mesh installed")
