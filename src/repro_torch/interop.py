"""Carry weights and deployment stacks across from the reference.

The reference (``repro``) and the port draw different random numbers and
round ``exp`` differently (XLA's float32 ``exp`` is not torch's), so a port
that re-derived the folded scalars could flip codes at rounding
boundaries. These loaders take the reference's arrays, as numpy, and copy
them bit for bit: int8 weight codes or packed (int4 / ternary) uint8
bytes, the folded float32 ``rescale`` / ``alpha`` / ``s_out`` scalars, the
float edge layers (KWS's embedding, BN and head; DarkNet's conv0 and head),
the entry scale and the decode scale, a residual DAG's hand-off edges and
list-valued extras (the integer LM's ``island_s_in``), ``jax.random``
keys (their two uint32 words) for the noise model, and the float
transformer's parameter trees (float32, bfloat16 or converted to int8
codes for serving), and optimizer states (Adam's float32 or int8 moments,
SGD's momentum). Nothing here imports the reference; callers hand over
numpy arrays and plain objects.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .core.integer_inference import ConvertedStack, LayerSpec, to_device
from .core.quant import WEIGHT_FORMATS, QuantConfig
from .device import DeviceLike, resolve_device


def _tensors(x):
    """numpy arrays / numpy scalars -> CPU tensors, recursively; python
    ints, floats and strings (a layer's statics) stay as they are.
    bfloat16 arrays (ml_dtypes: 2-byte words to numpy) keep their bits."""
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tensors(v) for v in x)
    if isinstance(x, (np.ndarray, np.generic)):
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(x).view(np.uint16)).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x, copy=True))
    return x


def _qcfg(q) -> QuantConfig:
    return QuantConfig(q.bits_w, q.bits_a, q.bits_out, q.fq)


def _spec(s) -> LayerSpec:
    return LayerSpec(s.name, s.relu_out, s.final, s.weight_format)


def stack_from_numpy(layers: Dict[str, dict], extras: Dict[str, Any], qcfg,
                     specs: Sequence, *,
                     entry_inv_scale: Optional[np.ndarray] = None,
                     handoff_edges: Optional[Sequence] = None,
                     device: DeviceLike = None) -> ConvertedStack:
    """The reference ConvertedStack's leaves (numpy) -> the port's stack.

    ``qcfg`` and ``specs`` may be the reference's objects (read by field).
    ``entry_inv_scale`` is the reference's own e^{-s_in}; when given, the
    entry quantizer uses it instead of recomputing it with torch.exp.
    ``handoff_edges`` is the reference stack's own (None for a chain).
    """
    dev = resolve_device(device)
    specs = [_spec(s) for s in specs]
    for s in specs:
        fmt = layers[s.name].get("weight_format", "int8")
        if fmt != s.weight_format or fmt not in WEIGHT_FORMATS:
            raise ValueError(f"stack_from_numpy({s.name}): layer format "
                             f"{fmt!r} vs spec {s.weight_format!r}")
        got = np.asarray(layers[s.name]["w_codes"]).dtype
        want = np.dtype(np.int8 if fmt == "int8" else np.uint8)
        if got != want:
            raise ValueError(f"stack_from_numpy({s.name}): {fmt} codes are "
                             f"{want}, got {got}")
    extras = _tensors(extras)
    if entry_inv_scale is not None:
        extras["entry"] = {**extras["entry"],
                           "inv_scale": torch.from_numpy(
                               np.array(entry_inv_scale, np.float32))}
    stack = ConvertedStack(_qcfg(qcfg), specs, _tensors(layers), extras,
                           handoff_edges=handoff_edges)
    return stack.to(dev)


def params_from_numpy(params: Dict[str, Any], state: Dict[str, Any], *,
                      device: DeviceLike = None):
    """Float FQ params and BN state of any model (numpy trees) -> tensors
    on ``device``, leaf for leaf, bit for bit. The float transformer's
    trees too (``models.transformer.make_params``, or after
    ``quantize_params_for_serving``): dicts and tuples, scan-stacked
    ``blocks`` with their leading group dim, ``w_codes`` / ``w_scale``, the
    MoE experts' ``*_codes``, bfloat16 leaves (its state is ``{}``)."""
    dev = resolve_device(device)
    return to_device(_tensors(params), dev), to_device(_tensors(state), dev)


def opt_state_from_numpy(state: Dict[str, Any], *,
                         device: DeviceLike = None):
    """An optimizer state (numpy tree) -> tensors, leaf for leaf, bit for
    bit: Adam's ``{"mom": {m, v[, m_s, v_s]} a leaf, "count"}`` (int8
    moment codes stay int8) or SGD's ``{"mu": ...}``. The moments go to
    ``device``; Adam's step ``count`` stays a 0-d int32 CPU tensor, where
    ``optim.adam`` keeps it."""
    dev = resolve_device(device)
    out = {k: to_device(_tensors(v), dev) for k, v in state.items()
           if k != "count"}
    if "count" in state:
        out["count"] = torch.tensor(int(np.asarray(state["count"])),
                                    dtype=torch.int32)
    return out


def key_from_numpy(words, *, device: DeviceLike = None) -> torch.Tensor:
    """A reference key's uint32 words (``jax.random.key_data(key)`` or a
    legacy ``PRNGKey``, as numpy) -> the port's key, a (2,) int64 tensor
    on ``device`` (``core.prng``); a stack of keys (..., 2) likewise."""
    a = np.asarray(words)
    if (a.shape[-1:] != (2,) or not np.issubdtype(a.dtype, np.integer)
            or (a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF))):
        raise ValueError(f"a key is (..., 2) uint32 words, got {a.dtype} "
                         f"{a.shape}")
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))
