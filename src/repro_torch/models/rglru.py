"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``. Block: norm -> {x-branch: proj ->
causal conv1d (width 4) -> RG-LRU; y-branch: proj -> GeLU} -> x * y -> out
proj.

    r_t = sigmoid(W_r u_t);  i_t = sigmoid(W_i u_t)
    log a_t = -c * softplus(L) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The sequence path runs the recurrence as ``lax.associative_scan`` does
(:func:`associative_scan`: the same pairings, so the same float sums);
decode is the O(1) state update. GeLU is ``jax.nn.gelu``'s default, the
tanh approximation; softplus is ``logaddexp(x, 0)``, as jax writes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.quant import QuantConfig
from . import layers as L

_C = 8.0
_CONV_W = 4


def init_rglru_block(gen, d: int, dr: int, dtype=torch.float32):
    dev = L.device_of(gen)
    # Lambda so that a = exp(-c softplus(L)) spans ~[0.9, 0.999]
    lin = torch.linspace(0.9, 0.999, dr, dtype=torch.float32, device=dev)
    lam = torch.log(torch.expm1(-torch.log(lin) / _C)).to(dtype)
    return {
        "x_proj": L.init_proj(gen, d, dr, dtype),
        "y_proj": L.init_proj(gen, d, dr, dtype),
        "out": L.init_proj(gen, dr, d, dtype),
        "conv1d_w": L.normal(gen, (_CONV_W, dr), dtype) * 0.1,
        "rglru_wr": L.normal(gen, (dr, dr), dtype) * (dr ** -0.5),
        "rglru_wi": L.normal(gen, (dr, dr), dtype) * (dr ** -0.5),
        "rglru_lam": lam,
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True, its default)."""
    return F.gelu(x, approximate="tanh")


def _gates(p, u):
    r = torch.sigmoid(u @ p["rglru_wr"].to(u.dtype))
    i = torch.sigmoid(u @ p["rglru_wi"].to(u.dtype))
    log_a = (-_C * softplus(p["rglru_lam"].to(torch.float32))
             * r.to(torch.float32))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i.to(torch.float32) * u.to(torch.float32))
    return a, b


def _conv1d(p, x):
    """Causal depthwise conv, width 4. x: (B, T, dr)."""
    w = p["conv1d_w"].to(x.dtype)
    y = x * w[-1]
    for j in range(1, _CONV_W):
        y = y + F.pad(x, (0, 0, j, 0))[:, :-j] * w[-1 - j]
    return y


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, a2 * b1 + b2]


def _interleave(a, b, axis):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) = len(b) or one
    more)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _slice(x, axis, start, stop=None, step=1):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def associative_scan(fn, elems, axis: int = 1):
    """``lax.associative_scan(fn, elems, axis=axis)`` (inclusive, forward):
    jax's recursion, pairing adjacent elements, scanning the pairs, then
    filling in the even positions, so every sum is formed as jax forms it."""
    n = elems[0].shape[axis]
    if n < 2:
        return list(elems)
    reduced = fn([_slice(e, axis, 0, -1, 2) for e in elems],
                 [_slice(e, axis, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([_slice(e, axis, 0, -1) for e in odd],
                  [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def apply_rglru_seq(p, x, qcfg: QuantConfig, return_state: bool = False):
    """Full-sequence path. x: (B, T, d) -> (B, T, d)."""
    u_raw = L.proj(p["x_proj"], x, qcfg)
    u = _conv1d(p, u_raw)
    a, b = _gates(p, u)
    _, h = associative_scan(_combine, [a, b])
    y = gelu(L.proj(p["y_proj"], x, qcfg))
    res = L.proj(p["out"], h.to(x.dtype) * y, qcfg)
    if return_state:
        # decode state: the final h and the last CONV_W - 1 raw u values
        # (the causal conv's history the step path reads)
        t = x.shape[1]
        if t >= _CONV_W - 1:
            tail = u_raw[:, t - (_CONV_W - 1):]
        else:
            tail = F.pad(u_raw, (0, 0, _CONV_W - 1 - t, 0))
        return res, {"h": h[:, -1].to(torch.float32), "conv": tail.to(x.dtype)}
    return res


def init_rglru_state(batch: int, dr: int, dtype=torch.float32, device=None):
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, dr), dtype=dtype,
                                device=device)}


def apply_rglru_step(p, x, state, qcfg: QuantConfig):
    """One-token decode. x: (B, 1, d) -> (out (B, 1, d), new_state)."""
    u = L.proj(p["x_proj"], x, qcfg)[:, 0]              # (B, dr)
    w = p["conv1d_w"].to(u.dtype)
    hist = state["conv"]                                # (B, 3, dr)
    u_conv = u * w[-1] + torch.einsum("bjd,jd->bd", hist, w[:-1])
    new_conv = torch.cat([hist[:, 1:], u[:, None]], 1)
    a, b = _gates(p, u_conv)
    h = a * state["h"] + b
    y = gelu(L.proj(p["y_proj"], x, qcfg))[:, 0]
    out = L.proj(p["out"], (h.to(x.dtype) * y)[:, None], qcfg)
    return out, {"h": h, "conv": new_conv}
