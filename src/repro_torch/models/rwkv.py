"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mix with
data-dependent decay and a matrix-valued state per head.

Counterpart of ``repro.models.rwkv``. Time-mix (per head, head dim N):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w0 + lora_w(x~_t))), token-shift mixing by learned
interpolation plus a low-rank ddlerp. Channel-mix is the squared-ReLU
two-layer MLP. Projections are FQ layers; the state recurrence stays in
float. The sequence path steps through time in a Python loop, in the
order of the reference's ``lax.scan``; decode is one such step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.quant import QuantConfig
from . import layers as L

_LORA = 32


def init_rwkv_block(gen, d: int, head_dim: int = 64, dtype=torch.float32,
                    d_ff: int | None = None):
    h = d // head_dim
    if d_ff is None:
        d_ff = int(3.5 * d)
    dev = L.device_of(gen)
    kw = dict(dtype=dtype, device=dev)
    return {
        "time_mu": torch.full((5, d), 0.5, **kw),        # r, k, v, g, w
        "lora_A": L.normal(gen, (d, _LORA * 5), dtype) * 0.01,
        "lora_B": torch.zeros((5, _LORA, d), **kw),
        "w0": torch.full((d,), -6.0, **kw),              # decay bias
        "lora_wA": L.normal(gen, (d, _LORA), dtype) * 0.01,
        "lora_wB": torch.zeros((_LORA, d), **kw),
        "u": L.normal(gen, (h, head_dim), dtype) * 0.1,
        "wr": L.init_proj(gen, d, d, dtype),
        "wk": L.init_proj(gen, d, d, dtype),
        "wv": L.init_proj(gen, d, d, dtype),
        "wg": L.init_proj(gen, d, d, dtype),
        "wo": L.init_proj(gen, d, d, dtype),
        "ln_g": torch.ones((d,), **kw),
        # channel mix
        "cm_mu": torch.full((2, d), 0.5, **kw),
        "cm_k": L.init_proj(gen, d, d_ff, dtype),
        "cm_v": L.init_proj(gen, d_ff, d, dtype),
        "cm_r": L.init_proj(gen, d, d, dtype),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1}; ``prev`` (B, d) seeds t = 0 for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None], x[:, :-1]], 1)


def _ddlerp(p, x, xs):
    """Data-dependent interpolation (v6): five mixed inputs r, k, v, g, w."""
    base = x + (xs - x) * p["time_mu"][:, None, None, :]  # (5,B,T,d)
    lora = torch.tanh((x + (xs - x) * 0.5) @ p["lora_A"].to(x.dtype))
    lora = lora.reshape(x.shape[:-1] + (5, _LORA))
    adj = torch.einsum("btfl,fld->fbtd", lora, p["lora_B"].to(x.dtype))
    return base + adj * (xs - x)


def _wkv_inputs(p, x, xs, qcfg, head_dim):
    b, t, d = x.shape
    h = d // head_dim
    mr, mk, mv, mg, mw = _ddlerp(p, x, xs)
    r = L.proj(p["wr"], mr, qcfg).reshape(b, t, h, head_dim)
    k = L.proj(p["wk"], mk, qcfg).reshape(b, t, h, head_dim)
    v = L.proj(p["wv"], mv, qcfg).reshape(b, t, h, head_dim)
    g = F.silu(L.proj(p["wg"], mg, qcfg))
    ww = p["w0"].to(torch.float32) + (
        torch.tanh(mw @ p["lora_wA"].to(x.dtype))
        @ p["lora_wB"].to(x.dtype)).to(torch.float32)
    w = torch.exp(-torch.exp(ww)).reshape(b, t, h, head_dim)  # in (0, 1)
    return r, k, v, g, w


def _groupnorm(x, gamma, head_dim):
    b, t, d = x.shape
    xg = x.reshape(b, t, d // head_dim, head_dim).to(torch.float32)
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(b, t, d).to(x.dtype) * gamma


def _wkv_step(S, u, rt, kt, vt, wt):
    """One time step of the WKV recurrence on (B, H, N) inputs."""
    kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
    out = torch.einsum("bhk,bhkv->bhv", rt, S + u[None, :, :, None] * kv)
    return wt[..., None] * S + kv, out


def apply_timemix_seq(p, x, qcfg: QuantConfig, head_dim: int = 64,
                      return_state: bool = False, S0=None):
    """x: (B, T, d) -> (B, T, d); a step a token with (B, H, N, N) state."""
    b, t, d = x.shape
    h = d // head_dim
    r, k, v, g, w = _wkv_inputs(p, x, _shift(x), qcfg, head_dim)
    u = p["u"].to(torch.float32)
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    S = S0 if S0 is not None else torch.zeros(
        (b, h, head_dim, head_dim), dtype=torch.float32, device=x.device)
    outs = []
    for i in range(t):
        S, o = _wkv_step(S, u, r[:, i], k[:, i], v[:, i], w[:, i])
        outs.append(o)
    out = torch.stack(outs, 1).reshape(b, t, d).to(x.dtype)
    out = _groupnorm(out, p["ln_g"].to(x.dtype), head_dim) * g
    y = L.proj(p["wo"], out, qcfg)
    if return_state:
        return y, S
    return y


def apply_channelmix_seq(p, x, qcfg: QuantConfig, prev=None):
    xs = _shift(x, prev)
    mk = x + (xs - x) * p["cm_mu"][0]
    mr = x + (xs - x) * p["cm_mu"][1]
    kk = torch.square(torch.relu(L.proj(p["cm_k"], mk, qcfg)))
    return torch.sigmoid(L.proj(p["cm_r"], mr, qcfg)) * \
        L.proj(p["cm_v"], kk, qcfg)


def init_rwkv_state(batch: int, d: int, head_dim: int = 64,
                    dtype=torch.float32, device=None):
    return {
        "S": torch.zeros((batch, d // head_dim, head_dim, head_dim),
                         dtype=torch.float32, device=device),
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def apply_block_step(p, x, state, qcfg: QuantConfig, head_dim: int = 64):
    """One-token time-mix of an rwkv block. x: (B, 1, d), the post-norm
    input. Returns (tm_out, new_state)."""
    b, _, d = x.shape
    xs = state["x_tm"][:, None]
    r, k, v, g, w = _wkv_inputs(p, x, xs, qcfg, head_dim)
    rt, kt, vt, wt = (a[:, 0].to(torch.float32) for a in (r, k, v, w))
    S, out = _wkv_step(state["S"], p["u"].to(torch.float32), rt, kt, vt, wt)
    out = out.reshape(b, 1, d).to(x.dtype)
    out = _groupnorm(out, p["ln_g"].to(x.dtype), head_dim) * g
    tm_out = L.proj(p["wo"], out, qcfg)
    new_state = dict(state)
    new_state["S"] = S
    new_state["x_tm"] = x[:, 0]
    return tm_out, new_state


def apply_channelmix_step(p, x, state, qcfg: QuantConfig):
    out = apply_channelmix_seq(p, x, qcfg, prev=state["x_cm"])
    new_state = dict(state)
    new_state["x_cm"] = x[:, 0]
    return out, new_state
