"""Mixture-of-Experts (GShard / Switch-style capacity dispatch) with FQ
experts.

Counterpart of ``repro.models.moe``. Routing stays in float (like the
paper's softmax); each expert is an FQ layer with its own learned quant
scales. Top-k keeps ``lax.top_k``'s order: largest first, ties to the lower
expert index (a stable descending sort; ``torch.topk`` promises no order),
so that capacity positions, a cumulative sum over (token, choice) in that
order, are the reference's. One-hots are comparisons with an index range,
as ``jax.nn.one_hot``: an index out of range gives a row of zeros (a token
over capacity is dropped).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core import fq_layers as fql
from ..core.quant import QuantConfig, WEIGHT_BOUND
from . import layers as L
from . import sharding as shd


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN width
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25


def init_moe(gen, d: int, cfg: MoEConfig, dtype=torch.float32):
    e, f = cfg.n_experts, cfg.d_expert
    lim = (2.0 / d) ** 0.5
    wg = L.normal(gen, (e, d, f), dtype) * lim
    wu = L.normal(gen, (e, d, f), dtype) * lim
    wd = L.normal(gen, (e, f, d), dtype) * lim
    router = L.normal(gen, (d, e), dtype) * 0.02
    p = {
        "router": {"w": router},
        "experts": {
            "w_gate": wg,
            "w_up": wu,
            "w_down": wd,
            # a per-expert log-scale covering max|w| (quant.init_scale)
            "s_w": torch.stack([L.log_scale(w, (1, 2))
                                for w in (wg, wu, wd)]),
            "s_in": L.scalar(0.0, wg),
            "s_out": L.scalar(0.0, wg),
        },
    }
    if cfg.n_shared:
        fs = cfg.d_expert * cfg.n_shared
        p["shared"] = {
            "gate": L.init_proj(gen, d, fs, dtype),
            "up": L.init_proj(gen, d, fs, dtype),
            "down": L.init_proj(gen, fs, d, dtype),
        }
    return p


def _qw(w, s, qcfg: QuantConfig):
    return fql.learned_quantize(w, s, bits=qcfg.bits_w,
                                b=WEIGHT_BOUND).to(w.dtype)


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: rows of zeros for indices outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values largest first, ties in index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p, x, cfg: MoEConfig, qcfg: QuantConfig,
              seq_chunk: int = 4096):
    """x: (B, S, d) -> (y, aux).

    Tokens are regrouped into ~``seq_chunk``-token dispatch groups before
    the one-hot capacity dispatch, whatever the (B, S) shape: the dispatch
    tensor is O(group * E * cap), and at decode (S = 1) all B tokens share
    one group (per-row groups of one token would compute E x B expert
    slots for B tokens). Capacity is per group."""
    b, s, d = x.shape
    n = b * s
    ng = min(seq_chunk, n)
    while n % ng:
        ng -= 1
    if (b, s) != (n // ng, ng):
        y, aux = _moe_dense(p, x.reshape(n // ng, ng, d), cfg, qcfg)
        return y.reshape(b, s, d), aux
    return _moe_dense(p, x, cfg, qcfg)


def _moe_dense(p, x, cfg: MoEConfig, qcfg: QuantConfig):
    """One-hot capacity dispatch (GShard). x: (B, S, d) -> (y, aux)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = math.ceil(s * k * cfg.capacity_factor / e) if s > 1 else k
    cap = max(cap, 1)
    dt = x.dtype

    logits = torch.einsum("bsd,de->bse", x, p["router"]["w"].to(dt))
    logits32 = logits.to(torch.float32)
    probs = torch.softmax(logits32, dim=-1)
    gate_vals, idx = top_k(probs, k)                     # (B,S,K)
    gate_vals = torch.div(gate_vals, torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9))

    # capacity assignment: position of each (token, choice) in its expert
    oh = one_hot(idx, e, torch.int32)                    # (B,S,K,E)
    pos = torch.cumsum(oh.reshape(b, s * k, e), dim=1, dtype=torch.int32) - 1
    pos_tok = torch.sum(pos.reshape(b, s, k, e) * oh, -1)  # (B,S,K)
    keep = (pos_tok < cap).to(dt)
    ohc = one_hot(pos_tok, cap, dt)                      # (B,S,K,C)
    ohx = oh.to(dt)
    disp = torch.einsum("bske,bskc->bsec", ohx * keep[..., None], ohc)
    comb = torch.einsum("bsec,bsk,bske->bsec", disp, gate_vals.to(dt), ohx)

    ep = p["experts"]
    xin = x
    if qcfg.bits_a is not None:
        xin = fql.learned_quantize(xin, ep["s_in"], bits=qcfg.bits_a,
                                   b=WEIGHT_BOUND)
    xe = torch.einsum("bsec,bsd->becd", disp, xin)
    # the reference picks the expert layout by dp_size; both arms are the
    # identity without a mesh, and the mesh slice brings its specs
    xe = shd.constrain(xe, None, "model", None, "data")
    if "w_gate_codes" in ep:
        # deployed int8 experts (paper eq. 4): real = e^s / n * code, the
        # per-expert scale folded into the operand load
        sc = ep["w_scale"]                               # (3, E, 1, 1)
        wg = L.dequant(ep["w_gate_codes"], sc[0], dt)
        wu = L.dequant(ep["w_up_codes"], sc[1], dt)
        wd = L.dequant(ep["w_down_codes"], sc[2], dt)
    else:
        wg, wu, wd = ep["w_gate"], ep["w_up"], ep["w_down"]
        if qcfg.bits_w is not None:
            wg = _qw(wg, ep["s_w"][0], qcfg)
            wu = _qw(wu, ep["s_w"][1], qcfg)
            wd = _qw(wd, ep["s_w"][2], qcfg)
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg.to(dt)))
    h = h * torch.einsum("becd,edf->becf", xe, wu.to(dt))
    ye = torch.einsum("becf,efd->becd", h, wd.to(dt))
    if qcfg.fq and qcfg.bits_out is not None:
        ye = fql.learned_quantize(ye, ep["s_out"], bits=qcfg.bits_out,
                                  b=WEIGHT_BOUND)
    y = torch.einsum("becd,bsec->bsd", ye, comb)

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(L.proj(sp["gate"], x, qcfg)) * L.proj(sp["up"], x, qcfg)
        y = y + L.proj(sp["down"], hs, qcfg)

    # aux losses: Switch load balance + router z-loss
    me = torch.mean(probs, dim=(0, 1))                   # (E,)
    ce = torch.mean(one_hot(idx[..., 0], e, torch.float32), dim=(0, 1))
    lb = e * torch.sum(me * ce)
    zl = torch.mean(torch.logsumexp(logits32, -1) ** 2)
    return y, {"load_balance": lb, "router_z": zl}
