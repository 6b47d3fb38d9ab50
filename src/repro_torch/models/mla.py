"""Multi-head Latent Attention (DeepSeek-V2) with FQ projections.

Counterpart of ``repro.models.mla``. KV is compressed to a ``kv_lora``-dim
latent c_kv plus one shared RoPE key. Train / prefill expand k / v from the
latent and run flash attention; decode uses the absorbed form (W_uk folded
into the query, W_uv applied after the context sum), so the cache holds only
(c_kv, k_rope). The absorbed path quantizes W_up and the cached latent as
the sequence path's FQ projection does, or decode would part from prefill.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core import fq_layers as fql
from ..core.quant import QuantConfig, WEIGHT_BOUND
from . import layers as L
from .attention import _NEG, flash_attention, write_rows


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


def init_mla(gen, d: int, n_heads: int, cfg: MLAConfig,
             dtype=torch.float32):
    h = n_heads
    return {
        "wq": L.init_proj(gen, d, h * (cfg.qk_nope_dim + cfg.qk_rope_dim),
                          dtype),
        "kv_down": L.init_proj(gen, d, cfg.kv_lora, dtype),
        "k_rope": L.init_proj(gen, d, cfg.qk_rope_dim, dtype),
        "kv_up": L.init_proj(gen, cfg.kv_lora,
                             h * (cfg.qk_nope_dim + cfg.v_head_dim), dtype),
        "wo": L.init_proj(gen, h * cfg.v_head_dim, d, dtype),
    }


def _split_q(q, h, cfg):
    b, t, _ = q.shape
    q = q.reshape(b, t, h, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _expand_kv(p, ckv, h, cfg, qcfg):
    kv = L.proj(p["kv_up"], ckv, qcfg)
    b, t, _ = kv.shape
    kv = kv.reshape(b, t, h, cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def mla_attention(p, x, positions, n_heads: int, cfg: MLAConfig,
                  qcfg: QuantConfig, *, causal=True, q_chunk=512,
                  kv_chunk=1024):
    """Training / prefill path (expanded k / v). x: (B, T, d)."""
    b, t, _ = x.shape
    q_nope, q_rope = _split_q(L.proj(p["wq"], x, qcfg), n_heads, cfg)
    ckv = L.proj(p["kv_down"], x, qcfg)                  # (B,T,kv_lora)
    k_rope = L.proj(p["k_rope"], x, qcfg)                # (B,T,rope)
    k_nope, v = _expand_kv(p, ckv, n_heads, cfg, qcfg)
    q_rope = L.rope(q_rope.permute(0, 2, 1, 3).reshape(-1, t, cfg.qk_rope_dim),
                    positions).reshape(b, n_heads, t, cfg.qk_rope_dim)
    k_rope = L.rope(k_rope, positions)                   # shared by heads
    q = torch.cat([q_nope.permute(0, 2, 1, 3), q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (cfg.qk_rope_dim,))], -1).permute(0, 2, 1, 3)
    vv = v.permute(0, 2, 1, 3)
    # v_head_dim may differ from the qk dim: pad v for the shared flash
    # path, slice after
    dq = q.shape[-1]
    if vv.shape[-1] < dq:
        vv = F.pad(vv, (0, dq - vv.shape[-1]))
    out = flash_attention(q, k, vv, causal=causal, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)[..., :cfg.v_head_dim]
    out = out.permute(0, 2, 1, 3).reshape(b, t, n_heads * cfg.v_head_dim)
    return L.proj(p["wo"], out, qcfg), (ckv, k_rope)


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None):
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode(p, x, cache, n_heads: int, cfg: MLAConfig, qcfg: QuantConfig):
    """Absorbed one-token decode. x: (B, 1, d). Writes the cache given and
    returns (out, cache)."""
    b = x.shape[0]
    dt = x.dtype
    pos = cache["pos"].clone()
    posv = pos.reshape(1)
    q_nope, q_rope = _split_q(L.proj(p["wq"], x, qcfg), n_heads, cfg)
    ckv_new = L.proj(p["kv_down"], x, qcfg)
    kr_new = L.rope(L.proj(p["k_rope"], x, qcfg), posv)
    write_rows(cache["ckv"], pos, ckv_new)
    write_rows(cache["k_rope"], pos, kr_new)
    cache["pos"].add_(1)

    # absorb kv_up into q / out: W_uk (lora, H, nope), W_uv (lora, H, v),
    # quantized as the sequence path's FQ projection quantizes them
    if "w" in p["kv_up"]:
        w_up = p["kv_up"]["w"]
        if qcfg.bits_w is not None:
            w_up = fql.learned_quantize(
                w_up, p["kv_up"]["s_w"], bits=qcfg.bits_w,
                b=WEIGHT_BOUND).to(dt)
    else:  # int8 deployment codes (paper eq. 4): dequantized on load
        w_up = L.dequant(p["kv_up"]["w_codes"], p["kv_up"]["w_scale"], dt)
    # head-major column blocks of (nope + v): reshape, then split
    w_r = w_up.reshape(cfg.kv_lora, n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    wk = w_r[:, :, :cfg.qk_nope_dim]
    wv = w_r[:, :, cfg.qk_nope_dim:]
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, 0].reshape(b, n_heads, -1),
                         wk.to(dt))                      # (B,H,lora)
    qr = L.rope(q_rope[:, 0][:, :, None, :], posv)[:, :, 0]
    ckv_all = cache["ckv"].to(dt)
    if "w" in p["kv_up"] and qcfg.bits_a is not None:
        ckv_all = fql.learned_quantize(ckv_all, p["kv_up"]["s_in"],
                                       bits=qcfg.bits_a, b=WEIGHT_BOUND)
    kr_all = cache["k_rope"].to(dt)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    s = (torch.einsum("bhk,bsk->bhs", q_eff, ckv_all)
         + torch.einsum("bhr,bsr->bhs", qr, kr_all)) * scale
    valid = (torch.arange(ckv_all.shape[1], device=x.device)[None, None, :]
             < cache["pos"])
    pr = torch.softmax(torch.where(valid, s.to(torch.float32),
                                   _NEG), -1)
    ctx = torch.einsum("bhs,bsk->bhk", pr.to(dt), ckv_all)
    out = torch.einsum("bhk,khd->bhd", ctx, wv.to(dt))
    out = out.reshape(b, 1, n_heads * cfg.v_head_dim)
    return L.proj(p["wo"], out, qcfg), cache
