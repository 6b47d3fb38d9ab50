"""Attention: the chunked online softmax (flash style) of training and
prefill, the one-token decode path over a KV cache (optionally int8), GQA by
grouped einsum (KV heads never repeated), and sliding-window masking.

Counterpart of ``repro.models.attention``. ``flash_attention`` walks the
reference's query and KV chunks in its order (its two ``lax.scan`` loops
become Python loops), so that the running maximum, the rescaled sums and
the output agree to float rounding. Score products take float32 operands,
as the reference's ``preferred_element_type=float32``.

Caches are dicts of tensors, time-major (B, S, Hkv, D), with a 0-d int32
``pos``. The ``cache_update`` / ``ring_update`` / ``ring_fill`` functions
write into the cache they are given and return it: the port's counterpart
of the reference's donated caches (``transformer.decode_step`` copies them
first unless asked to work in place). Positions stay on the device; a
write at ``pos`` clamps its start as ``lax.dynamic_update_slice`` does.

KV cache quantization (``kv_bits=8``): per-(token, head) abs-max int8
codes and a float32 scale, the division tensor by tensor and the rounding
half to even, so that codes and scales are the reference's bit for bit
given the same K / V.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 512,
                    kv_chunk: int = 1024, q_offset: int = 0):
    """q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); Hq % Hkv == 0.

    Returns (B, Hq, Tq, D). Online softmax over KV chunks, for each query
    chunk in turn. ``window`` makes it sliding-window (local) causal."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    g = hq // hkv
    q_chunk = min(q_chunk, tq)
    kv_chunk = min(kv_chunk, tk)
    assert tq % q_chunk == 0 and tk % kv_chunk == 0, (tq, q_chunk, tk, kv_chunk)
    scale = d ** -0.5
    dev = q.device
    qr = q.reshape(b, hkv, g, tq, d)
    outs = []
    for qi in range(tq // q_chunk):
        qblk = _f32(qr[:, :, :, qi * q_chunk:(qi + 1) * q_chunk])
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for ki in range(tk // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                             _f32(k[:, :, sl])) * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, _f32(v[:, :, sl]))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, hq, tq, d)


# ---------------------------------------------------------------------------
# KV cache (time-major (B, S, Hkv, D); optional int8 quantization)
# ---------------------------------------------------------------------------


def init_cache(batch: int, max_len: int, hkv: int, d: int, *,
               kv_bits: Optional[int] = None, dtype=torch.bfloat16,
               device=None):
    cdtype = torch.int8 if kv_bits == 8 else dtype
    cache = {
        "k": torch.zeros((batch, max_len, hkv, d), dtype=cdtype,
                         device=device),
        "v": torch.zeros((batch, max_len, hkv, d), dtype=cdtype,
                         device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if kv_bits == 8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, max_len, hkv),
                                      dtype=torch.float32, device=device)
    return cache


def _q8(x):
    """Per-(token, head) abs-max int8 quantization: (B,T,H,D) -> codes,
    scale."""
    xf = _f32(x)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.div(torch.maximum(amax, torch.tensor(1e-8, device=x.device)),
                      torch.tensor(127.0, device=x.device))
    codes = torch.round(torch.div(xf, scale[..., None])).to(torch.int8)
    return codes, scale


def _dq8(codes, scale, dtype):
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def _rows(pos: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """Indices pos .. pos + n - 1, the start clamped into [0, size - n] as
    ``lax.dynamic_update_slice`` clamps it; no host read of ``pos``."""
    start = torch.clamp(pos.to(torch.int64), 0, size - n)
    return start + torch.arange(n, device=pos.device)


def write_rows(buf: torch.Tensor, pos: torch.Tensor, new: torch.Tensor):
    """``buf[:, pos:pos + T] = new`` in place (axis 1, clamped start)."""
    buf.index_copy_(1, _rows(pos, new.shape[1], buf.shape[1]),
                    new.to(buf.dtype))


def cache_update(cache, k_new, v_new):
    """Append k / v (B, T_new, Hkv, D) at cache['pos'], in the cache given;
    returns it."""
    pos = cache["pos"].clone()
    if "k_scale" in cache:
        kc, ks = _q8(k_new)
        vc, vs = _q8(v_new)
        for name, val in (("k", kc), ("v", vc), ("k_scale", ks),
                          ("v_scale", vs)):
            write_rows(cache[name], pos, val)
    else:
        write_rows(cache["k"], pos, k_new)
        write_rows(cache["v"], pos, v_new)
    cache["pos"].add_(k_new.shape[1])
    return cache


def decode_attention(q, cache, *, window: Optional[int] = None):
    """One-token attention against the cache.

    q: (B, Hq, 1, D). Attends to positions [0, pos) (the current token's
    k / v already in the cache), or the trailing ``window`` of them."""
    b, hq, _, d = q.shape
    s_len = cache["k"].shape[1]
    hkv = cache["k"].shape[2]
    g = hq // hkv
    dtype = q.dtype
    if "k_scale" in cache:
        k = _dq8(cache["k"], cache["k_scale"], dtype)
        v = _dq8(cache["v"], cache["v_scale"], dtype)
    else:
        k, v = cache["k"], cache["v"]
    k = k.permute(0, 2, 1, 3)                     # (B, Hkv, S, D)
    v = v.permute(0, 2, 1, 3)
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", _f32(qg),
                     _f32(k.to(dtype))) * d ** -0.5
    pos = cache["pos"]          # valid tokens after the current append
    kpos = torch.arange(s_len, device=q.device)
    mask = kpos[None, :] < pos
    if window is not None:
        mask &= kpos[None, :] >= pos - window
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, _f32(v))
    return out.reshape(b, hq, 1, d).to(dtype)


# ---------------------------------------------------------------------------
# Ring-buffer cache for sliding-window (local) attention
# ---------------------------------------------------------------------------
# A window-W layer attends to the last W tokens only, so its decode cache is
# a W-slot ring: position p lives in slot p % W; ``slot_pos`` holds each
# slot's absolute position (-1 = empty).


def init_ring_cache(batch: int, window: int, hkv: int, d: int, *,
                    dtype=torch.bfloat16, device=None):
    return {
        "k": torch.zeros((batch, window, hkv, d), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, hkv, d), dtype=dtype, device=device),
        "slot_pos": torch.full((window,), -1, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def ring_update(cache, k_new, v_new):
    """Append ONE token (B, 1, Hkv, D) at slot pos % W, in place."""
    w = cache["k"].shape[1]
    pos = cache["pos"].clone()
    slot = torch.remainder(pos, w).to(torch.int64).reshape(1)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    cache["slot_pos"].index_copy_(0, slot, pos.reshape(1))
    cache["pos"].add_(1)
    return cache


def ring_fill(cache, k_all, v_all):
    """Prefill: store the last W of S tokens, rotated into their slots.

    Position p -> slot p % W; element i of the kept tail (positions a..S-1,
    a = max(S - W, 0)) lands at slot (a + i) % W: a roll by a % W."""
    w = cache["k"].shape[1]
    s = k_all.shape[1]
    dev = k_all.device
    if s >= w:
        a = s - w
        shift = a % w
        cache["k"].copy_(torch.roll(k_all[:, a:], shift, dims=1))
        cache["v"].copy_(torch.roll(v_all[:, a:], shift, dims=1))
        cache["slot_pos"].copy_(torch.roll(
            torch.arange(a, s, dtype=torch.int32, device=dev), shift))
    else:
        cache["k"][:, :s] = k_all.to(cache["k"].dtype)
        cache["v"][:, :s] = v_all.to(cache["v"].dtype)
        ar = torch.arange(w, dtype=torch.int32, device=dev)
        cache["slot_pos"].copy_(torch.where(ar < s, ar,
                                            torch.full_like(ar, -1)))
    cache["pos"].fill_(s)
    return cache


def ring_decode_attention(q, cache):
    """One-token attention over a ring cache. q: (B, Hq, 1, D)."""
    b, hq, _, d = q.shape
    hkv = cache["k"].shape[2]
    g = hq // hkv
    dtype = q.dtype
    k = cache["k"].permute(0, 2, 1, 3)            # (B, Hkv, W, D)
    v = cache["v"].permute(0, 2, 1, 3)
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhwd->bhgw", _f32(qg),
                     _f32(k.to(dtype))) * d ** -0.5
    # every stored slot lies in the window by construction; only the empty
    # ones (slot_pos == -1) are masked
    mask = (cache["slot_pos"] >= 0)[None, None, None, :]
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgw,bhwd->bhgd", p, _f32(v))
    return out.reshape(b, hq, 1, d).to(dtype)
