"""The integer LM's attention island: masked GQA softmax attention over the
int8 code-domain KV cache, and its re-entry into the integer domain.

No TPU kernel of the reference corresponds: its ``models.fq_lm._attention``
(``fq_lm.py:202-218``) is plain jnp einsum / softmax, which XLA sums in an
order of its own, and its re-entry is ``wo``'s input quantizer. The
reference's tests need the island to be shape-invariant bit for bit (a
prefill of T tokens and one decode step equal a prefill of T + 1; a
batched decode equals an unbatched one), and cuBLAS and PyTorch's CUDA
reductions pick their summation order from the whole shape. So the island
is written out in one fixed order, defined over cache slots, as a CUDA
kernel (``csrc/lm_island.cu``) and as its plain version,
:func:`lm_island_plain`, which the wrapper runs for CPU tensors. The two are
bit-identical: every step is an IEEE float32 operation rounded to nearest,
with no fused multiply-add.

The order, for query head hq = h * G + g (KV head h) of batch row b at
query position t. The cache's slots j = 0 .. L - 1 fall into C = ceil(L /
32) chunks of 32 lanes: lane l of chunk c holds slot j = 32 c + l. A slot
is *empty* when j >= L or j > qpos[b, t]; it contributes exactly nothing.

  1. dequantize: value = e^s * (code / n), for q, k and v (``_deq``);
  2. score_j = the sum over d of q[d] * k[j, d], taken d = 0, 1, ... in
     turn, divided by sqrt(d_head);
  3. m = the max of the scores over non-empty slots (exact in any order);
     e_j = ``core.quant.exp`` (XLA's float32 exp) of score_j - m;
  4. the sum, in a fixed tree: each lane's partial starts at +0.0 and adds
     its slots' e_j chunk by chunk, c = 0, 1, ... in turn; then the 32
     partials fold in halves, S = S[:w / 2] + S[w / 2:] for w = 32, 16,
     ..., 2 (the kernel's xor butterfly over offsets 16, 8, 4, 2, 1);
  5. p_j = e_j / total; ctx[d] takes the two steps of 4 over p_j * v[j, d],
     for each d on its own;
  6. re-entry: code = round(clip(ctx / e_in, -1, 1) * n_a), int8
     (:func:`reentry_codes`, ``wo``'s input quantizer).

A partial that starts at +0.0 is never -0.0, so adding a +0.0 for an empty
slot is the same as skipping it: the plain version adds zeros where the
kernel skips. Against the reference (XLA's order) the float context differs
by a few float32 ulps; the tests count the re-entry codes that differ.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import quant
from ..core.quant import WEIGHT_BOUND
from . import _build

LANES = 32               # slots of a chunk: a warp's lanes
VECTOR_BYTES = 16        # the vector loader's load: one 16-byte row chunk
MAX_GROUP = 32           # query heads a KV head (warps of a block)
MAX_DH = 128             # d_head the kernel holds in registers
_SIG = {"fq_lm_island": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p]}


def sqrt_head(d_head: int) -> float:
    """sqrt(d_head) as the float32 value the reference divides by (numpy's
    float64 sqrt, canonicalized to float32)."""
    return float(np.float32(np.sqrt(d_head)))


def _check(q_codes, k_cache, v_cache, scales, qpos, n_heads):
    b, tq, d = q_codes.shape
    bk, _, kv, dh = k_cache.shape
    if (bk != b or v_cache.shape != k_cache.shape or n_heads % kv
            or d != n_heads * dh or tuple(qpos.shape) != (b, tq)
            or scales.numel() != 3):
        raise ValueError(f"lm_island: q {tuple(q_codes.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"qpos {tuple(qpos.shape)}, {n_heads} heads")
    return b, tq, kv, n_heads // kv, dh


def _fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The 32 lane partials along ``dim`` folded in halves (the kernel's
    xor butterfly); size 1 along ``dim``."""
    w = x.shape[dim]
    while w > 1:
        w //= 2
        x = x.narrow(dim, 0, w) + x.narrow(dim, w, w)
    return x


def lm_island_ctx_plain(q_codes, k_cache, v_cache, scales, qpos, *, n: int,
                        n_heads: int, sqrt_dh: float) -> torch.Tensor:
    """The island's float context in plain PyTorch, in the kernel's order
    (module doc, steps 1-5). q_codes: (B, Tq, H * dh) int8; caches (B, L,
    KV, dh) int8; scales (3,) float32 e^s of q, k, v; qpos (B, Tq) int;
    returns ctx (B, Tq, H * dh) float32."""
    b, tq, kv, g, dh = _check(q_codes, k_cache, v_cache, scales, qpos,
                              n_heads)
    length = k_cache.shape[1]
    chunks = -(-length // LANES)
    dev = q_codes.device
    # constants filled on the device: no host copy, so the plain version
    # can be captured in a CUDA graph (timed so on the card)
    f32 = dict(dtype=torch.float32, device=dev)
    nt = torch.full((), float(n), **f32)

    def deq(codes, i):
        return scales[i] * torch.div(codes.to(torch.float32), nt)

    def slots(cache, i):  # (B, KV, 1, 1, C, 32, dh), zeros past L
        x = deq(cache, i).permute(0, 2, 1, 3)
        x = torch.cat([x, x.new_zeros(b, kv, chunks * LANES - length, dh)], 2)
        return x.reshape(b, kv, 1, 1, chunks, LANES, dh)

    q = deq(q_codes, 0).reshape(b, tq, kv, g, dh).permute(0, 2, 3, 1, 4)
    q = q[:, :, :, :, None, None]               # (B, KV, G, Tq, 1, 1, dh)
    k, v = slots(k_cache, 1), slots(v_cache, 2)
    acc = q[..., 0] * k[..., 0]                 # (B, KV, G, Tq, C, 32)
    for d in range(1, dh):
        acc = acc + q[..., d] * k[..., d]
    scores = torch.div(acc, torch.full((), sqrt_dh, **f32))
    j = torch.arange(chunks * LANES, device=dev).reshape(chunks, LANES)
    live = (j < length) & (j <= qpos.to(torch.int64)[:, :, None, None])
    live = live[:, None, None]                  # (B, 1, 1, Tq, C, 32)
    zero = torch.zeros((), **f32)
    m = torch.amax(torch.where(live, scores, torch.full((), -np.inf, **f32)),
                   dim=(-2, -1), keepdim=True)
    e = torch.where(live, quant.exp(scores - m), zero)
    part = torch.zeros(e.shape[:-2] + (LANES,), **f32)
    for c in range(chunks):
        part = part + e[..., c, :]
    total = _fold(part, -1)[..., None]          # (..., 1, 1)
    pv = torch.where(live[..., None], torch.div(e, total)[..., None] * v,
                     zero)                      # (..., C, 32, dh)
    cpart = torch.zeros(pv.shape[:-3] + (LANES, dh), **f32)
    for c in range(chunks):
        cpart = cpart + pv[..., c, :, :]
    ctx = _fold(cpart, -2)[..., 0, :]           # (B, KV, G, Tq, dh)
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, tq, n_heads * dh)


def reentry_codes(ctx: torch.Tensor, e_in: torch.Tensor,
                  n_a: int) -> torch.Tensor:
    """The island's re-entry quantizer, ``wo``'s input quantizer:
    round(clip(ctx / e_in, -1, 1) * n_a) as int8 codes (the plain
    ``quant.quantize_to_int`` at e_in = e^{island_s_in})."""
    return torch.round(torch.clamp(torch.div(ctx, e_in), WEIGHT_BOUND, 1.0)
                       * n_a).to(torch.int8)


def lm_island_plain(q_codes, k_cache, v_cache, scales, qpos, e_in, *,
                    n: int, n_a: int, n_heads: int,
                    sqrt_dh: float) -> torch.Tensor:
    """The island's re-entry codes in plain PyTorch: the kernel's function
    (module doc, steps 1-6). e_in: a float32 scalar tensor; returns (B, Tq,
    H * dh) int8."""
    ctx = lm_island_ctx_plain(q_codes, k_cache, v_cache, scales, qpos, n=n,
                              n_heads=n_heads, sqrt_dh=sqrt_dh)
    return reentry_codes(ctx, e_in, n_a)


def island_loader(dh: int, *tensors: torch.Tensor) -> str:
    """The kernel's row loader: ``"vector"`` (one 16-byte load per 16
    codes of a q, K or V row) when d_head % 16 == 0 and every operand is
    16-byte aligned, else ``"byte"``."""
    ok = dh % VECTOR_BYTES == 0 and all(
        t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)
    return "vector" if ok else "byte"


def lm_island(q_codes, k_cache, v_cache, scales, qpos, e_in, *, n: int,
              n_a: int, n_heads: int, sqrt_dh: float) -> torch.Tensor:
    """The island's re-entry codes (module doc): ``csrc/lm_island.cu`` for
    CUDA tensors, :func:`lm_island_plain` for CPU ones. ``launches`` counts
    kernel launches, ``vector_launches`` those that took the vector
    loader."""
    if q_codes.device.type == "cpu":
        return lm_island_plain(q_codes, k_cache, v_cache, scales, qpos, e_in,
                               n=n, n_a=n_a, n_heads=n_heads,
                               sqrt_dh=sqrt_dh)
    dev = q_codes.device
    if dev.type != "cuda":
        raise ValueError(f"lm_island: unsupported device {dev}")
    b, tq, kv, g, dh = _check(q_codes, k_cache, v_cache, scales, qpos,
                              n_heads)
    for t, dtype in ((q_codes, torch.int8), (k_cache, torch.int8),
                     (v_cache, torch.int8), (scales, torch.float32),
                     (qpos, torch.int32), (e_in, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"lm_island: operands must be contiguous "
                             f"{dtype} on {dev}, got {t.dtype} on {t.device}")
    if e_in.numel() != 1:
        raise ValueError("lm_island: e_in must be one float32 element")
    if g > MAX_GROUP or dh > MAX_DH:
        raise ValueError(f"lm_island: {g} query heads a KV head (at most "
                         f"{MAX_GROUP}), d_head {dh} (at most {MAX_DH})")
    length = k_cache.shape[1]
    vector = island_loader(dh, q_codes, k_cache, v_cache) == "vector"
    out = torch.empty((b, tq, n_heads * dh), dtype=torch.int8, device=dev)
    lib = _build.library("lm_island", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fq_lm_island(
            _build.ptr(q_codes), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(scales), _build.ptr(qpos), _build.ptr(e_in),
            _build.ptr(out), b, tq, length, kv, g, dh, int(n), int(n_a),
            int(vector), float(sqrt_dh), ctypes.c_void_p(stream))
    _build.check(err, "lm_island", lib)
    lm_island.launches += 1
    if vector:
        lm_island.vector_launches += 1
    return out


lm_island.launches = 0
lm_island.vector_launches = 0
