"""The integer LM's attention island: masked GQA softmax attention over the
int8 code-domain KV cache.

No TPU kernel of the reference corresponds: its ``models.fq_lm._attention``
(``fq_lm.py:202-218``) is plain jnp einsum / softmax, which XLA sums in an
order of its own. The reference's tests need the island to be
shape-invariant bit for bit (a prefill of T tokens and one decode step
equal a prefill of T + 1; a batched decode equals an unbatched one), and
cuBLAS and PyTorch's CUDA reductions pick their summation order from the
whole shape. So the island is written out in one fixed order, as a CUDA
kernel (``csrc/lm_island.cu``) and as its plain version,
:func:`lm_island_plain`, which the wrapper runs for CPU tensors. The two are
bit-identical: every step is an IEEE float32 operation rounded to nearest,
with no fused multiply-add. Per row (batch b, query position t, query head
hq = h * G + g of KV head h):

  1. dequantize: value = e^s * (code / n), for q, k and v (``_deq``);
  2. scores over every key j of the ``max_len`` cache: the sum over d of
     q[d] * k[j, d], taken d = 0, 1, ... in turn, divided by sqrt(d_head)
     (a float32 value);
  3. the mask: keys j > qpos[b, t] score -1e30;
  4. m = the scores' max; e_j = ``core.quant.exp`` (XLA's float32 exp) of
     score_j - m, which is exactly 0 at masked keys;
  5. the sum of e_j over j = 0, 1, ... in turn; p_j = e_j / sum;
  6. ctx[d] = the sum over j, in turn, of p_j * v[j, d].

Against the reference (XLA's reduction order) the outputs differ by a few
float32 ulps; the tests count the island re-entry codes that differ.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import quant
from . import _build

THREADS = 128
SMEM_LIMIT = 48 * 1024   # static launch limit: no opt-in attribute needed
_SIG = {"fq_lm_island": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
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


def lm_island_plain(q_codes, k_cache, v_cache, scales, qpos, *, n: int,
                    n_heads: int, sqrt_dh: float) -> torch.Tensor:
    """The island in plain PyTorch, the kernel's order of operations as
    elementwise ops and loops over d_head and keys (module doc). q_codes:
    (B, Tq, H * dh) int8; caches (B, L, KV, dh) int8; scales (3,) float32
    e^s of q, k, v; qpos (B, Tq) int; returns ctx (B, Tq, H * dh) float32."""
    b, tq, kv, g, dh = _check(q_codes, k_cache, v_cache, scales, qpos,
                              n_heads)
    length = k_cache.shape[1]
    # constants filled on the device: no host copy, so the plain version
    # can be captured in a CUDA graph (timed so on the card)
    f32 = dict(dtype=torch.float32, device=q_codes.device)
    nt = torch.full((), float(n), **f32)

    def deq(codes, i):
        return scales[i] * torch.div(codes.to(torch.float32), nt)

    q = deq(q_codes, 0).reshape(b, tq, kv, g, dh).permute(0, 2, 3, 1, 4)
    k = deq(k_cache, 1).permute(0, 2, 1, 3)[:, :, None, None]
    v = deq(v_cache, 2).permute(0, 2, 1, 3)[:, :, None, None]
    acc = q[..., 0, None] * k[..., 0]          # (B, KV, G, Tq, L)
    for d in range(1, dh):
        acc = acc + q[..., d, None] * k[..., d]
    scores = torch.div(acc, torch.full((), sqrt_dh, **f32))
    keys = torch.arange(length, device=q_codes.device)
    mask = (keys[None, None, :] <= qpos.to(torch.int64)[:, :, None])
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), -1e30, **f32))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = quant.exp(scores - m)
    total = e[..., 0]
    for j in range(1, length):
        total = total + e[..., j]
    p = torch.div(e, total[..., None])
    ctx = p[..., 0, None] * v[..., 0, :]       # (B, KV, G, Tq, dh)
    for j in range(1, length):
        ctx = ctx + p[..., j, None] * v[..., j, :]
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, tq, n_heads * dh)


def smem_bytes(length: int, g: int, dh: int) -> int:
    """The kernel's dynamic shared memory: dequantized q (G x dh) and v
    (L x dh), the scores (G x L), the maxima and sums (2 x G), float32."""
    return 4 * (g * dh + length * dh + g * length + 2 * g)


def lm_island(q_codes, k_cache, v_cache, scales, qpos, *, n: int,
              n_heads: int, sqrt_dh: float) -> torch.Tensor:
    """ctx = the island (module doc) of int8 codes: ``csrc/lm_island.cu``
    for CUDA tensors, :func:`lm_island_plain` for CPU ones."""
    if q_codes.device.type == "cpu":
        return lm_island_plain(q_codes, k_cache, v_cache, scales, qpos, n=n,
                               n_heads=n_heads, sqrt_dh=sqrt_dh)
    dev = q_codes.device
    if dev.type != "cuda":
        raise ValueError(f"lm_island: unsupported device {dev}")
    b, tq, kv, g, dh = _check(q_codes, k_cache, v_cache, scales, qpos,
                              n_heads)
    for t, dtype in ((q_codes, torch.int8), (k_cache, torch.int8),
                     (v_cache, torch.int8), (scales, torch.float32),
                     (qpos, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"lm_island: operands must be contiguous "
                             f"{dtype} on {dev}, got {t.dtype} on {t.device}")
    length = k_cache.shape[1]
    if smem_bytes(length, g, dh) > SMEM_LIMIT:
        raise ValueError(f"lm_island: a cache of {length} keys x {dh} needs "
                         f"{smem_bytes(length, g, dh)} bytes of shared memory")
    out = torch.empty((b, tq, n_heads * dh), dtype=torch.float32, device=dev)
    lib = _build.library("lm_island", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fq_lm_island(
            _build.ptr(q_codes), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(scales), _build.ptr(qpos), _build.ptr(out), b, tq,
            length, kv, g, dh, int(n), float(sqrt_dh),
            ctypes.c_void_p(stream))
    _build.check(err, "lm_island", lib)
    lm_island.launches += 1
    return out


lm_island.launches = 0
