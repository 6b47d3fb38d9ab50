"""The attention island's plain versions (``repro_torch.kernels.lm_island``)
against an independent emulation of its slot-tree order.

The emulation is numpy float32, one query head at a time, written from the
order's definition: slots j = 32 c + l, a lane's partial from +0.0 over its
non-empty slots chunk by chunk (an empty slot is skipped, never added),
then the 32 partials folded in halves; the exp is XLA's (``jnp.exp`` on
the CPU), which ``core.quant.exp`` reproduces. Held bit for bit (float32
bits, so a -0.0 against a +0.0 would count): the float context at cache
lengths 24, 37 and 128 and d_head 16 and 8. The re-entry codes are held
equal, bit for bit, to the float context followed by the five eager ops
the LM ran before the quantizer moved into the kernel (divide, clamp,
multiply, round, cast). The kernel itself is held against these on the
card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.lm_island import (island_loader, lm_island,
                                           lm_island_ctx_plain,
                                           lm_island_plain, reentry_codes,
                                           sqrt_head)

N = 127


def _operands(b, tq, length, dh, seed, kv=2, g=2):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, tq, kv * g * dh)).astype(np.int8)
    k = rng.integers(-127, 128, (b, length, kv, dh)).astype(np.int8)
    v = rng.integers(-127, 128, (b, length, kv, dh)).astype(np.int8)
    # past the cache (every slot needed), at 0, and in between
    qpos = rng.integers(0, length + 6, (b, tq)).astype(np.int32)
    qpos[0, 0] = 0
    qpos[-1, -1] = length + 3
    scales = np.array([0.61, 1.37, 0.83], np.float32)
    return q, k, v, scales, qpos


def _fold(parts):
    w = len(parts)
    while w > 1:
        w //= 2
        parts = parts[:w] + parts[w:]
    return parts[0]


def _emulate(q, k, v, scales, qpos, n_heads):
    """The island's float context, query head by query head."""
    f32 = np.float32
    b, tq, _ = q.shape
    length, kv, dh = k.shape[1:]
    g = n_heads // kv
    chunks = -(-length // 32)

    def deq(codes, e):
        return f32(e) * (codes.astype(f32) / f32(N))

    qd, kd, vd = deq(q, scales[0]), deq(k, scales[1]), deq(v, scales[2])
    out = np.zeros((b, tq, n_heads * dh), f32)
    for bi in range(b):
        for ti in range(tq):
            last = min(int(qpos[bi, ti]), length - 1)
            for h in range(kv):
                kk, vv = kd[bi, :, h], vd[bi, :, h]
                for gi in range(g):
                    hq = h * g + gi
                    qq = qd[bi, ti, hq * dh:(hq + 1) * dh]
                    s = qq[0] * kk[:, 0]
                    for d in range(1, dh):
                        s = s + qq[d] * kk[:, d]
                    s = s / f32(sqrt_head(dh))
                    m = s[:last + 1].max()
                    e = np.zeros(length, f32)
                    e[:last + 1] = np.asarray(jnp.exp(s[:last + 1] - m))
                    slots = [[32 * c + l for c in range(chunks)
                              if 32 * c + l <= last] for l in range(32)]
                    parts = np.zeros(32, f32)
                    for l in range(32):
                        for j in slots[l]:
                            parts[l] = parts[l] + e[j]
                    total = _fold(parts)
                    p = e / total
                    for d in range(dh):
                        parts = np.zeros(32, f32)
                        for l in range(32):
                            for j in slots[l]:
                                parts[l] = parts[l] + p[j] * vv[j, d]
                        out[bi, ti, hq * dh + d] = _fold(parts)
    return out


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dh", [16, 8])
@pytest.mark.parametrize("length", [24, 37, 128])
def test_ctx_plain_matches_numpy_slot_tree(length, dh):
    q, k, v, s, qpos = _operands(2, 3, length, dh, seed=length + dh)
    got = lm_island_ctx_plain(*_torch(q, k, v, s, qpos), n=N, n_heads=4,
                              sqrt_dh=sqrt_head(dh)).numpy()
    want = _emulate(q, k, v, s, qpos, n_heads=4)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("e_in", [0.02, 0.3, 3.0])
@pytest.mark.parametrize("b,tq,length", [(1, 1, 128), (8, 1, 128),
                                         (1, 16, 128), (3, 5, 37),
                                         (2, 4, 200)])
def test_codes_equal_ctx_then_the_five_op_reentry(b, tq, length, e_in):
    """The fused re-entry codes == the float context, then divide, clamp,
    multiply, round and cast, as the LM ran them eagerly."""
    q, k, v, s, qpos = _torch(*_operands(b, tq, length, 16, seed=b + tq))
    ein = torch.tensor(np.float32(e_in))
    kw = dict(n=N, n_heads=4, sqrt_dh=sqrt_head(16))
    ctx = lm_island_ctx_plain(q, k, v, s, qpos, **kw)
    want = torch.round(torch.clamp(torch.div(ctx, ein), -1.0, 1.0)
                       * 127).to(torch.int8)
    got = lm_island_plain(q, k, v, s, qpos, ein, n_a=127, **kw)
    assert got.dtype == torch.int8
    assert torch.equal(got, want)
    assert torch.equal(reentry_codes(ctx, ein, 127), want)
    # |ctx| <= e^{s_v} = 0.83: 0.02 saturates codes, 3.0 none
    if e_in != 0.3:
        assert bool((got.abs() == 127).any()) == (e_in < 1.0)


def test_codes_do_not_depend_on_the_cache_past_the_needed_keys():
    """A query's codes from a cache cut just past its needed keys, from
    the LM's 128, and from one of 256 (past the old kernel's shared-memory
    ceiling) with other codes past the needed keys."""
    q, k, v, s, _ = _torch(*_operands(2, 3, 256, 16, seed=5))
    qpos = torch.tensor([[0, 31, 32], [33, 63, 95]], dtype=torch.int32)
    kw = dict(n=N, n_a=127, n_heads=4, sqrt_dh=sqrt_head(16))
    ein = torch.tensor(np.float32(0.3))
    base = lm_island_plain(q, k[:, :96], v[:, :96], s, qpos, ein, **kw)
    for length in (128, 256):
        k2, v2 = k[:, :length].clone(), v[:, :length].clone()
        k2[:, 96:], v2[:, 96:] = 77, -33
        assert torch.equal(lm_island_plain(q, k2, v2, s, qpos, ein, **kw),
                           base)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v, s, qpos = _torch(*_operands(2, 2, 40, 8, seed=9))
    ein = torch.tensor(np.float32(0.3))
    kw = dict(n=N, n_a=127, n_heads=4, sqrt_dh=sqrt_head(8))
    kernels.reset_launch_counts()
    assert torch.equal(lm_island(q, k, v, s, qpos, ein, **kw),
                       lm_island_plain(q, k, v, s, qpos, ein, **kw))
    assert kernels.launch_counts()["lm_island"] == 0
    assert lm_island.vector_launches == 0


def test_island_loader_picks_by_width_and_alignment():
    x = torch.zeros(64, dtype=torch.int8)
    assert island_loader(16, x, x, x) == "vector"
    assert island_loader(32, x, x, x) == "vector"
    assert island_loader(8, x, x, x) == "byte"
    assert island_loader(16, x, x[1:], x) == "byte"
