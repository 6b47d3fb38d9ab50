"""``repro_torch.models.{layers,attention,sharding}`` against the reference.

Inputs are numpy arrays from a seed, fed to both sides. Float results are
held within 1e-5 (a few float32 roundings of sums in other orders) of
their largest magnitude, relative; the int8 KV cache's codes and scales,
the ring cache's slots and every position are held bit for bit. The FQ
projection's quantizers run under ``repro_torch.taps`` on the reference's
recorded inputs (``torch_zoo_ref``): a code that rounds otherwise must be a
rounding tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fq_layers as jfql
from repro.core.quant import QuantConfig as JQ
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import sharding as jshd
from repro.models import transformer as JT
from repro_torch.core.quant import QuantConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T

from torch_zoo_ref import (assert_close, assert_ties_only, one_thread,  # noqa: F401
                           run_port, run_reference, tq)

F32 = np.float32


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(a, dtype=F32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want, rtol=1e-5):
    assert_close(got, want, rtol=rtol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    r = _rng(0)
    x = r.standard_normal((2, 5, 24)).astype(F32) * 3
    g = r.standard_normal(24).astype(F32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    jg, tg = jnp.asarray(g, jd), torch.from_numpy(g).to(td)
    want = JL.rmsnorm({"scale": jg}, jx)
    got = L.rmsnorm({"scale": tg}, tx)
    assert got.dtype == td
    _close(got.float(), np.asarray(want, F32),
           rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta,d,positions", [
    (10000.0, 16, "arange"), (1e6, 14, "arange"), (5e5, 8, "offset"),
    (10000.0, 64, "single")])
def test_rope(theta, d, positions):
    r = _rng(1)
    x = r.standard_normal((3, 7 if positions != "single" else 1, d))
    pos = {"arange": np.arange(7), "offset": np.arange(100, 107),
           "single": np.array([37])}[positions].astype(np.int32)
    jx, tx = _pair(x)
    want = JL.rope(jx, jnp.asarray(pos), theta=theta)
    got = L.rope(tx, torch.from_numpy(pos), theta=theta)
    _close(got, want, rtol=2e-6)


def test_rope_bfloat16():
    x = _rng(2).standard_normal((4, 9, 32)).astype(F32)
    pos = np.arange(9, dtype=np.int32)
    want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = L.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, F32), rtol=1e-2)


def _proj_params(seed, din=24, dout=20):
    p = jfql.init_fq_linear(jax.random.key(seed), din, dout)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("q", [JQ(), JQ(8, 8), JQ(4, 6), JQ(8, 8, 8, True)],
                         ids=["fp", "w8a8", "w4a6", "fq888"])
def test_proj_float_branch(q):
    """``proj`` without codes is the FQ linear layer in every mode."""
    jp, tp = _proj_params(3)
    jx, tx = _pair(_rng(4).standard_normal((2, 5, 24)) * 2)
    want, calls = run_reference(lambda: JL.proj(jp, jx, q), jit=False)
    got, taps = run_port(lambda: L.proj(tp, tx, tq(q)), calls)
    assert_ties_only(taps, "proj")
    _close(got, want)


def test_proj_codes_branch():
    """Deployed ``w_codes`` / ``w_scale``: the codes and scale of the
    serving conversion bit for bit, the dequantized matmul close."""
    jp, tp = _proj_params(5, 32, 16)
    jq = JT.quantize_params_for_serving({"p": jp}, 8)["p"]
    tqp = T.quantize_params_for_serving({"p": tp})["p"]
    assert np.array_equal(tqp["w_codes"].numpy(), np.asarray(jq["w_codes"]))
    assert tqp["w_scale"].numpy().tobytes() == \
        np.asarray(jq["w_scale"]).tobytes()
    jx, tx = _pair(_rng(6).standard_normal((3, 32)))
    for q in (JQ(), JQ(8, 8)):   # codes bypass the quantizers
        _close(L.proj(tqp, tx, tq(q)), JL.proj(jq, jx, q))


def test_maybe_norm_and_fold_rmsnorm():
    jx, tx = _pair(_rng(7).standard_normal((2, 3, 24)))
    g = _rng(8).standard_normal(24).astype(F32)
    jn, tn = {"scale": jnp.asarray(g)}, {"scale": torch.from_numpy(g)}
    assert L.maybe_norm(tn, tx, QuantConfig(8, 8, 8, fq=True)) is tx
    _close(L.maybe_norm(tn, tx, QuantConfig(8, 8)),
           JL.maybe_norm(jn, jx, JQ(8, 8)))
    jp, tp = _proj_params(9)
    jf, tf = JL.fold_rmsnorm(jn, jp), L.fold_rmsnorm(tn, tp)
    assert np.array_equal(tf["w"].numpy(), np.asarray(jf["w"]))
    np.testing.assert_allclose(float(tf["s_w"]), float(jf["s_w"]), rtol=1e-6)
    assert tf is not tp and tp["w"] is not tf["w"]


def test_init_proj_shapes_and_meta():
    g = torch.Generator().manual_seed(0)
    p = L.init_proj(g, 12, 7, torch.bfloat16)
    assert p["w"].shape == (12, 7) and p["w"].dtype == torch.bfloat16
    assert p["s_w"].shape == () and p["s_w"].dtype == torch.float32
    np.testing.assert_allclose(
        float(p["s_w"]), np.log(float(p["w"].float().abs().max())),
        rtol=1e-6)
    m = L.init_proj(None, 12, 7)
    assert all(v.is_meta for v in m.values())
    assert m["w"].shape == (12, 7) and m["s_in"].shape == ()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,nq,nk,qc,kc,causal,window,off", [
    (4, 4, 16, 16, 16, 16, True, None, 0),     # MHA, one chunk
    (4, 2, 16, 16, 4, 8, True, None, 0),       # GQA, 4 x 2 chunks
    (8, 1, 24, 24, 8, 6, True, 5, 0),          # MQA, windowed
    (6, 3, 12, 12, 12, 4, False, None, 0),     # bidirectional (encoder)
    (4, 2, 8, 20, 4, 5, False, None, 0),       # cross attention, Tq != Tk
    (4, 2, 4, 12, 2, 4, True, None, 8),        # a query block at an offset
    (2, 2, 10, 10, 5, 2, True, 3, 0),          # fully masked chunks
])
def test_flash_attention(hq, hkv, nq, nk, qc, kc, causal, window, off):
    r = _rng(hq * 100 + nq)
    jq_, tq_ = _pair(r.standard_normal((2, hq, nq, 8)))
    jk, tk = _pair(r.standard_normal((2, hkv, nk, 8)))
    jv, tv = _pair(r.standard_normal((2, hkv, nk, 8)))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              q_offset=off)
    _close(A.flash_attention(tq_, tk, tv, **kw),
           JA.flash_attention(jq_, jk, jv, **kw))


def test_flash_attention_bfloat16():
    r = _rng(11)
    x = [r.standard_normal(s).astype(F32) for s in
         ((1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16))]
    want = JA.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in x),
                              q_chunk=8, kv_chunk=8)
    got = A.flash_attention(*(torch.from_numpy(a).bfloat16() for a in x),
                            q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, F32), rtol=1e-2)


# ---------------------------------------------------------------------------
# the full KV cache, float and int8
# ---------------------------------------------------------------------------


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_steps(kv_bits, window):
    """A prompt appended at once, then token by token: the cache leaves
    (int8 codes and scales bit for bit) and each step's attention."""
    r = _rng(12 + (kv_bits or 0) + (window or 0))
    b, hq, hkv, d, s = 2, 4, 2, 8, 10
    k = r.standard_normal((b, s, hkv, d)).astype(F32) * 2
    v = r.standard_normal((b, s, hkv, d)).astype(F32)
    k[0, 2, 1] = 0.0                          # an all-zero (token, head)
    q = r.standard_normal((b, hq, s, d)).astype(F32)
    jc = JA.init_cache(b, s + 2, hkv, d, kv_bits=kv_bits, dtype=jnp.float32)
    tc = A.init_cache(b, s + 2, hkv, d, kv_bits=kv_bits, dtype=torch.float32,
                      device="cpu")
    n_pre = 4
    jc = JA.cache_update(jc, jnp.asarray(k[:, :n_pre]),
                         jnp.asarray(v[:, :n_pre]))
    out = A.cache_update(tc, torch.from_numpy(k[:, :n_pre]),
                         torch.from_numpy(v[:, :n_pre]))
    assert out is tc
    for i in range(n_pre, s):
        jc = JA.cache_update(jc, jnp.asarray(k[:, i:i + 1]),
                             jnp.asarray(v[:, i:i + 1]))
        A.cache_update(tc, torch.from_numpy(k[:, i:i + 1]),
                       torch.from_numpy(v[:, i:i + 1]))
        for name in jc:
            assert tc[name].numpy().tobytes() == _np(jc[name]).tobytes(), \
                (name, i)
        qi = q[:, :, i:i + 1]
        _close(A.decode_attention(torch.from_numpy(qi), tc, window=window),
               JA.decode_attention(jnp.asarray(qi), jc, window=window))


def test_q8_codes_and_scales_bit_exact():
    """Per-(token, head) abs-max int8 over magnitudes from 1e-9 to 1e4, at
    codes' half-way points too: the division tensor by tensor, rounded half
    to even."""
    r = _rng(13)
    x = r.standard_normal((3, 16, 4, 32)).astype(F32)
    x *= (10.0 ** r.uniform(-9, 4, (3, 16, 4, 1))).astype(F32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :2] = [127.0, 0.5]           # scale 1: 0.5 is a tie
    x[1, 1, 1, 2:] = 0.25
    jc, js = JA._q8(jnp.asarray(x))
    tc, ts = A._q8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), _np(jc))
    assert ts.numpy().tobytes() == _np(js).tobytes()
    assert int(tc[1, 1, 1, 1]) == 0
    assert np.array_equal(A._dq8(tc, ts, torch.float32).numpy(),
                          _np(JA._dq8(jc, js, jnp.float32)))


def test_cache_update_clamps_like_dynamic_update_slice():
    """A write past the end starts at max_len - T, as the reference's."""
    r = _rng(14)
    k = r.standard_normal((1, 3, 1, 4)).astype(F32)
    jc = JA.init_cache(1, 5, 1, 4, dtype=jnp.float32)
    tc = A.init_cache(1, 5, 1, 4, dtype=torch.float32, device="cpu")
    jc = dict(jc, pos=jnp.asarray(4, jnp.int32))
    tc["pos"].fill_(4)
    jc = JA.cache_update(jc, jnp.asarray(k), jnp.asarray(k))
    A.cache_update(tc, torch.from_numpy(k), torch.from_numpy(k))
    assert np.array_equal(tc["k"].numpy(), _np(jc["k"]))
    assert int(tc["pos"]) == int(jc["pos"]) == 7


# ---------------------------------------------------------------------------
# the ring cache of sliding-window layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [3, 6, 9, 14])
def test_ring_cache(s):
    """ring_fill of an s-token prompt into a 6-slot ring, then 5 tokens by
    ring_update: slots, slot positions and positions bit for bit, each
    step's attention close."""
    r = _rng(15 + s)
    b, hq, hkv, d, w, n = 2, 4, 2, 8, 6, 5
    k = r.standard_normal((b, s + n, hkv, d)).astype(F32)
    v = r.standard_normal((b, s + n, hkv, d)).astype(F32)
    q = r.standard_normal((b, hq, s + n, d)).astype(F32)
    jc = JA.ring_fill(JA.init_ring_cache(b, w, hkv, d, dtype=jnp.float32),
                      jnp.asarray(k[:, :s]), jnp.asarray(v[:, :s]))
    tc = A.ring_fill(A.init_ring_cache(b, w, hkv, d, dtype=torch.float32,
                                       device="cpu"),
                     torch.from_numpy(k[:, :s]), torch.from_numpy(v[:, :s]))
    for i in range(s, s + n):
        for name in jc:
            assert tc[name].numpy().tobytes() == _np(jc[name]).tobytes(), \
                (name, i)
        jc = JA.ring_update(jc, jnp.asarray(k[:, i:i + 1]),
                            jnp.asarray(v[:, i:i + 1]))
        A.ring_update(tc, torch.from_numpy(k[:, i:i + 1]),
                      torch.from_numpy(v[:, i:i + 1]))
        qi = q[:, :, i:i + 1]
        _close(A.ring_decode_attention(torch.from_numpy(qi), tc),
               JA.ring_decode_attention(jnp.asarray(qi), jc))


# ---------------------------------------------------------------------------
# sharding without a mesh
# ---------------------------------------------------------------------------


class _FakeMesh:
    """A mesh's names and rank grid, as a torch DeviceMesh has them."""
    mesh_dim_names = ("pod", "data", "model")
    mesh = torch.zeros((2, 3, 4))


def test_sharding_context_without_a_mesh():
    x = torch.ones(2, 3, 4)
    assert shd.active_mesh() is None and jshd.active_mesh() is None
    assert shd.batch_axes() == jshd.batch_axes() == ("data",)
    assert shd.dp_size() == jshd.dp_size() == 1
    assert shd.constrain(x, "batch", None, None) is x
    assert L.shard_activations(x) is x


def test_sharding_use_mesh_restores_and_counts_batch_axes():
    m = _FakeMesh()
    with shd.use_mesh(m, ("pod", "data")):
        assert shd.active_mesh() is m
        assert shd.batch_axes() == ("pod", "data")
        assert shd.dp_size() == 6
        with pytest.raises(NotImplementedError, match="mesh slice"):
            shd.constrain(torch.ones(2), "batch")
    assert shd.active_mesh() is None and shd.batch_axes() == ("data",)
