"""``repro_torch.models.{rglru,rwkv}`` against the reference, and the two
recurrent archs (recurrentgemma-2b, rwkv6-7b) end to end.

The recurrences are float and held to tolerance in the reference's order:
RG-LRU's sequence path through ``rglru.associative_scan`` (jax's
``lax.associative_scan`` pairing, so the same sums), RWKV's time mix a
step a token as its ``lax.scan``. Params are the reference's, carried
across by ``interop``; inputs numpy from a seed; quantizers under
``repro_torch.taps`` on the reference's record (``torch_zoo_ref``). Float
results within 1e-5 (blocks) or 1e-4 (whole models' logits) of their
largest magnitude; and on the port alone, the sequence path equals the
step path run token by token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JQ
from repro.models import rglru as JR
from repro.models import rwkv as JW
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W

import torch_zoo_ref as Z
from torch_zoo_ref import one_thread  # noqa: F401 (autouse)

F32 = np.float32
ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
QCFGS = {"fp": JQ(), "w8a8": JQ(8, 8)}
D, DR, HD = 32, 24, 8


def _x(seed, shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(F32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 2, 5, 8, 13])
def test_associative_scan_is_jax_pairing(t):
    """The recurrence h_t = a_t h_{t-1} + b_t bit for bit as
    ``lax.associative_scan`` forms it, at odd and even lengths."""
    ja, ta = _x(t, (2, t, 6))
    jb, tb = _x(t + 50, (2, t, 6))
    ja, ta = jnp.abs(ja), ta.abs()

    def jcomb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(jcomb, (ja, jb), axis=1)
    _, got = R.associative_scan(R._combine, [ta, tb])
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _rglru(seed):
    jp = JR.init_rglru_block(jax.random.key(seed), D, DR)
    return jp, Z.port_params(jp)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_rglru_seq_and_state(qname):
    q = QCFGS[qname]
    jp, tp = _rglru(1)
    for t in (2, 9):
        jx, tx = _x(2 + t, (2, t, D))
        (jy, jst), calls = Z.run_reference(
            lambda p, x: JR.apply_rglru_seq(p, x, q, return_state=True),
            jp, jx)
        (ty, tst), taps = Z.run_port(
            lambda: R.apply_rglru_seq(tp, tx, Z.tq(q), return_state=True),
            calls)
        Z.assert_ties_only(taps, "rglru seq")
        Z.assert_close(ty, jy, f"rglru seq T={t}", rtol=1e-5)
        for k in ("h", "conv"):
            Z.assert_close(tst[k], jst[k], k, rtol=1e-5)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_rglru_step(qname):
    q = QCFGS[qname]
    jp, tp = _rglru(3)
    jst = JR.init_rglru_state(2, DR)
    tst = R.init_rglru_state(2, DR, device="cpu")
    jx, tx = _x(4, (2, 6, D))
    with Z.traced_reference(
            lambda p, x, s: JR.apply_rglru_step(p, x, s, q)) as step:
        ref = []
        for i in range(6):
            (jy, jst), calls = step(jp, jx[:, i:i + 1], jst)
            ref.append((jy, jst, calls))
    for i, (jy, jst, calls) in enumerate(ref):
        (ty, tst), taps = Z.run_port(
            lambda: R.apply_rglru_step(tp, tx[:, i:i + 1], tst, Z.tq(q)),
            calls)
        Z.assert_ties_only(taps, "rglru step")
        Z.assert_close(ty, jy, f"rglru step {i}", rtol=1e-5)
        Z.assert_close(tst["h"], jst["h"], "h", rtol=1e-5)


def test_rglru_sequence_equals_steps():
    _, tp = _rglru(5)
    _, tx = _x(6, (1, 7, D))
    q = Z.tq(JQ())
    with torch.no_grad():
        want, st_seq = R.apply_rglru_seq(tp, tx, q, return_state=True)
        st = R.init_rglru_state(1, DR, device="cpu")
        outs = []
        for i in range(7):
            y, st = R.apply_rglru_step(tp, tx[:, i:i + 1], st, q)
            outs.append(y)
    Z.assert_close(torch.cat(outs, 1), want.numpy(), "steps", rtol=1e-5)
    Z.assert_close(st["h"], st_seq["h"].numpy(), "h", rtol=1e-5)
    Z.assert_close(st["conv"], st_seq["conv"].numpy(), "conv", rtol=1e-6)


def test_rglru_gelu_and_softplus_are_jax():
    jx, x = _x(7, (1000,), 4.0)
    Z.assert_close(R.gelu(x), jax.nn.gelu(jx), "gelu", rtol=1e-6)
    Z.assert_close(R.softplus(x), jax.nn.softplus(jx), "softplus", rtol=1e-6)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def _rwkv(seed):
    jp = JW.init_rwkv_block(jax.random.key(seed), D, HD, d_ff=48)
    # the init zeroes the LoRA B matrices; give them values, so that the
    # data-dependent paths carry signal
    r = np.random.default_rng(seed)
    jp = dict(jp)
    for k in ("lora_B", "lora_wB"):
        jp[k] = jnp.asarray(r.standard_normal(jp[k].shape).astype(F32) * 0.1)
    return jp, Z.port_params(jp)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_timemix_seq_and_state(qname):
    q = QCFGS[qname]
    jp, tp = _rwkv(8)
    jx, tx = _x(9, (2, 7, D))
    js0, ts0 = _x(10, (2, D // HD, HD, HD), 0.1)
    (jy, jS), calls = Z.run_reference(
        lambda p, x, s0: JW.apply_timemix_seq(p, x, q, HD, return_state=True,
                                              S0=s0), jp, jx, js0)
    (ty, tS), taps = Z.run_port(
        lambda: W.apply_timemix_seq(tp, tx, Z.tq(q), HD, return_state=True,
                                    S0=ts0), calls)
    Z.assert_ties_only(taps, "timemix")
    Z.assert_close(ty, jy, "timemix", rtol=1e-5)
    Z.assert_close(tS, jS, "S", rtol=1e-5)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_block_step_and_channelmix(qname):
    q = QCFGS[qname]
    jp, tp = _rwkv(11)
    jst = JW.init_rwkv_state(2, D, HD)
    tst = W.init_rwkv_state(2, D, HD, device="cpu")
    jx, tx = _x(12, (2, 5, D))

    def jstep(p, x, s):
        y, s = JW.apply_block_step(p, x, s, q, HD)
        c, s = JW.apply_channelmix_step(p, x + y, s, q)
        return y, c, s
    with Z.traced_reference(jstep) as step:
        ref = []
        for i in range(5):
            (jy, jc, jst), calls = step(jp, jx[:, i:i + 1], jst)
            ref.append((jy, jc, jst, calls))
    for i, (jy, jc, jst, calls) in enumerate(ref):
        def tstep():
            y, s = W.apply_block_step(tp, tx[:, i:i + 1], tst, Z.tq(q), HD)
            c, s = W.apply_channelmix_step(tp, tx[:, i:i + 1] + y, s,
                                           Z.tq(q))
            return y, c, s
        (ty, tc, tst), taps = Z.run_port(tstep, calls)
        Z.assert_ties_only(taps, f"rwkv step {i}")
        Z.assert_close(ty, jy, f"time mix {i}", rtol=1e-5)
        Z.assert_close(tc, jc, f"channel mix {i}", rtol=1e-5)
        for k in ("S", "x_tm", "x_cm"):
            Z.assert_close(tst[k], jst[k], k, rtol=1e-5)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_channelmix_seq(qname):
    q = QCFGS[qname]
    jp, tp = _rwkv(13)
    jx, tx = _x(14, (2, 6, D))
    jprev, tprev = _x(15, (2, D))
    for prev in (None, True):
        want, calls = Z.run_reference(
            lambda p, x, pr: JW.apply_channelmix_seq(p, x, q, prev=pr), jp,
            jx, jprev if prev else None)
        got, taps = Z.run_port(
            lambda: W.apply_channelmix_seq(tp, tx, Z.tq(q),
                                           prev=tprev if prev else None),
            calls)
        Z.assert_ties_only(taps, "channelmix")
        Z.assert_close(got, want, "channelmix", rtol=1e-5)


def test_rwkv_sequence_equals_steps():
    _, tp = _rwkv(16)
    _, tx = _x(17, (1, 6, D))
    q = Z.tq(JQ())
    with torch.no_grad():
        want, S = W.apply_timemix_seq(tp, tx, q, HD, return_state=True)
        st = W.init_rwkv_state(1, D, HD, device="cpu")
        outs = []
        for i in range(6):
            y, st = W.apply_block_step(tp, tx[:, i:i + 1], st, q, HD)
            outs.append(y)
    Z.assert_close(torch.cat(outs, 1), want.numpy(), "steps", rtol=1e-5)
    Z.assert_close(st["S"], S.numpy(), "S", rtol=1e-5)


def test_groupnorm_is_population_variance():
    _, x = _x(18, (2, 3, 16))
    g = torch.ones(16)
    want = JW._groupnorm(jnp.asarray(x.numpy()), jnp.ones(16), 4)
    Z.assert_close(W._groupnorm(x, g, 4), want, "groupnorm", rtol=1e-5)


# ---------------------------------------------------------------------------
# the recurrent archs end to end (torch_zoo_ref)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_counts(arch_id):
    Z.check_counts(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_forward(arch_id):
    Z.check_forward(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_prefill_decode(arch_id):
    Z.check_prefill_decode(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_serving_codes(arch_id):
    Z.check_serving_codes(Z.arch_case(arch_id))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_generate(arch_id):
    Z.check_generate(Z.arch_case(arch_id))


def test_recurrentgemma_ring_wraps():
    """A prompt longer than the local-attention window (16): the ring
    cache wraps, and prefill + decode still match the reference's."""
    c = Z.arch_case(ARCHS[0])
    assert c.cfg.pattern[2].window == 16
    jb, tb, _ = Z.inputs(c.jcfg, 21, b=1, s=20)
    jt, tt = jb["tokens"], tb["tokens"]
    (jl, jc), calls = Z.run_reference(
        lambda p, b: Z.JT.prefill(p, b, c.jcfg, c.jq, max_len=24),
        c.jparams, {"tokens": jt[:, :18]})
    (tl, tc), taps = Z.run_port(
        lambda: Z.T.prefill(c.params, {"tokens": tt[:, :18]}, c.cfg, c.q,
                            max_len=24), calls)
    Z.assert_ties_only(taps, "prefill 18")
    Z.assert_close(tl, jl, "prefill 18")
    Z.check_caches(jc, tc, "prefill 18")
    for i in (18, 19):
        (jl, jc), calls = Z.run_reference(
            lambda p, cc, t: Z.JT.decode_step(p, cc, t, c.jcfg, c.jq),
            c.jparams, jc, jt[:, i:i + 1])
        (tl, tc), taps = Z.run_port(
            lambda: Z.T.decode_step(c.params, tc, tt[:, i:i + 1], c.cfg,
                                    c.q), calls)
        Z.assert_ties_only(taps, f"decode {i}")
        Z.assert_close(tl, jl, f"decode {i}")
        Z.check_caches(jc, tc, f"decode {i}")
