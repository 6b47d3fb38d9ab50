"""``repro_torch.models.{moe,mla}`` against the reference, and the two MoE
archs (llama4-maverick, deepseek-v2-lite: MLA) end to end.

Params are the reference's (``init_moe`` / ``init_mla`` / ``make_params``
from a seeded key), carried across by ``interop``; inputs are numpy arrays
from a seed. The quantizers run under ``repro_torch.taps`` on the
reference's recorded inputs (``torch_zoo_ref``): every code the port
rounds otherwise must be a rounding tie. Float results are held within
1e-5 (MoE, MLA) or 1e-4 (whole models' logits) of their largest
magnitude; routing (top-k, capacity positions, drops) and the serving
conversion's codes and scales exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JQ
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch import tree
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

import torch_zoo_ref as Z
from torch_zoo_ref import one_thread  # noqa: F401 (autouse)

F32 = np.float32
ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v2-lite-16b"]
QCFGS = {"fp": JQ(), "w8a8": JQ(8, 8), "fq888": JQ(8, 8, 8, True)}


def _x(seed, shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(F32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _moe(seed, d, cfg):
    jp = JMOE.init_moe(jax.random.key(seed), d, cfg)
    return jp, Z.port_params(jp)


def _tmoe(cfg):
    return MOE.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_expert,
                         cfg.n_shared, cfg.capacity_factor)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # (B, S), MoEConfig, seq_chunk
    "prefill_drops": ((2, 16), JMOE.MoEConfig(4, 2, 24, 0, 0.5), 4096),
    "prefill_top1_shared": ((2, 8), JMOE.MoEConfig(8, 1, 32, 1, 1.25), 4096),
    "shared_two": ((1, 12), JMOE.MoEConfig(8, 2, 16, 2, 1.25), 4096),
    "decode_regrouped": ((4, 1), JMOE.MoEConfig(8, 2, 16, 2, 1.25), 4096),
    "regrouped_chunks": ((2, 12), JMOE.MoEConfig(4, 2, 16, 0, 1.0), 8),
}


@pytest.mark.parametrize("qname", list(QCFGS))
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe(case, qname):
    (b, s), jcfg, chunk = MOE_CASES[case]
    q, d = QCFGS[qname], 32
    jp, tp = _moe(list(MOE_CASES).index(case), d, jcfg)
    jx, tx = _x(len(case), (b, s, d), 2.0)
    (jy, jaux), calls = Z.run_reference(
        lambda p, x: JMOE.apply_moe(p, x, jcfg, q, seq_chunk=chunk), jp, jx)
    (ty, taux), taps = Z.run_port(
        lambda: MOE.apply_moe(tp, tx, _tmoe(jcfg), Z.tq(q), seq_chunk=chunk),
        calls)
    Z.assert_ties_only(taps, case)
    Z.assert_close(ty, jy, case, rtol=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)


def test_moe_drops_tokens_over_capacity():
    """At capacity factor 0.5 some (token, choice) pairs are dropped, as in
    the reference: the case above is not vacuous."""
    (b, s), jcfg, _ = MOE_CASES["prefill_drops"]
    jp, tp = _moe(1, 32, jcfg)
    _, tx = _x(2, (b, s, 32))
    probs = torch.softmax(tx @ tp["router"]["w"], -1)
    _, idx = MOE.top_k(probs, jcfg.top_k)
    per_expert = MOE.one_hot(idx, jcfg.n_experts, torch.int64).sum((1, 2))
    cap = int(np.ceil(s * jcfg.top_k * jcfg.capacity_factor / jcfg.n_experts))
    assert int(per_expert.max()) > cap


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.05],
                  [0.2, 0.2, 0.2, 0.2, 0.1, 0.1]], F32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = MOE.top_k(torch.from_numpy(x), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), k
        assert np.array_equal(tv.numpy(), np.asarray(jv)), k


def test_one_hot_is_jax_one_hot():
    idx = np.array([[-1, 0, 3, 4, 7]], np.int32)
    want = jax.nn.one_hot(jnp.asarray(idx), 5, dtype=jnp.float32)
    got = MOE.one_hot(torch.from_numpy(idx), 5, torch.float32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_moe_deployed_int8_experts():
    """``quantize_params_for_serving`` on MoE experts: ``*_codes`` and the
    (3, E, 1, 1) scales bit for bit; the deployed layer close."""
    jcfg = JMOE.MoEConfig(8, 2, 16, 1, 1.25)
    jp, tp = _moe(7, 32, jcfg)
    jq = Z.to_np(JT.quantize_params_for_serving({"moe": jp}, 8))["moe"]
    tqp = T.quantize_params_for_serving({"moe": tp}, 8)["moe"]
    assert Z.tree_bits_equal(jq, tqp) == []
    assert tqp["experts"]["w_scale"].shape == (3, 8, 1, 1)
    assert "w_gate" not in tqp["experts"]
    jx, tx = _x(8, (2, 6, 32))
    jy, _ = JMOE.apply_moe(jax.tree.map(jnp.asarray, jq), jx, jcfg, JQ(8, 8))
    (ty, _), taps = Z.run_port(
        lambda: MOE.apply_moe(tqp, tx, _tmoe(jcfg), Z.tq(JQ(8, 8))),
        Z.run_reference(lambda p, x: JMOE.apply_moe(p, x, jcfg, JQ(8, 8)),
                        jax.tree.map(jnp.asarray, jq), jx)[1])
    Z.assert_ties_only(taps, "deployed moe")
    Z.assert_close(ty, jy, "deployed moe", rtol=1e-5)


def test_init_moe_layout():
    cfg = MOE.MoEConfig(8, 2, 16, 2)
    p = MOE.init_moe(torch.Generator().manual_seed(0), 32, cfg)
    jp = jax.eval_shape(lambda: JMOE.init_moe(jax.random.key(0), 32,
                                              JMOE.MoEConfig(8, 2, 16, 2)))
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree.named_leaves(p)
    assert [(tuple(a.shape), str(a.dtype)) for _, a in jl] == \
        [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for _, b in tl]
    e = p["experts"]
    want = torch.log(e["w_up"].abs().amax((1, 2), keepdim=True))
    assert torch.allclose(e["s_w"][1], want)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_CFG = JMLA.MLAConfig(kv_lora=24, qk_nope_dim=8, qk_rope_dim=4,
                         v_head_dim=6)
TMLA_CFG = MLA.MLAConfig(24, 8, 4, 6)
H, D = 4, 32


def _mla(seed):
    jp = JMLA.init_mla(jax.random.key(seed), D, H, MLA_CFG)
    return jp, Z.port_params(jp)


@pytest.mark.parametrize("qname", list(QCFGS))
def test_mla_attention(qname):
    q = QCFGS[qname]
    jp, tp = _mla(11)
    jx, tx = _x(12, (2, 10, D))
    pos = np.arange(10, dtype=np.int32)
    (jy, (jckv, jkr)), calls = Z.run_reference(
        lambda p, x: JMLA.mla_attention(p, x, jnp.asarray(pos), H, MLA_CFG,
                                        q, q_chunk=5, kv_chunk=2), jp, jx)
    (ty, (tckv, tkr)), taps = Z.run_port(
        lambda: MLA.mla_attention(tp, tx, torch.from_numpy(pos), H, TMLA_CFG,
                                  Z.tq(q), q_chunk=5, kv_chunk=2), calls)
    Z.assert_ties_only(taps, "mla_attention")
    for got, want, name in ((ty, jy, "out"), (tckv, jckv, "ckv"),
                            (tkr, jkr, "k_rope")):
        Z.assert_close(got, want, name, rtol=1e-5)


@pytest.mark.parametrize("deployed", [False, True])
@pytest.mark.parametrize("qname", ["fp", "w8a8"])
def test_mla_decode(qname, deployed):
    """Absorbed decode of 9 tokens one by one from an empty latent cache:
    each step's output and the cache (positions exactly)."""
    q = QCFGS[qname]
    jp, tp = _mla(13)
    if deployed:
        jp = JT.quantize_params_for_serving(jp, 8)
        tp = T.quantize_params_for_serving(tp, 8)
    jx, tx = _x(14, (2, 9, D))
    jc = JMLA.init_mla_cache(2, 12, MLA_CFG, jnp.float32)
    tc = MLA.init_mla_cache(2, 12, TMLA_CFG, torch.float32, device="cpu")
    with Z.traced_reference(
            lambda p, x, c: JMLA.mla_decode(p, x, c, H, MLA_CFG, q)) as step:
        ref = []
        for i in range(9):
            (jy, jc), calls = step(jp, jx[:, i:i + 1], jc)
            ref.append((jy, jc, calls))
    for i, (jy, jc, calls) in enumerate(ref):
        (ty, tc), taps = Z.run_port(
            lambda: MLA.mla_decode(tp, tx[:, i:i + 1], tc, H, TMLA_CFG,
                                   Z.tq(q)), calls)
        Z.assert_ties_only(taps, f"mla_decode {i}")
        Z.assert_close(ty, jy, f"mla_decode {i}", rtol=1e-5)
        assert int(tc["pos"]) == int(jc["pos"]) == i + 1
        Z.assert_close(tc["ckv"], jc["ckv"], f"ckv {i}", rtol=1e-5)
        Z.assert_close(tc["k_rope"], jc["k_rope"], f"k_rope {i}", rtol=1e-5)


def test_mla_decode_equals_the_sequence_path():
    """In float, token-by-token absorbed decode gives the expanded
    sequence path's outputs (the reference's own property, on the port)."""
    _, tp = _mla(15)
    _, tx = _x(16, (1, 7, D))
    q = Z.tq(JQ())
    with torch.no_grad():
        want, _ = MLA.mla_attention(tp, tx, torch.arange(7), H, TMLA_CFG, q)
        c = MLA.init_mla_cache(1, 8, TMLA_CFG, torch.float32, device="cpu")
        outs = []
        for i in range(7):
            y, c = MLA.mla_decode(tp, tx[:, i:i + 1], c, H, TMLA_CFG, q)
            outs.append(y)
    Z.assert_close(torch.cat(outs, 1), want.numpy(), "decode == seq",
                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE archs end to end (torch_zoo_ref)
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


def test_moe_decode_capacity_is_top_k():
    """At S = 1 a dispatch group holds the whole batch (regrouping) and the
    capacity is top_k: the MoE arch's one-token decode matches the
    reference's through several steps with more slots than experts."""
    c = Z.arch_case(ARCHS[0])
    jcfg = dataclasses.replace(c.jcfg, moe_seq_chunk=4096)
    assert jcfg.pattern[1].moe is not None
    jb, tb, _ = Z.inputs(jcfg, 5, b=9, s=6)
    (jl, jc), calls = Z.run_reference(
        lambda p, b: JT.prefill(p, b, jcfg, c.jq, max_len=8), c.jparams, jb)
    (tl, tc), taps = Z.run_port(
        lambda: T.prefill(c.params, tb, c.cfg, c.q, max_len=8), calls)
    Z.assert_ties_only(taps, "prefill B=9")
    tok_j, tok_t = jnp.argmax(jl, -1), tl.argmax(-1)
    for i in range(2):
        (jl, jc), calls = Z.run_reference(
            lambda p, cc, t: JT.decode_step(p, cc, t, jcfg, c.jq),
            c.jparams, jc, tok_j.astype(jnp.int32))
        (tl, tc), taps = Z.run_port(
            lambda: T.decode_step(c.params, tc, tok_t.to(torch.int32), c.cfg,
                                  c.q), calls)
        Z.assert_ties_only(taps, f"decode B=9 {i}")
        Z.assert_close(tl, jl, f"decode B=9 {i}")
        tok_j, tok_t = jnp.argmax(jl, -1), tl.argmax(-1)
