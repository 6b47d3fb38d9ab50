"""The integer LM (``repro_torch.models.fq_lm``) against the JAX reference.

The reference's seeded stand-in (``fq_lm.standin_params`` ->
``convert_int``) is carried into the port with ``interop.stack_from_numpy``
(its hand-off edges and list-valued ``island_s_in`` included), at
``FQLMConfig.reduced()`` and at the full ``FQLMConfig()``. The port runs on
``device="cpu"``: K1 / K2 / the island through their plain versions.

Tolerances and counts:
  * the stack digest, ``int_core``'s codes (clean and noisy, same key) and
    KV cache codes: bit-exact;
  * logits (prefill, decode, the float ``apply``): atol 1e-5, the tolerance
    of the reference's own float-vs-int test;
  * the attention island sums in one fixed order (``kernels.lm_island``),
    XLA in its own: its outputs differ by a few float32 ulps, so the
    island's re-entry codes that differ from the reference's (given the
    same Q / K / V codes) are counted and the count pinned, as are the KV
    codes that differ downstream;
  * greedy tokens: identical, batched and unbatched, on the reference
    suite's prompts and its EOS case.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integer_inference as jii
from repro.core.noise import TABLE7_CONDITIONS as JTABLE7
from repro.models import fq_lm as JM
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro_torch import interop
from repro_torch.core import integer_inference as ii
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.lm_island import lm_island_ctx_plain, sqrt_head
from repro_torch.models import fq_lm as M
from repro_torch.serve.batching import ContinuousBatcher, Request

QCFG = M.LM_QCFG
JQCFG = JM.LM_QCFG
CFGS = {"reduced": (JM.FQLMConfig.reduced(), M.FQLMConfig.reduced(), 32),
        "full": (JM.FQLMConfig(), M.FQLMConfig(), 128)}
PROMPTS = [[1, 5, 9, 2], [7, 3], [40, 41, 42, 43, 44, 45], [0]]
# island re-entry codes that differ from the reference's, given the same
# Q / K / V codes, over the prefill of ``_tokens`` (every layer); and KV
# cache codes that differ after prefill + 3 decode steps
ISLAND_FLIPS = {"reduced": 0, "full": 0}
KV_FLIPS = {"reduced": 0, "full": 0}


def _np(tree):
    """jax arrays -> numpy, python statics (ints, strings) unchanged."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


@functools.lru_cache(maxsize=None)
def _reference(name):
    jcfg = CFGS[name][0]
    params = JM.standin_params(jax.random.key(0), jcfg)
    return params, JM.convert_int(params, jcfg, JQCFG)


@functools.lru_cache(maxsize=None)
def _carried(name):
    js = _reference(name)[1]
    return interop.stack_from_numpy(_np(js.layers), _np(js.extras), js.qcfg,
                                    js.specs, handoff_edges=js.handoff_edges,
                                    device="cpu")


def _params(name):
    """The reference's float stand-in params as port tensors."""
    p, _ = interop.params_from_numpy(_np(_reference(name)[0]), {},
                                     device="cpu")
    return p


def _tokens(name):
    jcfg = CFGS[name][0]
    rng = np.random.default_rng(3)
    return rng.integers(0, jcfg.vocab, (2, 6)).astype(np.int32)


def _assert_caches_equal(a, b):
    for i, (ca, cb) in enumerate(zip(a, b)):
        for k in ("k", "v", "pos"):
            assert torch.equal(ca[k], cb[k]), f"layer {i} cache {k!r}"


def _cache_flips(jc, tc):
    return sum(int((np.asarray(j[k]) != t[k].numpy()).sum())
               for j, t in zip(jc, tc) for k in ("k", "v"))


# ---------------------------------------------------------------------------
# the stack, the integer core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CFGS))
def test_carried_dag_stack_digest_equals_reference(name):
    js, st = _reference(name)[1], _carried(name)
    assert st.handoff_edges == js.handoff_edges
    assert len(st.handoff_edges) == len(JM.handoff_edges(CFGS[name][0]))
    assert ii.stack_digest(st) == jii.stack_digest(js)


@pytest.mark.parametrize("name", list(CFGS))
def test_port_conversion_equals_carried(name):
    """The port's own ``convert_int`` of the reference's float params makes
    the carried stack: same codes, folded scalars and digest."""
    _, tcfg, _ = CFGS[name]
    st = M.convert_int(_params(name), tcfg, QCFG)
    assert ii.stack_digest(st) == ii.stack_digest(_carried(name))


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", list(CFGS))
def test_int_core_equals_reference(name, noisy):
    jcfg, tcfg, _ = CFGS[name]
    js, st = _reference(name)[1], _carried(name)
    rng = np.random.default_rng(11)
    b, t = 2, 5
    codes = rng.integers(-127, 128, (b, t, jcfg.d_model)).astype(np.int8)
    attn = rng.integers(-127, 128, (jcfg.n_layers, b, t, jcfg.d_model)
                        ).astype(np.int8)
    kw, tkw = {}, {}
    if noisy:
        c = JTABLE7[-1]
        jk = jax.random.key(7)
        kw = dict(noise=c, rng=jk, mac_chunks=4)
        tkw = dict(noise=NoiseConfig(c.sigma_w, c.sigma_a, c.sigma_mac),
                   rng=interop.key_from_numpy(
                       np.asarray(jax.random.key_data(jk)), device="cpu"),
                   mac_chunks=4)
    want = JM.int_core(js, jnp.asarray(codes), jnp.asarray(attn), JQCFG,
                       jcfg, **kw)
    got = M.int_core(st, torch.from_numpy(codes), torch.from_numpy(attn),
                     QCFG, tcfg, **tkw)
    assert len(got) == len(want) == 1 + 3 * jcfg.n_layers
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {i}")
    if noisy:
        clean = M.int_core(st, torch.from_numpy(codes),
                           torch.from_numpy(attn), QCFG, tcfg)
        assert not torch.equal(clean[0], got[0])


# ---------------------------------------------------------------------------
# prefill, decode, the island
# ---------------------------------------------------------------------------


def _island_flips(name, st, js, toks):
    """Island re-entry codes of a prefill, port against reference, given
    the same Q / K / V codes (the port's, bit-equal to the reference's),
    layer by layer."""
    jcfg, tcfg, max_len = CFGS[name]
    b, t = toks.shape
    tt = torch.from_numpy(toks)
    x = st["embed"]["w"][tt] + st["pos"]["w"][:t][None]
    h = ii.entry_codes(x, st["entry"], QCFG, b_in=-1.0)
    _, caches = M.int_prefill(st, tt, QCFG, tcfg, max_len=max_len)
    qpos = torch.arange(t, dtype=torch.int32)[None].expand(b, t).contiguous()
    kpos = jnp.arange(max_len)
    mask = jnp.broadcast_to((kpos[None, :] <= jnp.arange(t)[:, None])[None],
                            (b, t, max_len))
    flips = total = 0
    for i in range(tcfg.n_layers):
        qc, _, _ = M._qkv(st, i, h, ii.int_linear)
        kcache, vcache = caches[i]["k"], caches[i]["v"]
        got = M._island(st, i, M.island_consts(st), qc, kcache, vcache,
                        qpos, tcfg, QCFG)
        n = js[f"wq{i}"]["n_out"]
        dh, kv = jcfg.d_head, jcfg.n_kv_heads
        ctx = JM._attention(
            JM._deq(jnp.asarray(qc.numpy()), js[f"wq{i}"]["s_out"], n),
            JM._deq(jnp.asarray(kcache.numpy()).reshape(b, max_len, kv * dh),
                    js[f"wk{i}"]["s_out"], n),
            JM._deq(jnp.asarray(vcache.numpy()).reshape(b, max_len, kv * dh),
                    js[f"wv{i}"]["s_out"], n), mask, jcfg)
        want = np.asarray(JM._island_codes(js, i, ctx, JQCFG))
        flips += int((got.numpy() != want).sum())
        total += want.size
        # the next layer from the port's own codes
        h = M._block_tail(st, i, h, got, ii.int_linear)
    return flips, total


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_reference(name):
    """Logits within 1e-5 and KV caches equal through prefill + 3 decode
    steps; island re-entry codes and KV codes that differ are counted and
    pinned."""
    jcfg, tcfg, max_len = CFGS[name]
    js, st = _reference(name)[1], _carried(name)
    toks = _tokens(name)
    lj, cj = JM.int_prefill(js, jnp.asarray(toks), JQCFG, jcfg,
                            max_len=max_len, full=True)
    lt, ct = M.int_prefill(st, torch.from_numpy(toks), QCFG, tcfg,
                           max_len=max_len, full=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    kv_flips = _cache_flips(cj, ct)
    nxt = np.argmax(np.asarray(lj)[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = JM.int_decode_step(js, cj, jnp.asarray(nxt), JQCFG, jcfg)
        lt, ct = M.int_decode_step(st, ct, torch.from_numpy(nxt), QCFG, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-5)
        for j, t in zip(cj, ct):
            np.testing.assert_array_equal(t["pos"].numpy(),
                                          np.asarray(j["pos"]))
        nxt = np.argmax(np.asarray(lj)[:, -1], -1)[:, None].astype(np.int32)
        assert np.array_equal(np.argmax(lt.numpy()[:, -1], -1)[:, None], nxt)
    kv_flips += _cache_flips(cj, ct)
    flips, total = _island_flips(name, st, js, toks)
    assert (flips, kv_flips) == (ISLAND_FLIPS[name], KV_FLIPS[name]), (
        f"{flips} of {total} island codes, {kv_flips} KV codes differ")


def _run_batched(stack, cfg, max_len, prompts, *, slots, max_new, eos_id=-1):
    pf, sf, icf = M.serve_fns(cfg, QCFG, max_len=max_len, device="cpu")
    b = ContinuousBatcher(stack, cfg, QCFG, slots=slots, max_len=max_len,
                          eos_id=eos_id, prefill_fn=pf, step_fn=sf,
                          init_caches_fn=icf)
    return b.run([Request(rid=i, prompt=p, max_new=max_new)
                  for i, p in enumerate(prompts)])


def _jrun_batched(stack, cfg, max_len, prompts, *, slots, max_new,
                  eos_id=-1):
    pf, sf, icf = JM.serve_fns(cfg, JQCFG, max_len=max_len)
    b = JBatcher(stack, cfg, JQCFG, slots=slots, max_len=max_len,
                 eos_id=eos_id, prefill_fn=pf, step_fn=sf, init_caches_fn=icf)
    return b.run([JRequest(rid=i, prompt=p, max_new=max_new)
                  for i, p in enumerate(prompts)])


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("name", list(CFGS))
def test_greedy_tokens_equal_reference(name, slots):
    """The port's batcher, its unbatched loop and the reference's batcher
    give the same greedy tokens: staggered prompts, more requests than
    slots, retire and refill mid-stream."""
    jcfg, tcfg, max_len = CFGS[name]
    js, st = _reference(name)[1], _carried(name)
    out = _run_batched(st, tcfg, max_len, PROMPTS, slots=slots, max_new=5)
    want = _jrun_batched(js, jcfg, max_len, PROMPTS, slots=slots, max_new=5)
    for i, p in enumerate(PROMPTS):
        one = M.int_generate(st, p, QCFG, tcfg, max_new=5, max_len=max_len)
        assert out[i] == one == want[i], (slots, i, out[i], one, want[i])


@pytest.mark.parametrize("name", list(CFGS))
def test_eos_tokens_equal_reference(name):
    """EOS retirement (mid-decode and at prefill), the EOS taken from a
    trajectory, token for token the reference's."""
    jcfg, tcfg, max_len = CFGS[name]
    js, st = _reference(name)[1], _carried(name)
    probe = M.int_generate(st, PROMPTS[0], QCFG, tcfg, max_new=5,
                           max_len=max_len)
    eos = probe[2]
    out = _run_batched(st, tcfg, max_len, PROMPTS, slots=2, max_new=6,
                       eos_id=eos)
    want = _jrun_batched(js, jcfg, max_len, PROMPTS, slots=2, max_new=6,
                         eos_id=eos)
    for i, p in enumerate(PROMPTS):
        ref = JM.int_generate(js, p, JQCFG, jcfg, max_new=6, max_len=max_len,
                              eos_id=eos)
        assert out[i] == want[i] == ref, (i, out[i], want[i], ref)
        assert len(out[i]) <= 6
    assert out[0][-1] == eos and len(out[0]) < 6


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", list(CFGS))
def test_float_apply_equals_reference(name, noisy):
    jcfg, tcfg, _ = CFGS[name]
    toks = _tokens(name)
    kw, tkw = {}, {}
    if noisy:
        c = JTABLE7[-1]
        jk = jax.random.key(5)
        kw = dict(noise=c, rng=jk)
        tkw = dict(noise=NoiseConfig(c.sigma_w, c.sigma_a, c.sigma_mac),
                   rng=interop.key_from_numpy(
                       np.asarray(jax.random.key_data(jk)), device="cpu"))
    want = JM.apply(_reference(name)[0], jnp.asarray(toks), JQCFG, jcfg, **kw)
    got = M.apply(_params(name), torch.from_numpy(toks), QCFG, tcfg, **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference suite's cases, on the port alone
# ---------------------------------------------------------------------------


def test_int_linear_seam_equals_plain_oracle():
    """``int_linear`` (the K2 wrapper) and ``int_linear_ref`` (K2's plain
    version, through the ``linear=`` seam) give the same logits and KV
    codes through prefill + 3 decode steps."""
    _, tcfg, max_len = CFGS["reduced"]
    st = _carried("reduced")
    toks = torch.tensor([[1, 5, 9, 2], [40, 41, 42, 43]], dtype=torch.int32)
    lk, ck = M.int_prefill(st, toks, QCFG, tcfg, max_len=max_len)
    lr, cr = M.int_prefill(st, toks, QCFG, tcfg, max_len=max_len,
                           linear=M.int_linear_ref)
    assert torch.equal(lk, lr)
    _assert_caches_equal(ck, cr)
    for _ in range(3):
        nxt = torch.argmax(lk[:, -1], -1)[:, None].to(torch.int32)
        lk, ck = M.int_decode_step(st, ck, nxt, QCFG, tcfg)
        lr, cr = M.int_decode_step(st, cr, nxt, QCFG, tcfg,
                                   linear=M.int_linear_ref)
        assert torch.equal(lk, lr)
        _assert_caches_equal(ck, cr)


@pytest.mark.parametrize("name", list(CFGS))
def test_kv_append_commutes_with_quantizer(name):
    """prefill(T) + decode == prefill(T + 1): caches and logits bit for
    bit (the island's order does not depend on Tq)."""
    _, tcfg, max_len = CFGS[name]
    st = _carried(name)
    pre, nxt = [3, 17, 8, 25], 11
    logits, caches = M.int_prefill(st, torch.tensor([pre], dtype=torch.int32),
                                   QCFG, tcfg, max_len=max_len)
    l_step, c_step = M.int_decode_step(
        st, caches, torch.tensor([[nxt]], dtype=torch.int32), QCFG, tcfg)
    l_full, c_full = M.int_prefill(
        st, torch.tensor([pre + [nxt]], dtype=torch.int32), QCFG, tcfg,
        max_len=max_len, full=True)
    _assert_caches_equal(c_step, c_full)
    assert torch.equal(l_step, l_full[:, -1:])


def test_decode_step_functional_unless_inplace():
    _, tcfg, max_len = CFGS["reduced"]
    st = _carried("reduced")
    _, caches = M.int_prefill(st, torch.tensor([[3, 4]], dtype=torch.int32),
                              QCFG, tcfg, max_len=max_len)
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    tok = torch.tensor([[9]], dtype=torch.int32)
    l1, new = M.int_decode_step(st, caches, tok, QCFG, tcfg)
    _assert_caches_equal(caches, before)
    l2, same = M.int_decode_step(st, caches, tok, QCFG, tcfg, inplace=True)
    assert torch.equal(l1, l2) and same[0] is caches[0]
    _assert_caches_equal(caches, new)


def test_decode_past_max_len_drops_the_write():
    """A slot at max_len (a retired lane) writes nothing and raises
    nothing: the reference's scatter drops out-of-range writes."""
    _, tcfg, _ = CFGS["reduced"]
    st = _carried("reduced")
    _, caches = M.int_prefill(st, torch.tensor([[3, 4, 5, 6]],
                                               dtype=torch.int32),
                              QCFG, tcfg, max_len=4)
    _, new = M.int_decode_step(st, caches, torch.tensor([[9]],
                                                        dtype=torch.int32),
                               QCFG, tcfg)
    for c, n in zip(caches, new):
        assert torch.equal(c["k"], n["k"]) and torch.equal(c["v"], n["v"])
        assert int(n["pos"][0]) == 5


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_batched_matches_unbatched_across_slots(slots):
    _, tcfg, max_len = CFGS["reduced"]
    st = _carried("reduced")
    out = _run_batched(st, tcfg, max_len, PROMPTS, slots=slots, max_new=5)
    for i, p in enumerate(PROMPTS):
        assert out[i] == M.int_generate(st, p, QCFG, tcfg, max_new=5,
                                        max_len=max_len)


@pytest.mark.parametrize("name", list(CFGS))
def test_float_vs_int_logits_close(name):
    _, tcfg, max_len = CFGS[name]
    toks = torch.tensor([[1, 5, 9, 2], [7, 3, 40, 0]], dtype=torch.int32)
    fl = M.apply(_params(name), toks, QCFG, tcfg)
    il, _ = M.int_prefill(_carried(name), toks, QCFG, tcfg, max_len=max_len,
                          full=True)
    np.testing.assert_allclose(fl.detach().numpy(), il.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(torch.argmax(fl, -1), torch.argmax(il, -1))


def test_convert_rejects_unsynced_dag():
    _, tcfg, _ = CFGS["reduced"]
    broken = dict(_params("reduced"))
    broken["wo1"] = {**broken["wo1"], "s_out": torch.tensor(0.9)}
    with pytest.raises(ValueError, match="hand-off contract"):
        ii.convert_stack(broken, QCFG, specs=M.layer_specs(tcfg),
                         extras=M.int_extras(broken, tcfg),
                         handoff_edges=M.handoff_edges(tcfg))


def test_convert_rejects_mismatched_denominators():
    _, tcfg, _ = CFGS["reduced"]
    with pytest.raises(ValueError, match="denominator"):
        M.convert_int(_params("reduced"), tcfg, QuantConfig(8, 8, 4, fq=True))


def test_rederive_and_placement_keep_the_edges():
    _, tcfg, _ = CFGS["reduced"]
    st = _carried("reduced")
    re = st.rederive(M.sync_scales(_params("reduced"), tcfg))
    assert re.handoff_edges == st.handoff_edges
    assert ii.stack_digest(re) == ii.stack_digest(st)
    for placed in [ii.place_stack(st, "cpu")] + ii.replicate_stack(
            st, ["cpu", "cpu"]):
        assert placed.handoff_edges == st.handoff_edges
        assert ii.stack_digest(placed) == ii.stack_digest(st)
    with pytest.raises(ValueError, match="hand-off contract"):
        broken = dict(_params("reduced"))
        broken["up0"] = {**broken["up0"], "s_in": torch.tensor(0.1)}
        st.rederive(broken)


def test_digest_changes_with_the_edges():
    """The digest folds the edge topology in; a chain stack (edges None)
    hashes as before edges existed, so recorded digests stay valid."""
    st = _carried("reduced")
    chain = ii.ConvertedStack(st.qcfg, st.specs, st.layers, st.extras)
    assert ii.stack_digest(chain) != ii.stack_digest(st)
    js = _reference("reduced")[1]
    jchain = jii.ConvertedStack(js.qcfg, js.specs, js.layers, js.extras,
                                handoff_edges=None)
    assert ii.stack_digest(chain) == jii.stack_digest(jchain)
    fewer = ii.ConvertedStack(st.qcfg, st.specs, st.layers, st.extras,
                              handoff_edges=st.handoff_edges[:-1])
    assert ii.stack_digest(fewer) != ii.stack_digest(st)


def test_int_residual_add_saturates_like_reference():
    a = np.array([-127, -100, 0, 100, 127, 60], np.int8)
    b = np.array([-127, -100, 5, 100, 1, 60], np.int8)
    want = np.asarray(jii.int_residual_add(jnp.asarray(a), jnp.asarray(b),
                                           n_out=127))
    got = ii.int_residual_add(torch.from_numpy(a), torch.from_numpy(b),
                              n_out=127)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ii.int_residual_add(torch.from_numpy(a), torch.from_numpy(b),
                            n_out=127, lo=0).numpy(),
        np.asarray(jii.int_residual_add(jnp.asarray(a), jnp.asarray(b),
                                        n_out=127, lo=0)))


def test_sync_handoff_edges_equals_reference():
    jcfg, tcfg, _ = CFGS["reduced"]
    jp = JM.init_params(jax.random.key(1), jcfg)
    tp, _ = interop.params_from_numpy(_np(jp), {}, device="cpu")
    want = jii.sync_handoff_edges(jp, JM.handoff_edges(jcfg))
    got = ii.sync_handoff_edges(tp, M.handoff_edges(tcfg))
    for name in M.proj_names(tcfg):
        for k in ("s_in", "s_out"):
            assert float(got[name][k]) == float(want[name][k]), (name, k)
    assert got is not tp


def test_batcher_requires_the_model_functions():
    """The batcher's defaults serve the float transformer; the integer LM
    must hand over its own functions (``serve_fns``)."""
    with pytest.raises(TypeError, match="serve_fns"):
        ContinuousBatcher(_carried("reduced"), CFGS["reduced"][1], QCFG,
                          slots=2, max_len=8)


def test_port_standin_converts_with_live_codes():
    """The port's own seeded stand-in (init_params -> standin_params ->
    convert_int, as chip_smoke.py builds it) converts, and no projection's
    output codes are all zero."""
    _, tcfg, max_len = CFGS["reduced"]
    p = M.standin_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    st = M.convert_int(p, tcfg, QCFG)
    toks = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)
    x = st["embed"]["w"][toks] + st["pos"]["w"][:5][None]
    h = ii.entry_codes(x, st["entry"], QCFG, b_in=-1.0)
    attn = torch.stack([h] * tcfg.n_layers)
    outs = M.int_core(st, h, attn, QCFG, tcfg)
    assert all(bool(o.any()) for o in outs)
    logits, _ = M.int_prefill(st, toks, QCFG, tcfg, max_len=max_len)
    assert logits.shape == (1, 1, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the island's plain version is shape-invariant
# ---------------------------------------------------------------------------


def _island_inputs(b, tq, length, seed=0):
    rng = np.random.default_rng(seed)
    kv, g, dh = 2, 2, 16
    q = torch.from_numpy(rng.integers(-127, 128, (b, tq, kv * g * dh)
                                      ).astype(np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (b, length, kv, dh)
                                      ).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (b, length, kv, dh)
                                      ).astype(np.int8))
    scales = torch.tensor([0.7, 1.3, 0.9], dtype=torch.float32)
    return q, k, v, scales


def _plain(q, k, v, scales, qpos):
    """The island's float context (before the re-entry quantizer)."""
    return lm_island_ctx_plain(q, k, v, scales, qpos.to(torch.int32), n=127,
                               n_heads=4, sqrt_dh=sqrt_head(16))


def test_island_plain_row_does_not_depend_on_batch_or_tq():
    q, k, v, s = _island_inputs(3, 5, 32)
    qpos = torch.tensor([[0, 4, 9, 17, 31]] * 3)
    full = _plain(q, k, v, s, qpos)
    for bi in range(3):
        for t in range(5):
            one = _plain(q[bi:bi + 1, t:t + 1], k[bi:bi + 1], v[bi:bi + 1],
                         s, qpos[bi:bi + 1, t:t + 1])
            assert torch.equal(one[0, 0], full[bi, t]), (bi, t)


def test_island_plain_masked_keys_contribute_nothing():
    """A row's output does not depend on what the masked keys hold, nor on
    how many there are (the cache's length past the row's position)."""
    q, k, v, s = _island_inputs(2, 3, 32, seed=1)
    qpos = torch.tensor([[2, 5, 11], [0, 7, 13]])
    base = _plain(q, k, v, s, qpos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 14:] = 77
    v2[:, 14:] = -33
    assert torch.equal(_plain(q, k2, v2, s, qpos), base)
    assert torch.equal(_plain(q, k[:, :16], v[:, :16], s, qpos), base)


def test_island_plain_against_reference_attention():
    """The plain island against the reference's ``_attention`` on the same
    dequantized values: within a few float32 ulps (XLA sums in another
    order)."""
    jcfg = JM.FQLMConfig()
    q, k, v, s = _island_inputs(2, 4, 24, seed=2)
    qpos = torch.tensor([[3, 8, 15, 23], [0, 1, 2, 3]])
    got = _plain(q, k, v, s, qpos).numpy()

    def deq(c, e):
        return np.float32(e) * (c.numpy().astype(np.float32) / 127)

    mask = jnp.asarray((np.arange(24)[None, None, :]
                        <= qpos.numpy()[:, :, None]))
    want = np.asarray(JM._attention(
        jnp.asarray(deq(q, s[0])), jnp.asarray(deq(k, s[1]).reshape(2, 24, 32)),
        jnp.asarray(deq(v, s[2]).reshape(2, 24, 32)), mask, jcfg))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
