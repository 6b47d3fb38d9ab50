"""Serving the float transformer on the port (``serve.decode.generate`` /
``make_serve_step`` and ``ContinuousBatcher``'s float default), mirroring
the reference's ``tests/test_serve.py``, plus the port against the
reference: greedy and sampled ``generate`` tokens and the batcher's tokens
equal the reference's, from its params, every quantizer code the port
rounds otherwise a rounding tie pinned to the reference's
(``torch_zoo_ref``). Greedy ``generate`` of the dense, VLM and
encoder-decoder smoke archs is here (the MoE and recurrent archs' in
``test_torch_moe_mla.py`` / ``test_torch_recurrent.py``); the batcher's
tokens equal ``generate``'s for all ten.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JQ
from repro.models import transformer as JT
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro.serve.decode import SampleConfig as JSample
from repro.serve.decode import generate as jgenerate
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.quant import QuantConfig
from repro_torch.models import transformer as T
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.decode import SampleConfig, generate, make_serve_step

import torch_zoo_ref as Z
from torch_zoo_ref import one_thread  # noqa: F401 (autouse)

JCFG = JT.TransformerConfig(
    name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=64, param_dtype=jnp.float32, max_seq=64)
CFG = T.TransformerConfig(
    name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=64, param_dtype=torch.float32, max_seq=64)
JQCFG, QCFG = JQ(8, 8), QuantConfig(8, 8)
ARCHS = ["codeqwen1.5-7b", "minicpm-2b", "minitron-4b", "llama3-405b",
         "internvl2-1b", "whisper-tiny"]

_P = {}


def _params():
    if not _P:
        jp = jax.jit(lambda k: JT.make_params(k, JCFG))(jax.random.key(0))
        _P["j"], _P["t"] = jp, Z.port_params(jp)
    return _P["j"], _P["t"]


def _toks(seed, shape):
    a = np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("sc", [(0.0, 0), (0.8, 0), (1.3, 5)],
                         ids=["greedy", "t0.8", "t1.3k5"])
def test_generate_equals_reference(sc):
    """Greedy and sampled: the Gumbel draws are the reference's bit for bit
    (``serve.decode.sample``), so are the tokens."""
    jp, tp = _params()
    jt, tt = _toks(1, (2, 8))
    with Z.jitted_prefill():
        jtok, calls = Z.run_reference(
            lambda: jgenerate(jp, JCFG, JQCFG, {"tokens": jt}, max_new=6,
                              sc=JSample(*sc), seed=3), jit=False)
    ttok, taps = Z.run_port(
        lambda: generate(tp, CFG, QCFG, {"tokens": tt}, max_new=6,
                         sc=SampleConfig(*sc), seed=3), calls)
    Z.assert_ties_only(taps, "generate")
    assert ttok.dtype == torch.int32 and ttok.shape == (2, 6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_greedy_generate_deterministic():
    _, tp = _params()
    _, tt = _toks(1, (2, 8))
    with torch.no_grad():
        out1 = generate(tp, CFG, QCFG, {"tokens": tt}, max_new=6)
        out2 = generate(tp, CFG, QCFG, {"tokens": tt}, max_new=6)
    assert torch.equal(out1, out2)


def test_serve_step_writes_the_caches_in_place():
    _, tp = _params()
    _, tt = _toks(2, (1, 5))
    with torch.no_grad():
        _, caches = T.prefill(tp, {"tokens": tt}, CFG, QCFG, max_len=8)
        _, out = make_serve_step(CFG, QCFG)(tp, caches, tt[:, -1:])
    assert out is caches and int(caches["blocks"][0]["pos"][0]) == 6


def _prompts(seeds, n=8):
    return [np.random.default_rng(i).integers(0, 64, n).tolist()
            for i in seeds]


def test_batcher_matches_single_generate():
    """Greedy continuous batching reproduces the plain generate loop."""
    _, tp = _params()
    prompts = _prompts((2, 3, 4))
    with torch.no_grad():
        singles = [generate(tp, CFG, QCFG, {"tokens": torch.tensor([p])},
                            max_new=5)[0].tolist() for p in prompts]
        b = ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=32)
        out = b.run([Request(rid=i, prompt=p, max_new=5)
                     for i, p in enumerate(prompts)])
    assert [out[i] for i in range(3)] == singles


def test_batcher_equals_reference_batcher():
    """The float default against the reference's, request for request (3
    requests on 2 slots, one refill), quantizers pinned to its record."""
    jp, tp = _params()
    prompts = _prompts((5, 6, 7))
    jreqs = [JRequest(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    with Z.jitted_prefill():
        want, calls = Z.run_reference(
            lambda: JBatcher(jp, JCFG, JQCFG, slots=2, max_len=32).run(jreqs),
            jit=False)
    got, taps = Z.run_port(
        lambda: ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=32).run(
            [Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]), calls)
    Z.assert_ties_only(taps, "batcher")
    assert got == want


def test_batcher_more_requests_than_slots():
    _, tp = _params()
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new=3) for i in range(5)]
    with torch.no_grad():
        out = ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=16).run(reqs)
    assert len(out) == 5 and all(len(v) == 3 for v in out.values())


def test_admissions_draw_distinct_keys():
    _, tp = _params()
    b = ContinuousBatcher(tp, CFG, QCFG, slots=6, max_len=16,
                          sc=SampleConfig(temperature=5.0))
    reqs = [Request(rid=i, prompt=[5, 6, 7], max_new=1) for i in range(6)]
    with torch.no_grad():
        b.run(reqs)
    firsts = [r.out[0] for r in reqs]
    assert len(firsts) == 6 and len(set(firsts)) > 1, firsts


def test_retired_slots_zeroed():
    _, tp = _params()
    b = ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=32)
    reqs = [Request(rid=i, prompt=[1, 2, 3, 4], max_new=4) for i in range(2)]
    with torch.no_grad():
        out = b.run(reqs)
    assert all(r.done for r in reqs)
    assert any(v[-1] != 0 for v in out.values()), out
    assert int(b.cur_tok.abs().sum()) == 0
    assert b.budget == [0, 0] and b.active == [None, None]


def _assert_no_admission_state(b, caches0):
    assert int(b.cur_tok.abs().sum()) == 0
    assert all(v == 0 for v in b.budget)
    assert b.active == [None] * b.slots
    assert all(torch.equal(a, c) for a, c in
               zip(tree.leaves(caches0), tree.leaves(b.caches)))


def test_admit_max_new_1_leaves_no_state():
    _, tp = _params()
    b = ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=16)
    caches0 = tree.map(torch.clone, b.caches)
    r = Request(rid=0, prompt=[1, 2, 3], max_new=1)
    with torch.no_grad():
        b.run([r])
    assert r.done and len(r.out) == 1
    _assert_no_admission_state(b, caches0)


def test_admit_prefill_eos_leaves_no_state():
    _, tp = _params()
    with torch.no_grad():
        first = int(generate(tp, CFG, QCFG,
                             {"tokens": torch.tensor([[1, 2, 3]])},
                             max_new=1)[0, 0])
        b = ContinuousBatcher(tp, CFG, QCFG, slots=2, max_len=16,
                              eos_id=first)
        caches0 = tree.map(torch.clone, b.caches)
        r = Request(rid=0, prompt=[1, 2, 3], max_new=5)
        b.run([r])
    assert r.done and r.out == [first]
    _assert_no_admission_state(b, caches0)


def test_int8_weights_generate_close_and_equal_to_reference():
    """w8 serving codes move the logits only slightly (the reference's own
    bound, 0.15 of max|logit|); greedy generate on the codes equals the
    reference's on its codes."""
    jp, tp = _params()
    jq = JT.quantize_params_for_serving(jp, 8)
    tqp = T.quantize_params_for_serving(tp, 8)
    jt, tt = _toks(9, (1, 8))
    with torch.no_grad():
        l1, _ = T.forward(tp, {"tokens": tt}, CFG, QuantConfig())
        l2, _ = T.forward(tqp, {"tokens": tt}, CFG, QuantConfig())
    assert float((l1 - l2).abs().max()) / float(l1.abs().max()) < 0.15
    with Z.jitted_prefill():
        want = jgenerate(jq, JCFG, JQCFG, {"tokens": jt}, max_new=6)
    with torch.no_grad():
        got = generate(tqp, CFG, QCFG, {"tokens": tt}, max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_generate(arch_id):
    Z.check_generate(Z.arch_case(arch_id))


MOE_ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v2-lite-16b"]


def _arch_prompts(c):
    """3 equal-length prompts (the shared scalar position needs them)."""
    return [t.tolist() for t in c.batch["tokens"][:, :4]] + \
        [c.batch["tokens"][0, 2:6].tolist()]


@pytest.mark.parametrize("arch_id",
                         [a for a in ARCH_IDS if a not in MOE_ARCHS])
def test_arch_batcher_equals_generate(arch_id):
    """Every smoke arch without MoE, on the port's own params: 3 prompts on
    2 slots give ``generate``'s tokens. The default prefills tokens alone
    (internvl's requests are text); whisper's requests carry their frames
    through a prefill_fn."""
    cfg, q = get_arch(arch_id).smoke, QuantConfig(8, 8)
    params = T.make_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    _, batch, _ = Z.inputs(cfg, 1)
    prompts = [t.tolist() for t in batch["tokens"][:, :4]] + \
        [batch["tokens"][0, 2:6].tolist()]
    feats = batch["feats"] if cfg.enc_dec else None
    max_len = Z.S + 6

    def batch_of(p):
        b = {"tokens": torch.tensor([p], dtype=torch.int32)}
        if feats is not None:
            b["feats"] = feats[:1]
        return b

    prefill_fn = None
    if cfg.enc_dec:
        def prefill_fn(params, toks):
            return T.prefill(params, dict(batch_of([0]), tokens=toks), cfg,
                             q, max_len=max_len)
    with torch.no_grad():
        singles = [generate(params, cfg, q, batch_of(p), max_new=4,
                            max_len=max_len)[0].tolist() for p in prompts]
        b = ContinuousBatcher(params, cfg, q, slots=2, max_len=max_len,
                              prefill_fn=prefill_fn)
        out = b.run([Request(rid=i, prompt=p, max_new=4)
                     for i, p in enumerate(prompts)])
    assert [out[i] for i in range(len(prompts))] == singles


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_arch_batcher_equals_reference_batcher(arch_id):
    """The MoE archs' batched decode is not ``generate``'s, in the
    reference as in the port: at S = 1 every slot's token shares one
    dispatch group (``apply_moe``'s regrouping), whose capacity
    ceil(B k cf / E) drops a token when two slots pick one expert, a dead
    lane's token included. The port's batcher gives the reference
    batcher's tokens."""
    from repro.serve.batching import ContinuousBatcher as JB
    c = Z.arch_case(arch_id)
    prompts = _arch_prompts(c)
    with Z.jitted_prefill():
        want, calls = Z.run_reference(
            lambda: JB(c.jparams, c.jcfg, c.jq, slots=2,
                       max_len=Z.S + 6).run(
                [JRequest(rid=i, prompt=p, max_new=4)
                 for i, p in enumerate(prompts)]), jit=False)
    got, taps = Z.run_port(
        lambda: ContinuousBatcher(c.params, c.cfg, c.q, slots=2,
                                  max_len=Z.S + 6).run(
            [Request(rid=i, prompt=p, max_new=4)
             for i, p in enumerate(prompts)]), calls)
    Z.assert_ties_only(taps, f"{arch_id} batcher")
    assert got == want
