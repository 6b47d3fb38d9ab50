"""``repro_torch.serve.decode`` (``SampleConfig``, ``sample``, ``gumbel``)
and ``core.quant.log`` against the JAX reference.

``quant.log`` is XLA's float32 log on the CPU; it is held bit for bit
against ``jnp.log`` over every float32 of bands of 2^16 consecutive values
spread across [FLT_MIN, 1] (the Gumbel draws' first log) and [e^-12, e^8]
(their second, and init-time scales), and at the edges (0, denormals,
negatives, inf, NaN: a NaN is only checked to be a NaN). With it the
Gumbel draws are ``jax.random.gumbel``'s bit for bit, and so are greedy,
temperature and top-k tokens for seeded keys, alone and through the
batcher (the LM of ``test_torch_fq_lm.py``, reduced, sampled at
temperature 0.8, top-k 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import fq_lm as JM
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro.serve.decode import SampleConfig as JSampleConfig
from repro.serve.decode import sample as jsample
from repro_torch import interop
from repro_torch.core import prng, quant
from repro_torch.models import fq_lm as M
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.serve.decode import SampleConfig, gumbel, sample

F32 = np.float32
TINY = float(np.finfo(F32).tiny)
# start of each band, as a float32 value: its 2^16 successors are probed
BANDS = [TINY, 1e-30, 1e-20, 3e-12, 1.2e-7, 1e-4, 0.3, 0.7071067, 0.9999,
         np.exp(-12), np.exp(-3), 1.0, 1.41421, 7.5, np.exp(5), 2900.0]
SAMPLE_CONFIGS = [(0.0, 0), (1.0, 0), (0.7, 0), (1.3, 5), (0.5, 1)]


def _bits_equal(got, want):
    """float32 arrays equal bit for bit, NaNs compared as NaNs."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    return got[~nan].view(np.int32), want[~nan].view(np.int32)


@pytest.mark.parametrize("start", BANDS, ids=[f"{b:.3g}" for b in BANDS])
def test_log_is_xla_log_bit_for_bit(start):
    first = np.array([start], F32).view(np.int32)[0]
    x = (first + np.arange(1 << 16, dtype=np.int32)).view(F32)
    got, want = _bits_equal(quant.log(torch.from_numpy(x)).numpy(),
                            np.asarray(jnp.log(x)))
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (f"{bad.size} of {x.size} differ, first at "
                           f"{x[bad[:3]]}")


def test_log_edges_and_random_inputs():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, -0.0, 1e-40, -1e-40, -1.0, np.inf, -np.inf, np.nan,
                  1.0, TINY, np.finfo(F32).max], F32),
        np.exp(rng.uniform(-87.3, 88.7, 100_000)).astype(F32)])
    got, want = _bits_equal(quant.log(torch.from_numpy(x)).numpy(),
                            np.asarray(jnp.log(x)))
    assert np.array_equal(got, want)
    # torch's own log, the CPU's correctly rounded one, is not XLA's (C11)
    assert not np.array_equal(torch.log(torch.from_numpy(x[11:])).numpy(),
                              np.asarray(jnp.log(x[11:])))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_gumbel_is_jax_gumbel(seed):
    jk = jax.random.fold_in(jax.random.key(0), seed)
    want = np.asarray(jax.random.gumbel(jk, (4, 256)))
    got = gumbel(prng.fold_in(prng.PRNGKey(0), seed), (4, 256)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("temperature,top_k", SAMPLE_CONFIGS)
def test_sample_tokens_equal_reference(temperature, top_k):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    for draw in range(16):
        logits = (rng.standard_normal((3, 2, 64)) * 3).astype(F32)
        jk = jax.random.fold_in(jax.random.key(0), draw)
        want = np.asarray(jsample(jk, jnp.asarray(logits),
                                  JSampleConfig(temperature, top_k)))
        got = sample(prng.fold_in(prng.PRNGKey(0), draw),
                     torch.from_numpy(logits),
                     SampleConfig(temperature, top_k))
        assert got.dtype == torch.int32 and got.shape == (3, 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[[1.0, 3.0, 3.0, 2.0]], [[5.0, 5.0, 5.0, 5.0]]])
    want = np.asarray(jsample(jax.random.key(0), jnp.asarray(logits.numpy()),
                              JSampleConfig()))
    np.testing.assert_array_equal(
        sample(prng.PRNGKey(0), logits, SampleConfig()).numpy(), want)
    assert sample(prng.PRNGKey(0), logits, SampleConfig()).tolist() == \
        [[1], [0]]


def _np(tree):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


@pytest.mark.parametrize("slots", [1, 3])
def test_sampled_batcher_tokens_equal_reference(slots):
    """The batcher's key schedule (``fold_in(PRNGKey(0), draw)`` per
    admission and per step) and sampled tokens, against the reference's
    batcher, on the reduced integer LM."""
    jcfg, tcfg, max_len = JM.FQLMConfig.reduced(), M.FQLMConfig.reduced(), 32
    js = JM.convert_int(JM.standin_params(jax.random.key(0), jcfg), jcfg,
                        JM.LM_QCFG)
    st = interop.stack_from_numpy(_np(js.layers), _np(js.extras), js.qcfg,
                                  js.specs, handoff_edges=js.handoff_edges,
                                  device="cpu")
    prompts = [[1, 5, 9, 2], [7, 3], [40, 41, 42, 43, 44, 45], [0]]
    jpf, jsf, jicf = JM.serve_fns(jcfg, JM.LM_QCFG, max_len=max_len)
    jb = JBatcher(js, jcfg, JM.LM_QCFG, slots=slots, max_len=max_len,
                  sc=JSampleConfig(0.8, 8), prefill_fn=jpf, step_fn=jsf,
                  init_caches_fn=jicf)
    want = jb.run([JRequest(rid=i, prompt=p, max_new=5)
                   for i, p in enumerate(prompts)])
    pf, sf, icf = M.serve_fns(tcfg, M.LM_QCFG, max_len=max_len, device="cpu")
    b = ContinuousBatcher(st, tcfg, M.LM_QCFG, slots=slots, max_len=max_len,
                          sc=SampleConfig(0.8, 8), prefill_fn=pf, step_fn=sf,
                          init_caches_fn=icf)
    got = b.run([Request(rid=i, prompt=p, max_new=5)
                 for i, p in enumerate(prompts)])
    assert got == want
    assert b._draws == jb._draws
