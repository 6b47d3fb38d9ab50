"""The QAT trainer of the port (``train.trainer``), ``prng.randint`` and the
synthetic datasets (``data.synthetic``) against the JAX reference.

Tolerances, stated beside each assert:

  * ``prng.randint`` and the datasets' labels: bit-exact;
  * the datasets' features: normals differ from jax's by a few ulp in ~5%
    of draws (C4), so 4 ulp of the largest |x| (the draws are scaled and
    summed in float32);
  * ``global_norm``: a float32 sum of squares in another order, 1e-6
    relative; ``clip_by_global_norm``: the clipped leaves of the same
    gradients within 1e-6 relative;
  * a QAT train step from the same params on both sides (the reference's
    step body run eagerly, C-ref-3; the surrogate's quantizer inputs that
    part from the reference's pinned to them with ``repro_torch.taps``, as
    ``test_torch_deploy_qat`` holds the gradients): the loss within 1e-5
    relative, the norm before clipping within 1e-4 relative (the gradients
    are held at 1e-4 relative L2 there);
    each weight's update within 1e-3 of the update's own norm, each
    log-scale's within 1.9 lr x the clip factor x 1e-5 M (its gradient's
    bound there, M from ``repro_torch.taps``, through Nesterov's 1 + 0.9),
    each plus 1e-6 of the leaf's norm (float32 rounding of the parameter);
  * ``QATFinetune``: each step's batch, noise key and step index equal the
    reference's; run 1 + 2 steps and 3 steps give equal params, bit for
    bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import trained_int_params
from repro.core import deploy_qat as jdq
from repro.core import distill as jdistill
from repro.core.noise import TABLE7_CONDITIONS as JCONDS
from repro.core.quant import QuantConfig as JQuantConfig
from repro.data import synthetic as jsyn
from repro.models import kws as jkws
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro.train import trainer as jtrainer
from repro_torch import interop, tree
from repro_torch.core import deploy_qat as tdq
from repro_torch.core import distill as tdistill
from repro_torch.core import prng
from repro_torch.core.quant import QuantConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.models import kws as tkws
from repro_torch.optim import schedules as tsched
from repro_torch.optim import sgd as tsgd
from repro_torch.taps import Taps, recorded
from repro_torch.taps import value_and_grad as taps_value_and_grad
from repro_torch.train import trainer as ttrainer
from test_torch_fq_layers import C_S, port_noise, reference_taps

JQCFG = JQuantConfig(2, 4, 4, fq=True)
QCFG = QuantConfig(2, 4, 4, fq=True)
NOISY = JCONDS[-1]
JCFG, TCFG = jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced()


def _np(t):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, t)


def _key(seed):
    return prng.PRNGKey(seed, device="cpu")


# ---------------------------------------------------------------------------
# prng.randint, the datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("span", [1, 2, 7, 2 ** 16 + 3, 2 ** 31 - 1])
def test_randint_is_jax_randint(span):
    """Spans 1 to 2^31 - 1 (the multiplier's square wraps past 2^16),
    shapes () to (4096,), positive and negative bounds, two seeds."""
    for seed in (0, 2024):
        for lo in (0, -3) if span < 2 ** 31 - 1 else (0,):
            for shape in ((), (1,), (5, 3), (4096,)):
                want = np.asarray(jax.random.randint(
                    jax.random.PRNGKey(seed), shape, lo, lo + span))
                got = prng.randint(_key(seed), shape, lo, lo + span)
                assert got.shape == want.shape
                np.testing.assert_array_equal(got.numpy(), want)


def test_randint_empty_span_gives_minval():
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (6,), 4, 2))
    got = prng.randint(_key(1), (6,), 4, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 4).all()


def _c4(got, want):
    """Labels bit-exact; features within 4 ulp of the largest |x| (C4)."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    x = np.asarray(want[0])
    assert got[0].shape == x.shape
    np.testing.assert_allclose(got[0].numpy(), x, rtol=0,
                               atol=4 * np.spacing(np.abs(x).max()))


def test_mfcc_dataset_matches_reference():
    kw = dict(n=96, seq_len=24, n_mfcc=8, num_classes=4)
    _c4(tsyn.make_mfcc_dataset(_key(3), **kw),
        jsyn.make_mfcc_dataset(jax.random.key(3), **kw))


def test_image_dataset_matches_reference():
    kw = dict(n=40, shape=(16, 16, 3), num_classes=16)
    _c4(tsyn.make_image_dataset(_key(4), **kw),
        jsyn.make_image_dataset(jax.random.key(4), **kw))


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------


def _grad_tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((5, 7)) * scale).astype(
        np.float32), "s": np.float32(rng.standard_normal() * scale)},
        "b": (rng.standard_normal(11) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [1e-3, 0.1, 10.0])
def test_global_norm_and_clip_match_reference(scale):
    """Below and above the clip norm 1 (scale 1e-3 is not clipped)."""
    g = _grad_tree(0, scale)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = tree.map(lambda v: torch.from_numpy(np.array(v, copy=True)), g)
    want_n = float(jtrainer.global_norm(jg))
    got_n = ttrainer.global_norm(tg)
    assert got_n.dtype == torch.float32
    assert abs(float(got_n) - want_n) <= 1e-6 * want_n
    jc, jn = jtrainer.clip_by_global_norm(jg, 1.0)
    tc, tn = ttrainer.clip_by_global_norm(tg, 1.0)
    assert float(tn) == float(got_n)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree.leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)
    if scale < 0.01:     # not clipped: the gradients unchanged, bit for bit
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tc),
                                                     tree.leaves(tg)))


# ---------------------------------------------------------------------------
# The QAT train step and QATFinetune
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _standin():
    jp, js, _ = trained_int_params(jkws, JCFG, jkws.conv_names(JCFG), JQCFG)
    return jp, js


def _ref_loss(js):
    def loss_fn(p, batch, rng):
        xb, yb = batch
        logits = jkws.qat_apply(p, js, xb, JQCFG, JCFG, impl="im2col",
                                noise=NOISY, rng=rng)
        onehot = jax.nn.one_hot(yb, JCFG.num_classes)
        return jnp.mean(jdistill.softmax_cross_entropy(logits, onehot))
    return loss_fn


def _port_loss(ts):
    def loss_fn(p, batch, rng):
        xb, yb = batch
        logits = tkws.qat_apply(p, ts, xb, QCFG, TCFG, noise=port_noise(NOISY),
                                rng=rng)
        onehot = torch.nn.functional.one_hot(yb.long(),
                                             TCFG.num_classes).float()
        return torch.mean(tdistill.softmax_cross_entropy(logits, onehot))
    return loss_fn


def test_two_qat_train_steps_match_reference():
    """The reference's QAT train-step smoke (two steps of SGD at lr 0.01,
    clip 1.0, Table 7's noisiest condition, a train_step_key per step), the
    port's step taken from the reference's params each step."""
    jp, js = _standin()
    ts = interop.params_from_numpy(_np(js), {}, device="cpu")[0]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((8, JCFG.seq_len, JCFG.n_mfcc)).astype(
        np.float32)
    y = rng.integers(0, JCFG.num_classes, 8).astype(np.int32)
    jopt = jsgd.make(jsched.constant(0.01))
    topt = tsgd.make(tsched.constant(0.01))
    # the reference's step body, eagerly (its jit moves float edges by an
    # ulp, C-ref-3)
    jstep = jtrainer.make_qat_train_step(_ref_loss(js), jopt,
                                         clip_norm=1.0).__wrapped__
    tstep = ttrainer.make_qat_train_step(_port_loss(ts), topt, clip_norm=1.0)
    jost = jopt.init(jp)
    base = jax.random.key(33)
    tbase = interop.key_from_numpy(np.asarray(jax.random.key_data(base)),
                                   device="cpu")
    for i in range(2):
        tp, tost = interop.params_from_numpy(_np(jp), _np(jost),
                                             device="cpu")
        jk = jdq.train_step_key(base, i)
        tk = tdq.train_step_key(tbase, i)
        np.testing.assert_array_equal(tk.numpy(),
                                      np.asarray(jax.random.key_data(jk)))
        with reference_taps() as rtaps:
            jnew, jost, jm = jstep(jp, jost, (jnp.asarray(x),
                                              jnp.asarray(y)),
                                   jnp.int32(i), jk)
            jax.block_until_ready(jnew)
        ref = recorded(calls=[np.array(a, copy=True) for a in rtaps])
        tbatch = (torch.from_numpy(x), torch.from_numpy(y))
        with Taps(ref) as pinned:
            tnew, _, tm = tstep(tp, tost, tbatch, i, tk)
        pinned.matched()
        assert pinned.code_flips <= 1e-4 * pinned.positions
        taps = Taps(ref)   # M of each log-scale's gradient
        taps_value_and_grad(lambda p: (_port_loss(ts)(p, tbatch, tk), None),
                            tp, taps)
        clip = min(1.0, 1.0 / float(jm["grad_norm"]))
        assert np.isfinite(float(jm["loss"]))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
        jflat = dict(tree.named_leaves(_np(jnew)))
        jold = dict(tree.named_leaves(_np(jp)))
        for name, b in tree.named_leaves(tnew):
            a, a0 = jflat[name], jold[name]
            err = np.linalg.norm(b.numpy() - a)
            if name.rsplit(".", 1)[-1].startswith("s_"):
                bound = 1.9 * 0.01 * clip * C_S * taps.mag.get(name, 0.0)
            else:
                bound = 1e-3 * np.linalg.norm(a - a0)
            bound += 1e-6 * max(np.linalg.norm(a0), 1.0)
            assert err <= bound, (i, name, err, bound)
        jp = jnew
    assert not np.array_equal(np.asarray(jp["conv0"]["w"]),
                              np.asarray(_standin()[0]["conv0"]["w"]))


def _data():
    """The reference's dataset, and the same numbers as tensors."""
    xtr, ytr = jsyn.make_mfcc_dataset(
        jax.random.key(5), n=24, seq_len=JCFG.seq_len, n_mfcc=JCFG.n_mfcc,
        num_classes=JCFG.num_classes)
    return (xtr, ytr), (torch.from_numpy(np.array(xtr)),
                        torch.from_numpy(np.array(ytr)))


def _port_finetune(steps, batch=4, seed=3):
    """The port's QATFinetune of the stand-in over the carried dataset."""
    jp, js = _standin()
    tp, ts = interop.params_from_numpy(_np(jp), _np(js), device="cpu")
    return ttrainer.QATFinetune(_port_loss(ts), tp,
                                tsgd.make(tsched.constant(0.01)),
                                data=_data()[1], steps=steps, batch=batch,
                                seed=seed)


def test_qat_finetune_schedule_matches_reference():
    """Step i's batch (sampled with randint(fold_in(base, 2 i))) and noise
    key (train_step_key(base, 2 i + 1)) are the reference's: both
    finetunes' step functions recorded (the reference's not run: its
    schedule does not depend on the params)."""
    jp, js = _standin()
    jdata, _ = _data()
    jft = jtrainer.QATFinetune(_ref_loss(js), jp,
                               jsgd.make(jsched.constant(0.01)), data=jdata,
                               steps=3, batch=4, seed=3)
    tft = _port_finetune(steps=3)
    jb, tb = [], []

    def jstep(params, opt_state, batch, i, rng):
        jb.append((np.asarray(batch[0]), np.asarray(batch[1]),
                   np.asarray(jax.random.key_data(rng)), int(i)))
        return params, opt_state, {"loss": jnp.float32(0)}
    jft._step_fn = jstep
    orig = tft._step_fn

    def tstep(params, opt_state, batch, i, rng):
        tb.append((batch[0].numpy(), batch[1].numpy(), rng.numpy(), i))
        return orig(params, opt_state, batch, i, rng)
    tft._step_fn = tstep
    jft.run()
    tft.step(1)
    tft.step(2)
    assert jft.done and tft.done and tft.steps_done == 3
    assert np.isfinite(tft.last_loss)
    assert len(jb) == len(tb) == 3
    for want, got in zip(jb, tb):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


def test_qat_finetune_resumes_bit_exactly():
    """Advanced 1 + 2 steps, a finetune's params equal one run of 3 steps,
    bit for bit (the schedule is a pure function of (seed, i))."""
    a, b = _port_finetune(steps=3), _port_finetune(steps=3)
    a.step(1)
    assert not a.done
    a.step(2)
    b.run()
    assert a.done and b.done and a.last_loss == b.last_loss
    assert all(torch.equal(u, v) for u, v in zip(tree.leaves(a.params),
                                                 tree.leaves(b.params)))
    assert b.step(5) == {"steps_done": 3, "loss": b.last_loss}
