"""The zoo's LM train step on the port against the reference, for all ten
archs at their SMOKE configs (float32, remat off; see
``tests/test_torch_train_lm.py``).

* ``make_train_step`` (AdamW, weight decay 0.1, clipping at 1.0), one
  step from the reference's params and a fresh state: the metrics (loss,
  ce, aux, the global norm before clipping) within 1e-5 relative; the new
  moments and params against the reference's (bounds below);
* ``make_grad_fn`` with grad_accum 2 against the reference's, and against
  grad_accum 1 on the port (the reference's ``test_grad_accum_equivalent``).

The reference's jitted step records its quantizer inputs and the port runs
pinned to them (``repro_torch.taps``); every code it rounds otherwise must be
a rounding tie.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_ref as Z
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro.train import trainer as JTR
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer as T
from repro_torch.optim import adam, schedules
from repro_torch.taps import Taps, recorded
from repro_torch.train import trainer

one_thread = Z.one_thread
LR = 1e-3
STEP = 3             # the WSD plateau: lr = LR
# Adam's first step moves each param by lr (m / c1) / (sqrt(v / c2) + eps)
# = lr g / (|g| + eps): the gradients' float32 differences move it where
# |g| is within them of 0. A param therefore within this many lr of the
# reference's, and the moments m, v within 1e-4 relative L2 (1e-3 for v,
# whose terms are squares of the gradients' differences' carriers).
PARAM_LR = 2.0


def _opts():
    kw = dict(weight_decay=0.1)
    return (jadam.make(jsched.wsd(LR, 20), **kw),
            adam.make(schedules.wsd(LR, 20), **kw))


def _pinned(calls, fn):
    taps = Taps(recorded(calls=calls))
    with taps:
        out = fn()
    taps.matched()
    return out, taps


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_step(arch_id):
    c = Z.arch_case(arch_id)
    jcfg, cfg = Z.no_remat(c)
    jb, tb = Z.with_labels(c, 21)
    jopt, topt = _opts()
    jstep = JTR.make_train_step(jcfg, c.jq, jopt, JTR.TrainConfig())
    js0 = jopt.init(c.jparams)
    (jp, js, jm), calls = Z.reference_grad(
        c, lambda p, s, b: jstep(p, s, b, jnp.int32(STEP)),
        lambda p, s, b: JT.loss_fn(p, b, jcfg, c.jq), c.jparams, js0, jb)
    step = trainer.make_train_step(cfg, c.q, topt, trainer.TrainConfig(),
                                   device="cpu")
    params = tree.map(torch.clone, c.params)
    (tp, ts, tm), taps = _pinned(
        calls, lambda: step(params, topt.init(params), tb, STEP))
    Z.assert_ties_only(taps, f"{arch_id} train step")
    assert sorted(tm) == sorted(jm)
    Z.assert_metrics_close(jm, tm, arch_id)
    assert int(ts["count"]) == int(js["count"]) == 1
    bad = []
    for (_, a), (name, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            tree.named_leaves(tp)):
        err = float(np.abs(b.double().numpy() - np.asarray(a)).max())
        if err > PARAM_LR * LR:
            bad.append((name, err))
    assert not bad, bad[:8]
    for k, rtol in (("m", Z.GRAD_RTOL), ("v", 10 * Z.GRAD_RTOL)):
        jl = [x[k] for x in jax.tree.leaves(
            js["mom"], is_leaf=lambda x: isinstance(x, dict) and k in x)]
        tl = tree.leaves(ts["mom"], is_leaf=lambda x: isinstance(x, dict)
                         and k in x)
        # a log-scale's moment is its gradient's: held by C_S x M there
        for (name, _), a, b in zip(tree.named_leaves(c.params), jl, tl):
            if "s_" in name.rsplit(".", 1)[-1]:
                continue
            assert Z.rel_l2(b[k], np.asarray(a)) <= rtol, (arch_id, k, name)


def test_train_step_donates_and_moves_batch():
    """The step writes the new params and state into the given tensors
    (the reference's jitted step donates them), with the values of a step
    on copies; a numpy-born batch on the CPU is taken as it is; params on
    another device are refused; a mesh is refused."""
    c = Z.arch_case("minicpm-2b")
    _, cfg = Z.no_remat(c)
    _, tb = Z.with_labels(c, 22)
    _, topt = _opts()
    p1 = tree.map(torch.clone, c.params)
    p2 = tree.map(torch.clone, c.params)
    s1, s2 = topt.init(p1), topt.init(p2)
    step = trainer.make_train_step(cfg, c.q, topt, device="cpu")
    q1, r1, _ = step(p1, s1, tb, STEP)
    ids = [id(x) for x in tree.leaves((p2, s2))]
    q2, r2, _ = step(p2, s2, tb, STEP)
    assert [id(x) for x in tree.leaves((q2, r2))] == ids
    for a, b in zip(tree.leaves((q1, r1)), tree.leaves((q2, r2))):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.leaves(q2), tree.leaves(c.params)))
    with pytest.raises(ValueError, match="params on meta"):
        step(tree.map(lambda x: x.to("meta"), c.params), s1, tb, STEP)
    with pytest.raises(NotImplementedError, match="mesh"):
        trainer.make_train_step(cfg, c.q, topt, mesh=object(), device="cpu")


@pytest.mark.parametrize("arch_id", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_grad_accum_against_reference(arch_id):
    c = Z.arch_case(arch_id)
    jcfg, cfg = Z.no_remat(c)
    jb, tb = Z.with_labels(c, 23)
    tc = dict(grad_accum=2)
    jfn = JTR.make_grad_fn(jcfg, c.jq, JTR.TrainConfig(**tc))
    (jg, jm), calls = Z.run_reference(jfn, c.jparams, jb)
    fn = trainer.make_grad_fn(cfg, c.q, trainer.TrainConfig(**tc))
    (tg, tm), taps = _pinned(calls, lambda: fn(c.params, tb))
    Z.assert_ties_only(taps, f"{arch_id} grad_accum 2")
    Z.assert_metrics_close(jm, tm, arch_id)
    assert all(g.dtype == torch.float32 for g in tree.leaves(tg))
    # the log-scales' bound needs their M: that of the microbatches' mean
    # loss, pinned the same way
    halves = [tree.map(lambda x, i=i: x[i:i + 1], tb) for i in (0, 1)]
    _, mtaps = Z.port_loss_grad(lambda p: (0.5 * sum(
        T.loss_fn(p, b, cfg, c.q)[0] for b in halves), None), c.params,
        calls)
    Z.assert_grads_close(jg, dict(tree.named_leaves(tg)), mtaps,
                         f"{arch_id} grad_accum 2")


DENSE = [a for a in ARCH_IDS if all(s.moe is None for s in (
    get_arch(a).smoke.prefix + get_arch(a).smoke.pattern))]


@pytest.mark.parametrize("arch_id", DENSE)
def test_grad_accum_equivalent(arch_id):
    """accum 2 over a batch against accum 1 on it (the reference's test)
    where the microbatches keep the batch's mean: the same count of
    labelled positions each, and no MoE (its capacity is per microbatch,
    so accum 2 routes other tokens). Every leaf agrees within 1e-4
    relative L2 (a log-scale within C_S x M), but an activation's
    log-scale ``s_in`` is held at sqrt(2) times accum 1's: LSQ scales its
    gradient by 1 / sqrt(the quantized tensor's size), and a microbatch
    holds half the batch."""
    c = Z.arch_case(arch_id)
    _, cfg = Z.no_remat(c)
    _, tb = Z.with_labels(c, 24)
    ((l1, _), g1), taps = Z.port_grad_mag(
        lambda p: T.loss_fn(p, tb, cfg, c.q), c.params)
    g2, m2 = trainer.make_grad_fn(cfg, c.q, trainer.TrainConfig(
        grad_accum=2))(c.params, tb)
    want = {k: g * (math.sqrt(2) if k.endswith("s_in") else 1)
            for k, g in g1.items()}
    Z.assert_grads_close(want, dict(tree.named_leaves(g2)), taps,
                         f"{arch_id} accum 2 against 1")
    assert abs(float(l1) - float(m2["loss"])) < 1e-5
