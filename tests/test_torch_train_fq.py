"""Float FQ training of the port against the JAX reference, at ``reduced()``:
``kws.apply``, ``darknet.apply`` and ``resnet.apply`` with ``train=True``
over the ladder's configurations (FP; Q; FQ after ``to_fq`` +
``calibrate``; FQ under Table 7's noisiest condition), SGD with Nesterov
momentum on a cosine schedule, the schedules, ``distill`` and ``gradual``.

Params are made by the port from a seed (``init``, and ``to_fq`` and
``calibrate`` for FQ), handed to both as numpy and carried with
``interop``; keys with ``key_from_numpy``. The reference runs eagerly. Values, BN state and
gradients are held as ``test_torch_fq_layers.hold_against_reference``
holds them (code and tie flips counted, then pinned; tolerances there).
DarkNet's stages are in ``test_torch_train_fq_darknet.py``, the ResNets'
in ``test_torch_resnet.py`` and the full-width nets in
``test_torch_train_fq_full.py`` (each file keeps to a minute: the
reference compiles every eager op once per shape).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core import gradual as jgradual
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import darknet as jdn
from repro.models import kws as jkws
from repro.models import resnet as jres
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro_torch import interop, tree
from repro_torch.core import distill as tdistill
from repro_torch.core import fq_layers as tfql
from repro_torch.core import gradual as tgradual
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from repro_torch.models import resnet as tres
from repro_torch.optim import schedules as tsched
from repro_torch.optim import sgd as tsgd
from test_torch_fq_layers import (COND, hold_against_reference, key_pair,
                                  port_noise, port_qcfg)

MODELS = {
    # name: (reference module, port module, reference cfg, port cfg,
    #        input shape, the Q stage)
    "kws": (jkws, tkws, jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced(),
            (4, 24, 8), JQuantConfig(2, 4)),
    "darknet": (jdn, tdn, jdn.DarkNetConfig.reduced(),
                tdn.DarkNetConfig.reduced(), (2, 16, 16, 3),
                JQuantConfig(2, 5)),
    # the reference's own ResNet test's input and Q stage
    # (tests/test_models_cnn.py); reduced() has one downsample block
    "resnet": (jres, tres, jres.ResNetConfig.reduced(),
               tres.ResNetConfig.reduced(), (2, 16, 16, 3),
               JQuantConfig(8, 8)),
    # the same with the stem and head in FP (ResNet-20's §4.1 protocol)
    "resnet_fp_edges": (
        jres, tres,
        dataclasses.replace(jres.ResNetConfig.reduced(),
                            quantize_first_last=False),
        dataclasses.replace(tres.ResNetConfig.reduced(),
                            quantize_first_last=False),
        (2, 16, 16, 3), JQuantConfig(8, 8)),
}
FQ = JQuantConfig(2, 4, 4, fq=True)
STAGES = ("fp", "q", "fq", "fq_noisy")


def batch(name, seed=1):
    jm, _, jcfg, _, shape, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, shape[0]).astype(np.int32)
    return x, y


def numpy_tree(tree_):
    return {k: numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree_.items()}


def stage_params(name, stage, x, seed=0):
    """Params and BN state of a ladder stage, as numpy, made by the port
    from a seed (its ``init``; for the FQ stages BN folded by ``to_fq`` and
    ranges calibrated on the batch by ``calibrate``, 3 iterations; the
    reference's calibration is held in ``test_torch_fq_layers``), and the
    stage's reference QuantConfig."""
    _, tm, _, tcfg, _, qstage = MODELS[name]
    qcfg = {"fp": JQuantConfig(), "q": qstage}.get(stage, FQ)
    tp, ts = tm.init(torch.Generator().manual_seed(seed), tcfg, device="cpu")
    if qcfg.fq:
        tp = tfql.calibrate(lambda pp: tm.apply(pp, ts, torch.from_numpy(x),
                                                port_qcfg(qcfg), tcfg),
                            tm.to_fq(tp, ts, tcfg))
    return numpy_tree(tp), numpy_tree(ts), qcfg


def carried(p, st):
    """The same numbers on both sides: jax arrays, and the port's tensors
    through ``interop``."""
    j = jax.tree_util.tree_map(jnp.asarray, (p, st))
    return j, interop.params_from_numpy(p, st, device="cpu")


def loss_fns(name, js, ts, qcfg, x, y, noisy, key_seed=3):
    """(reference, port) losses: cross-entropy of ``apply(train=True)``,
    returning (loss, (logits, new state))."""
    jm, tm, jcfg, tcfg, _, _ = MODELS[name]
    jk, tk = key_pair(key_seed) if noisy else (None, None)
    jnoise, tnoise = (COND, port_noise(COND)) if noisy else (None, None)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jy = jax.nn.one_hot(y, jcfg.num_classes)
    ty = torch.nn.functional.one_hot(torch.from_numpy(y).long(),
                                     tcfg.num_classes).float()

    def ref(p):
        logits, st = jm.apply(p, js, jx, qcfg, jcfg, train=True, rng=jk,
                              noise=jnoise)
        loss = jnp.mean(jdistill.softmax_cross_entropy(logits, jy))
        return loss, (logits, st)

    def port(p):
        logits, st = tm.apply(p, ts, tx, port_qcfg(qcfg), tcfg, train=True,
                              rng=tk, noise=tnoise)
        loss = torch.mean(tdistill.softmax_cross_entropy(logits, ty))
        return loss, (logits, st)
    return ref, port


def zero_leaves(name, stage):
    """Leaves the loss does not depend on in exact arithmetic. KWS: the
    embedding's bias sits before a training-mode BN; in FP mode the BN's
    beta too, as conv0 (VALID, no quantizer between) passes a per-channel
    shift on to the next training-mode BN."""
    if name != "kws":
        return ()
    return ("embed.b",) + (("embed_bn.beta",) if stage == "fp" else ())


def check_stage(name, stage):
    """``apply(train=True)`` of one ladder stage held against the
    reference: logits, new BN state, loss and every gradient."""
    x, y = batch(name)
    p, st, qcfg = stage_params(name, stage.replace("_noisy", ""), x)
    (jp, js), (tp, ts) = carried(p, st)
    ref, port = loss_fns(name, js, ts, qcfg, x, y, stage.endswith("noisy"))
    zero = zero_leaves(name, stage)
    report = hold_against_reference(ref, port, jp, tp, zero_leaves=zero,
                                    label=f"{name} {stage}")
    if qcfg.fq:
        assert report["positions"] > 0


@pytest.mark.parametrize("stage", STAGES)
def test_kws_apply_train_matches_reference(stage):
    check_stage("kws", stage)


def test_apply_eval_mode_keeps_state_and_agrees():
    """train=False: BN reads its running state and returns it unchanged."""
    x, _ = batch("kws")
    p, st, qcfg = stage_params("kws", "q", x)
    (jp, js), (tp, ts) = carried(p, st)
    jl, _ = jkws.apply(jp, js, jnp.asarray(x), qcfg, MODELS["kws"][2])
    tl, st = tkws.apply(tp, ts, torch.from_numpy(x), port_qcfg(qcfg),
                        MODELS["kws"][3])
    assert all(st[k] is ts[k] for k in ts)
    # float32 sums in another order (RTOL_FLOAT of the layer tests)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())


# ---------------------------------------------------------------------------
# SGD steps, schedules, distillation, the ladder
# ---------------------------------------------------------------------------


def test_three_sgd_nesterov_steps_match_reference():
    """Three steps of the paper's optimiser (SGD, Nesterov 0.9, weight decay
    5e-4, cosine schedule) on KWS FQ, distilling from the FP net as every
    stage after the first does: params after each step within 1e-5 x the
    leaf's max (float32 updates of gradients held at 1e-4 relative L2, each
    step a 0.05 x gradient move), momentum likewise."""
    x, y = batch("kws")
    jcfg, tcfg = MODELS["kws"][2], MODELS["kws"][3]
    teacher, _, _ = stage_params("kws", "fp", x)
    p, st, qcfg = stage_params("kws", "fq", x)
    (jp, js), (tp, ts) = carried(p, st)
    (teacher, _), (tt, _) = carried(teacher, {})
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jopt = jsgd.make(jsched.cosine(0.05, 3), weight_decay=5e-4)
    topt = tsgd.make(tsched.cosine(0.05, 3), weight_decay=5e-4)
    jt_logits, _ = jkws.apply(teacher, js, jx, JQuantConfig(), jcfg)
    tt_logits, _ = tkws.apply(tt, ts, tx, port_qcfg(JQuantConfig()), tcfg)

    def jloss(p, st):
        logits, new = jkws.apply(p, st, jx, qcfg, jcfg, train=True)
        return jdistill.distillation_loss(
            logits, jax.lax.stop_gradient(jt_logits), jnp.asarray(y),
            alpha=0.7), new

    def tloss(p, st):
        logits, new = tkws.apply(p, st, tx, port_qcfg(qcfg), tcfg,
                                 train=True)
        return tdistill.distillation_loss(logits, tt_logits.detach(),
                                          torch.from_numpy(y),
                                          alpha=0.7), new
    jst, tst = jopt.init(jp), topt.init(tp)
    jstate, tstate = js, ts
    tgrad_fn = tree.value_and_grad(tloss, has_aux=True)
    for i in range(3):
        (jl, jstate), jg = jax.value_and_grad(jloss, has_aux=True)(jp,
                                                                   jstate)
        (tl, tstate), tg = tgrad_fn(tp, tstate)
        jp, jst = jopt.update(jp, jg, jst, jnp.int32(i))
        tp, tst = topt.update(tp, tg, tst, i)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path((jp, jst["mu"])),
                tree.leaves((tp, tst["mu"]))):
            a, b = np.asarray(a), b.numpy()
            if path[-1].key == "b" and path[-2].key == "embed":
                # zero gradient in exact arithmetic (BN follows): only
                # weight decay and rounding noise move it
                continue
            np.testing.assert_allclose(
                b, a, rtol=0, atol=1e-5 * max(np.abs(a).max(), 1e-6),
                err_msg=f"step {i} {jax.tree_util.keystr(path)}")
        for k in tstate:
            for stat in ("mean", "var"):
                np.testing.assert_allclose(
                    tstate[k][stat].numpy(), np.asarray(jstate[k][stat]),
                    rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(0.1),
    lambda m: m.exponential(0.1, 0.9, steps_per_epoch=3),
    lambda m: m.step_decay(0.1, [2, 5], 0.3),
    lambda m: m.cosine(0.05, 7),
    lambda m: m.cosine(0.05, 9, warmup=3, final_frac=0.2),
    lambda m: m.wsd(0.1, 40, warmup_frac=0.1, decay_frac=0.2),
], ids=["constant", "exponential", "step_decay", "cosine", "cosine_warmup",
        "wsd"])
def test_schedules_match_reference(make):
    jf, tf = make(jsched), make(tsched)
    for step in range(0, 45, 1):
        want = np.float32(np.asarray(jf(jnp.int32(step))))
        got = tf(step)
        assert got.dtype == torch.float32
        # float32 in the reference's steps; cos / pow may differ by an ulp
        assert abs(float(got) - float(want)) <= 2 * float(np.spacing(
            np.float32(abs(want)))) + 1e-12, (step, float(got), float(want))


def test_sgd_without_nesterov_or_decay():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    opt = tsgd.make(tsched.constant(0.1), nesterov=False)
    st = opt.init(p)
    p1, st1 = opt.update(p, g, st, 0)
    jopt = jsgd.make(jsched.constant(0.1), nesterov=False)
    jp1, jst1 = jopt.update({"w": jnp.asarray([1.0, -2.0])},
                            {"w": jnp.asarray([0.5, 0.25])},
                            jopt.init({"w": jnp.asarray([1.0, -2.0])}), 0)
    np.testing.assert_array_equal(p1["w"].numpy(), np.asarray(jp1["w"]))
    np.testing.assert_array_equal(st1["mu"]["w"].numpy(),
                                  np.asarray(jst1["mu"]["w"]))


def test_distillation_losses_match_reference():
    rng = np.random.default_rng(9)
    s = (rng.standard_normal((16, 12)) * 3).astype(np.float32)
    t = (rng.standard_normal((16, 12)) * 3).astype(np.float32)
    y = rng.integers(0, 12, 16)
    onehot = np.eye(12, dtype=np.float32)[y]
    pairs = [
        (jdistill.softmax_cross_entropy(jnp.asarray(s), jnp.asarray(onehot)),
         tdistill.softmax_cross_entropy(torch.from_numpy(s),
                                        torch.from_numpy(onehot))),
    ]
    for temp, alpha in ((4.0, 0.9), (2.5, 0.7), (1.0, 0.0)):
        pairs.append((jdistill.distillation_loss(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(y), temperature=temp,
            alpha=alpha), tdistill.distillation_loss(
            torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(y),
            temperature=temp, alpha=alpha)))
    pairs.append((jdistill.label_refinery_loss(jnp.asarray(s), jnp.asarray(t)),
                  tdistill.label_refinery_loss(torch.from_numpy(s),
                                               torch.from_numpy(t))))
    for want, got in pairs:
        # float32 log-softmaxes: torch's is fused, jax's is x - logsumexp
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    # the gradient w.r.t. the student, distillation at T = 4
    ts = torch.from_numpy(s).requires_grad_(True)
    tdistill.distillation_loss(ts, torch.from_numpy(t),
                               torch.from_numpy(y)).backward()
    want = jax.grad(lambda a: jdistill.distillation_loss(
        a, jnp.asarray(t), jnp.asarray(y)))(jnp.asarray(s))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_gradual_ladder_is_the_references():
    """run_ladder / no_gq_baseline: the same stages, teachers and results
    as the reference's for one scripted train_stage."""
    ladder_j = [JQuantConfig(), JQuantConfig(4, 4), JQuantConfig(2, 4),
                JQuantConfig(2, 4, 4, fq=True)]
    ladder_t = [port_qcfg(q) for q in ladder_j]
    metrics = [0.5, 0.8, 0.7, 0.75]

    def stage_fn(log):
        def train_stage(params, qcfg, teacher, idx):
            log.append((qcfg.label(), teacher, params))
            return params + 1, metrics[idx]
        return train_stage
    for best in (True, False):
        jlog, tlog = [], []
        jr = jgradual.run_ladder(ladder_j, 0, stage_fn(jlog),
                                 use_best_teacher=best)
        tr = tgradual.run_ladder(ladder_t, 0, stage_fn(tlog),
                                 use_best_teacher=best)
        assert jlog == tlog
        assert tr.summary() == jr.summary()
        assert (tr.best.val_metric, tr.best.params) == \
            (jr.best.val_metric, jr.best.params)
        assert tr.final.params == jr.final.params == 4
    jb = jgradual.no_gq_baseline(ladder_j[-1], 0, stage_fn([]))
    tb = tgradual.no_gq_baseline(ladder_t[-1], 0, stage_fn([]))
    assert (tb.qcfg.label(), tb.val_metric, tb.params) == \
        (jb.qcfg.label(), jb.val_metric, jb.params)
