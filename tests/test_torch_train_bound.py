"""The card-against-CPU gradient bound of ``chip_smoke.py``'s ``train_fq``
(``compare_step``, ``head_bound``) on synthetic card / CPU pairs.

``train_fq`` repeats every training step of the card on the CPU from the
card's params and holds each log-scale's gradient within TRAIN_C_S x M, M
the sum of its terms' magnitudes (``repro_torch.taps``). That bound had two
blind spots, both seen in ResNet-32's FQ stage at lr 0.05:

  (a) a log-scale whose every term is 0 in exact arithmetic (its
      quantizer's inputs exactly 0 wherever gradient flows) has M = 0 and a
      gradient of exactly 0 on the CPU, while the card's conv leaves ~1e-10
      of residue: no multiple of M bounds it. The bound now adds twice D,
      the terms' forward difference g x sum |dL/dQ| x |x_card - x_cpu|,
      which the CPU run's taps sum against the card's recorded inputs;
  (b) logits of ~1e3 differ by float32 rounding, and the distillation head
      turns that into a relative difference of its gradient past TRAIN_C_S,
      which then reaches every gradient below it. The head gradient is now
      held on its own (its Lipschitz bound, ``head_bound``) and the network
      below it from the card's head gradient
      (``taps.head_value_and_grad(head=)``).

Each pair here is two CPU runs of a toy (quantizers, a dense head, the
distillation loss), the "card" run given the perturbation that card runs
show. The old bound (no D; the CPU's own backward) refuses each pair, the
new one accepts it, and a pair with a real gradient error, or a wrong head,
is still refused.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import taps
from repro_torch.core import distill
from repro_torch.core import fq_layers as fql

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _loss(logits, teacher, y):
    if teacher is None:
        onehot = torch.nn.functional.one_hot(y, logits.shape[-1]).float()
        return torch.mean(distill.softmax_cross_entropy(logits, onehot))
    return distill.distillation_loss(logits, teacher, y,
                                     alpha=cs.TRAIN_ALPHA)


def _toy(x1, x2, bias, teacher, y):
    """Two 4-bit quantizers (s1 over x1, s2 over x2) into a dense head,
    ``bias`` added to the logits: fn(params) -> (loss, (logits, None))."""

    def fn(p):
        q1 = fql.learned_quantize(x1, p["q1"]["s"], bits=4, b=-1.0)
        q2 = fql.learned_quantize(x2, p["q2"]["s"], bits=4, b=-1.0)
        logits = torch.cat([q1, q2], -1) @ p["head"]["w"] + bias
        return _loss(logits, teacher, y), (logits, None)
    return fn


def _params(rng, f1, f2, classes, scale=1.0):
    return {"q1": {"s": torch.tensor(np.float32(np.log(0.8)))},
            "q2": {"s": torch.tensor(np.float32(np.log(0.5)))},
            "head": {"w": torch.from_numpy((rng.standard_normal(
                (f1 + f2, classes)) * scale).astype(np.float32))}}


def _pair(params, card_fn, cpu_fn, *, pinned):
    """(card, cpu) results as train_fq takes them: the card's recorded,
    the CPU's pinned to the card's choices; ``pinned`` also starts the CPU's
    backward below the head from the card's head gradient."""
    tc = taps.Taps(record=True)
    card = taps.head_value_and_grad(card_fn, params, tc)
    t = taps.Taps(tc)
    if pinned:
        cpu = taps.head_value_and_grad(cpu_fn, params, t, head=card[2])
    else:
        (v, aux), g = taps.value_and_grad(cpu_fn, params, t)
        cpu = ((v, aux), g, None)
    t.matched()
    return card, cpu, t


def _check(card, cpu, t, *, new, teacher=(None, None)):
    (l_card, (lg_card, _)), g_card, h_card = card
    (l_cpu, (lg_cpu, _)), g_cpu, h_cpu = cpu
    kw = {}
    if new:
        kw = dict(fwd=t.fwd, head=(h_card, h_cpu, cs.head_bound(
            torch, lg_card, lg_cpu, teacher[0], teacher[1], h_cpu)))
    return cs.compare_step(torch, "toy", (l_card, lg_card, g_card),
                           (l_cpu, lg_cpu, g_cpu), t.mag, **kw)


def _exact_zero_pair(rng):
    """(a): q2's inputs exactly 0 on the CPU, cuDNN-like residue of 1e-10
    on the card; q1 live and equal on both."""
    b, f1, f2, classes = 4, 6, 5, 3
    x1 = torch.from_numpy(rng.uniform(-0.7, 0.7, (b, f1)).astype(np.float32))
    x2_cpu = torch.zeros(b, f2)
    x2_card = torch.from_numpy((rng.choice([-1.0, 1.0], (b, f2))
                                * 1e-10).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, classes, b))
    bias = torch.zeros(b, classes)
    params = _params(rng, f1, f2, classes)
    return (params, _toy(x1, x2_card, bias, None, y),
            _toy(x1, x2_cpu, bias, None, y))


def test_exact_zero_log_scale_old_bound_refuses_new_accepts():
    params, card_fn, cpu_fn = _exact_zero_pair(np.random.default_rng(0))
    card, cpu, t = _pair(params, card_fn, cpu_fn, pinned=True)
    assert float(cpu[1]["q2.s"]) == 0.0 and t.mag["q2.s"] == 0.0
    assert float(card[1]["q2.s"]) != 0.0 and t.fwd["q2.s"] > 0.0
    with pytest.raises(AssertionError, match="q2.s gradient off"):
        _check(card, cpu, t, new=False)
    _, worst_s, _ = _check(card, cpu, t, new=True)
    assert worst_s[0] <= 1.0


def test_exact_zero_log_scale_real_error_still_refused():
    params, card_fn, cpu_fn = _exact_zero_pair(np.random.default_rng(0))
    card, cpu, t = _pair(params, card_fn, cpu_fn, pinned=True)
    for name, off in (("q2.s", 1e-6), ("q1.s", 1e-3)):
        g = dict(card[1])
        g[name] = g[name] + off
        with pytest.raises(AssertionError, match=f"{name} gradient off"):
            _check((card[0], g, card[2]), cpu, t, new=True)


def _head_pair(rng):
    """(b): logits ~1e3 tied at the top, the card's apart from the CPU's by
    +-2e-3 on the two tied classes (float32 rounding at ~1e3 after a few
    sums), distilled at TRAIN_ALPHA from a teacher at the same tie, labels
    on a third class: the loss moves only in second order, the head
    gradient by ~1e-2 of itself on the tied classes. The quantizers' inputs
    clip (dQ/ds = Q: no cancellation inside M) and the head reads class 0
    only, so that the log-scales' gradients carry the head's difference."""
    b, f1, f2, classes = 4, 6, 5, 4
    x1 = torch.from_numpy(rng.uniform(1.0, 1.5, (b, f1)).astype(np.float32))
    x2 = torch.from_numpy(rng.uniform(0.6, 0.9, (b, f2)).astype(np.float32))
    y = torch.full((b,), 2, dtype=torch.int64)
    bias = torch.tensor([[1000.0, 1000.0, 990.0, 985.0]] * b)
    delta = torch.tensor([[2e-3, -2e-3, 0.0, 0.0]] * b)
    teacher = bias.clone()
    params = _params(rng, f1, f2, classes)
    w = torch.zeros(f1 + f2, classes)
    w[:, 0] = torch.from_numpy(rng.uniform(0.5, 1.5, f1 + f2).astype(
        np.float32)) * 1e-3
    params["head"]["w"] = w
    return (params, _toy(x1, x2, bias + delta, teacher, y),
            _toy(x1, x2, bias, teacher, y), (teacher, teacher))


def test_head_old_bound_refuses_new_accepts():
    params, card_fn, cpu_fn, teacher = _head_pair(np.random.default_rng(1))
    card, cpu_own, t_own = _pair(params, card_fn, cpu_fn, pinned=False)
    # the head's difference reaches the dense head's weights (rel L2) and
    # the log-scales (past C_S x M) alike
    with pytest.raises(AssertionError, match="gradient (off|rel L2)"):
        _check(card, cpu_own, t_own, new=False)
    g = dict(cpu_own[1])
    g["head.w"] = card[1]["head.w"]
    with pytest.raises(AssertionError, match="q1.s gradient off"):
        _check(card, (cpu_own[0], g, None), t_own, new=False)
    card, cpu, t = _pair(params, card_fn, cpu_fn, pinned=True)
    h_err = float((card[2] - cpu[2]).norm())
    assert h_err > cs.TRAIN_C_S * float(cpu[2].norm())
    _check(card, cpu, t, new=True, teacher=teacher)


def test_head_real_errors_still_refused():
    params, card_fn, cpu_fn, teacher = _head_pair(np.random.default_rng(1))
    card, cpu, t = _pair(params, card_fn, cpu_fn, pinned=True)
    g = dict(card[1])
    g["q1.s"] = g["q1.s"] * 1.01
    with pytest.raises(AssertionError, match="q1.s gradient off"):
        _check((card[0], g, card[2]), cpu, t, new=True, teacher=teacher)
    # a head gradient off by more than its Lipschitz bound: another label
    wrong = card[2].clone()
    wrong[0] = wrong[0].roll(1)
    with pytest.raises(AssertionError, match="head gradient off"):
        _check((card[0], card[1], wrong), cpu, t, new=True, teacher=teacher)


def test_head_value_and_grad_matches_value_and_grad():
    """Without ``head`` the leaf gradients are ``value_and_grad``'s; with
    the run's own head gradient as ``head`` they are too."""
    params, _, cpu_fn, _ = _head_pair(np.random.default_rng(2))
    (v, _), g = taps.value_and_grad(cpu_fn, params, taps.Taps())
    (v2, _), g2, h = taps.head_value_and_grad(cpu_fn, params, taps.Taps())
    (_, _), g3, h3 = taps.head_value_and_grad(cpu_fn, params, taps.Taps(),
                                              head=h)
    assert float(v) == float(v2) and torch.equal(h, h3)
    for k in g:
        assert torch.allclose(g[k], g2[k], rtol=1e-6, atol=0)
        assert torch.allclose(g[k], g3[k], rtol=1e-6, atol=0)
