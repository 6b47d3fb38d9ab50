"""ResNet-32's first 2-bit stage at full width, in the reference and the
port (C-ref-6).

The reference's recipe sets each conv's e^{s_w} at max|w| (``init_scale``
at ``init``). At full width 2-bit weights then keep 1-5% of their codes
nonzero, and whole output channels of the stem (27 weights each) and of
the 1x1 downsample shortcuts have no nonzero code: such a channel's conv
output is 0 everywhere and its training-mode BN divides it by sqrt(eps).
The shortcuts' weight gradients come out over 100 times those of the same
net with e^{s_w} at the 99th percentile of |w|, where no channel is all
zero. Trained from FP with SGD at lr 0.05, the reference's recipe goes
non-finite in the second Q W2A5 step on the card; ``chip_smoke.py``'s
``train_fq`` seeds ResNet-32's scales at the percentile
(``TRAIN_SW_SEEDED``). Both hold in the reference and in the port from the
same carried params. ResNet-32 (``ResNetConfig.resnet32()``) at 32 x 32,
B=2, Q W2A5 (Table 6), one loss and gradient per recipe.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import resnet as jres
from repro_torch import tree
from repro_torch.core import distill as tdistill
from repro_torch.core.quant import QuantConfig, init_scale
from repro_torch.models import resnet as tres
from test_torch_train_fq import carried, numpy_tree

PERCENTILE = 99.0      # train_fq's TRAIN_SW_PERCENTILE
CONVS = ("stem", "s1b0_sc", "s2b0_sc")
RATIO = 10.0           # the blow-up the recipe's dead channels cause


def _dead_channels(w, s):
    """Output channels of a conv whose 2-bit weight codes are all 0."""
    codes = np.round(np.clip(w / np.exp(np.float32(s)), -1, 1))
    return int(np.sum(np.all(codes.reshape(-1, w.shape[-1]) == 0, axis=0)))


@functools.lru_cache(maxsize=None)
def _q_step(recipe):
    """All-zero code channels of CONVS, and max |dL/dw| of each in the
    reference and the port, after the port's ``init`` (seed 0) with the
    recipe's e^{s_w}, carried to the reference."""
    cfg = tres.ResNetConfig.resnet32()
    tp, ts = tres.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if recipe == "p99":
        for name in tp:
            if "s_w" in tp[name]:
                tp[name] = {**tp[name], "s_w": init_scale(
                    tp[name]["w"], percentile=PERCENTILE)}
    (jp, js), (tp, ts) = carried(numpy_tree(tp), numpy_tree(ts))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 2)
    jq, tq = JQuantConfig(2, 5), QuantConfig(2, 5)

    def ref(p):
        logits, _ = jres.apply(p, js, jnp.asarray(x), jq,
                               jres.ResNetConfig.resnet32(), train=True)
        return jnp.mean(jdistill.softmax_cross_entropy(
            logits, jax.nn.one_hot(y, cfg.num_classes)))

    def port(p):
        logits, _ = tres.apply(p, ts, torch.from_numpy(x), tq, cfg,
                               train=True)
        return torch.mean(tdistill.softmax_cross_entropy(
            logits, torch.nn.functional.one_hot(
                torch.from_numpy(y).long(), cfg.num_classes).float())), None
    jg = jax.grad(ref)(jp)
    _, tg = tree.value_and_grad(port, has_aux=True)(tp)
    dead = {n: _dead_channels(np.asarray(jp[n]["w"]),
                              np.asarray(jp[n]["s_w"])) for n in CONVS}
    gmax = {n: float(np.abs(np.asarray(jg[n]["w"])).max()) for n in CONVS}
    port_gmax = {n: float(tg[n]["w"].abs().max()) for n in CONVS}
    print(f"\n{recipe}: all-zero 2-bit code channels {dead}; max |dL/dw| "
          f"reference {gmax}, port {port_gmax}")
    return dead, gmax, port_gmax


@pytest.mark.parametrize("recipe", ["max", "p99"])
def test_full_width_resnet32_q_transition(recipe):
    dead, _, _ = _q_step(recipe)
    if recipe == "max":
        assert dead["stem"] > 0 and dead["s1b0_sc"] > 0, dead
    else:
        assert not any(dead.values()), dead


def test_resnet32_dead_channels_blow_up_the_shortcut_gradients():
    """max |dL/dw| of the downsample shortcuts under the reference's
    recipe against the percentile's, in the reference and in the port
    alike. The two take other codes where a sum lands on a rounding
    boundary, and through a BN that divides by sqrt(eps) such a flip moves
    a gradient by O(1): the gradients are held against each other, pinned,
    at ``reduced()`` (``test_torch_resnet.py``); here each framework is
    held to the blow-up on its own."""
    _, ref_max, port_max = _q_step("max")
    _, ref_p99, port_p99 = _q_step("p99")
    for at_max, at_p99 in ((ref_max, ref_p99), (port_max, port_p99)):
        ratio = {n: at_max[n] / at_p99[n] for n in CONVS}
        print(f"\nmax |dL/dw|, e^s_w at max|w| over at p99: {ratio}")
        assert ratio["s1b0_sc"] > RATIO and ratio["s2b0_sc"] > RATIO, ratio
