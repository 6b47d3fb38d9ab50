"""Float FQ training of the port against the JAX reference at full width:
KWS (``KWSConfig()``, B=4, 140 frames), DarkNet-19 (``DarkNetConfig()``,
every channel width up to 1,024) at 64 x 64, B=1, so that the widest layers
are held too, and ResNet-32 (``ResNetConfig.resnet32()``, widths 64 / 128
/ 256, 33 convs) at 32 x 32, B=1, in FQ W2A5, Table 6's last stage; FQ mode
(BN folded, ranges calibrated by the port), clean: the noise is held at
``reduced()``, where the reference's eager draws compile in seconds, not a
minute. ResNet-20's full-width stages are in ``test_torch_resnet.py``.
Same helpers and tolerances as ``test_torch_train_fq.py``.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import darknet as jdn
from repro.models import kws as jkws
from repro.models import resnet as jres
from repro_torch.core import distill as tdistill
from repro_torch.core import fq_layers as tfql
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from repro_torch.models import resnet as tres
from test_torch_fq_layers import (COND, hold_against_reference, key_pair,
                                  port_noise, port_qcfg)
from test_torch_train_fq import carried, numpy_tree

FQ = JQuantConfig(2, 4, 4, fq=True)
CASES = {
    # name: (ref module, port module, ref cfg, port cfg, input, stage,
    #        noisy)
    "kws_fq": (jkws, tkws, jkws.KWSConfig(), tkws.KWSConfig(),
               (4, 140, 39), FQ, False),
    "darknet_fq": (jdn, tdn, jdn.DarkNetConfig(), tdn.DarkNetConfig(),
                   (1, 64, 64, 3), FQ, False),
    "resnet32_fq_w2a5": (jres, tres, jres.ResNetConfig.resnet32(),
                         tres.ResNetConfig.resnet32(), (1, 32, 32, 3),
                         JQuantConfig(2, 5, 5, fq=True), False),
}


def check_full_width(case, spec):
    """``apply(train=True)`` of one full-width stage held against the
    reference (the port's ``init``; for FQ its ``to_fq`` and
    ``calibrate``, 3 iterations, on the batch). Returns the carried port
    params, state and input, and the stage's port QuantConfig."""
    jm, tm, jcfg, tcfg, shape, qcfg, noisy = spec
    tq = port_qcfg(qcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, shape[0]).astype(np.int32)
    tp, ts = tm.init(torch.Generator().manual_seed(1), tcfg, device="cpu")
    if qcfg.fq:
        tp = tfql.calibrate(lambda pp: tm.apply(pp, ts, torch.from_numpy(x),
                                                tq, tcfg),
                            tm.to_fq(tp, ts, tcfg))
    (jp, js), (tp, ts) = carried(numpy_tree(tp), numpy_tree(ts))
    jk, tk = key_pair(5) if noisy else (None, None)
    jn, tn = (COND, port_noise(COND)) if noisy else (None, None)
    jy = jax.nn.one_hot(y, jcfg.num_classes)
    ty = torch.nn.functional.one_hot(torch.from_numpy(y).long(),
                                     tcfg.num_classes).float()

    def ref(p):
        logits, st = jm.apply(p, js, jnp.asarray(x), qcfg, jcfg, train=True,
                              rng=jk, noise=jn)
        return jnp.mean(jdistill.softmax_cross_entropy(logits, jy)), \
            (logits, st)

    def port(p):
        logits, st = tm.apply(p, ts, torch.from_numpy(x), tq, tcfg,
                              train=True, rng=tk, noise=tn)
        return torch.mean(tdistill.softmax_cross_entropy(logits, ty)), \
            (logits, st)
    zero = ("embed.b",) if jm is jkws else ()
    report = hold_against_reference(ref, port, jp, tp, zero_leaves=zero,
                                    label=case)
    if qcfg.fq:
        assert report["positions"] > 0
    return tp, ts, torch.from_numpy(x), tq


@pytest.mark.parametrize("case", list(CASES))
def test_full_width_fq_train_matches_reference(case):
    tp, ts, x, tq = check_full_width(case, CASES[case])
    if CASES[case][0] is jres:
        # The reference's FQ transition leaves ResNet-32 live (unlike
        # DarkNet-19, C-ref-5): every one of its 33 quantized convs puts
        # out nonzero codes on the batch, the port's and so the
        # reference's (the codes above agree).
        shares, orig = [], tfql.fq_conv2d

        def tap(p, h, q, **kw):
            out = orig(p, h, q, **kw)
            shares.append(float((out != 0).float().mean()))
            return out
        with mock.patch.object(tfql, "fq_conv2d", tap), torch.no_grad():
            tres.apply(tp, ts, x, tq, CASES[case][3])
        print(f"\n{case}: nonzero output share of each conv "
              f"{np.round(shares, 3).tolist()}")
        assert len(shares) == 33 and min(shares) > 0, shares
