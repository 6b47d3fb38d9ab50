"""Float FQ training of the port against the JAX reference at full width:
KWS (``KWSConfig()``, B=4, 140 frames) and DarkNet-19 (``DarkNetConfig()``,
every channel width up to 1,024) at 64 x 64, B=1, so that the widest layers
are held too; FQ mode (BN folded, ranges calibrated by the port), clean:
the noise is held at ``reduced()``, where the reference's eager draws
compile in seconds, not a minute. Same helpers and tolerances as
``test_torch_train_fq.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import darknet as jdn
from repro.models import kws as jkws
from repro_torch.core import distill as tdistill
from repro_torch.core import fq_layers as tfql
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from test_torch_fq_layers import (COND, hold_against_reference, key_pair,
                                  port_noise, port_qcfg)
from test_torch_train_fq import carried, numpy_tree

FQ = JQuantConfig(2, 4, 4, fq=True)
CASES = {
    # name: (ref module, port module, ref cfg, port cfg, input, noisy)
    "kws_fq": (jkws, tkws, jkws.KWSConfig(), tkws.KWSConfig(),
               (4, 140, 39), False),
    "darknet_fq": (jdn, tdn, jdn.DarkNetConfig(), tdn.DarkNetConfig(),
                   (1, 64, 64, 3), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_width_fq_train_matches_reference(case):
    jm, tm, jcfg, tcfg, shape, noisy = CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, shape[0]).astype(np.int32)
    tp, ts = tm.init(torch.Generator().manual_seed(1), tcfg, device="cpu")
    tp = tfql.calibrate(lambda pp: tm.apply(pp, ts, torch.from_numpy(x),
                                            port_qcfg(FQ), tcfg),
                        tm.to_fq(tp, ts, tcfg))
    (jp, js), (tp, ts) = carried(numpy_tree(tp), numpy_tree(ts))
    jk, tk = key_pair(5) if noisy else (None, None)
    jn, tn = (COND, port_noise(COND)) if noisy else (None, None)
    jy = jax.nn.one_hot(y, jcfg.num_classes)
    ty = torch.nn.functional.one_hot(torch.from_numpy(y).long(),
                                     tcfg.num_classes).float()

    def ref(p):
        logits, st = jm.apply(p, js, jnp.asarray(x), FQ, jcfg, train=True,
                              rng=jk, noise=jn)
        return jnp.mean(jdistill.softmax_cross_entropy(logits, jy)), \
            (logits, st)

    def port(p):
        logits, st = tm.apply(p, ts, torch.from_numpy(x), port_qcfg(FQ),
                              tcfg, train=True, rng=tk, noise=tn)
        return torch.mean(tdistill.softmax_cross_entropy(logits, ty)), \
            (logits, st)
    zero = ("embed.b",) if jm is jkws else ()
    report = hold_against_reference(ref, port, jp, tp, zero_leaves=zero,
                                    label=case)
    assert report["positions"] > 0
