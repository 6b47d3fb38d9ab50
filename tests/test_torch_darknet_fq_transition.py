"""DarkNet-19's FQ transition at full width, in the reference and the port.

The reference's recipe, ``to_fq`` (BN folded, e^{s_w} = max|w|) and then
three iterations of ``calibrate``, leaves the BN-free FQ net dead from
conv12 on: every output code of those layers is 0 (C-ref-5). At full width
max|w| of a layer of up to 4.7M weights is ~5 sigma, so only 1-6% of the
2-bit weight codes are nonzero, and the signal fades layer by layer. With
e^{s_w} at the 99th percentile of |w|, as ``chip_smoke.py``'s ``train_fq``
seeds it, every layer is live. Both hold in the reference and in the port
from the same carried params.

Full width (``DarkNetConfig()``) at 64 x 64, B=1: what kills the net is its
widths, not the image size (the card run at 224 x 224, B=8, after the
ladder's FP and Q steps, is dead from conv12 on too).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fq_layers as jfql
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import darknet as jdn
from repro_torch import interop
from repro_torch.core import fq_layers as tfql
from repro_torch.core.quant import QuantConfig, init_scale
from repro_torch.models import darknet as tdn

CAL_ITERS = 3          # the reference's default, and train_fq's
PERCENTILE = 99.0      # train_fq's TRAIN_SW_PERCENTILE
N_CONVS = 18           # conv0..conv17; the head is the 19th fq_conv2d


def _live_shares(mod, apply_fn):
    """The share of nonzero outputs of each of the 18 convs in one run of
    ``apply_fn``, tapping ``mod.fq_conv2d``."""
    shares, orig = [], mod.fq_conv2d

    def tap(p, h, q, **kw):
        y = orig(p, h, q, **kw)
        shares.append(float(np.mean(np.asarray(y) != 0)))
        return y
    with mock.patch.object(mod, "fq_conv2d", tap):
        apply_fn()
    assert len(shares) == N_CONVS + 1
    return shares[:N_CONVS]


@pytest.mark.parametrize("recipe", ["max", "p99"])
def test_full_width_darknet_fq_transition(recipe):
    cfg = jdn.DarkNetConfig()
    jp, js = jdn.init(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(7).standard_normal(
        (1, 64, 64, cfg.in_channels)).astype(np.float32)
    jq = JQuantConfig(2, 4, 4, fq=True)
    tq = QuantConfig(2, 4, 4, fq=True)
    quantized = [f"conv{i}" for i in range(1, N_CONVS)]

    jfq = jdn.to_fq(jp, js, cfg)
    tp, ts = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    tfq = tdn.to_fq(tp, ts, tdn.DarkNetConfig())
    if recipe == "p99":
        for n in quantized:
            jfq[n] = {**jfq[n], "s_w": jfql.init_scale(
                jfq[n]["w"], percentile=PERCENTILE)}
            tfq[n] = {**tfq[n], "s_w": init_scale(
                tfq[n]["w"], percentile=PERCENTILE)}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jcal = jfql.calibrate(lambda pp: jdn.apply(pp, js, jx, jq, cfg), jfq,
                          iters=CAL_ITERS)
    tcal = tfql.calibrate(
        lambda pp: tdn.apply(pp, ts, tx, tq, tdn.DarkNetConfig()), tfq,
        iters=CAL_ITERS)
    ref = _live_shares(jfql, lambda: jdn.apply(jcal, js, jx, jq, cfg))
    with torch.no_grad():
        port = _live_shares(tfql, lambda: tdn.apply(
            tcal, ts, tx, tq, tdn.DarkNetConfig()))
    print(f"\n{recipe}: nonzero output share conv0..17, reference "
          f"{np.round(ref, 3).tolist()}, port {np.round(port, 3).tolist()}")
    dead_ref = [i for i, v in enumerate(ref) if v == 0]
    dead_port = [i for i, v in enumerate(port) if v == 0]
    if recipe == "max":
        # the reference's own recipe: dead from conv12 on
        assert dead_ref == list(range(12, N_CONVS)), ref
    else:
        assert dead_ref == [], ref
    # the port takes the same layers dead and live
    assert dead_port == dead_ref, (port, ref)
