"""The port's CIFAR ResNets against the JAX reference: ``resnet.apply``
with ``train=True`` at ``reduced()`` (widths 8 / 16, one block a stage, so
one downsample block: the 1x1 stride-2 shortcut conv and the 3x3 stride-2
"SAME" conv that pads (0, 1) on the 16 x 16 input) over the ladder's
stages (FP; Q W8A8, the reference's own ResNet test's; FQ after ``to_fq``
+ ``calibrate``; FQ under Table 7's noisiest condition), with the stem and
head quantized (ResNet-32's protocol) and in FP (ResNet-20's, §4.1);
eval mode; ``to_fq``; ResNet-20 at full width (FP and Table 1's last
stage, Q W2A2); ``core.quant.LADDERS`` and ``configs.paper_nets``.

Helpers and tolerances: ``test_torch_train_fq.py`` (the stages) and
``test_torch_fq_layers.hold_against_reference`` (code, tie and ReLU
flips counted, then pinned). ResNet-32 at full width is in
``test_torch_train_fq_full.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_nets as jnets
from repro.core import quant as jquant
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import resnet as jres
from repro_torch.configs import paper_nets as tnets
from repro_torch.core import quant as tquant
from repro_torch.models import resnet as tres
from test_torch_fq_layers import RTOL_FLOAT, port_qcfg
from test_torch_train_fq import (MODELS, STAGES, batch, carried, check_stage,
                                 stage_params)
from test_torch_train_fq_full import check_full_width


@pytest.mark.parametrize("stage", STAGES)
def test_resnet_apply_train_matches_reference(stage):
    check_stage("resnet", stage)


@pytest.mark.parametrize("stage", STAGES)
def test_resnet_fp_edges_apply_train_matches_reference(stage):
    """``quantize_first_last=False``: the stem runs FP in every stage (in
    FQ without its BN and ReLU, as the reference's ``_maybe_fp`` has it)."""
    check_stage("resnet_fp_edges", stage)


def test_resnet_eval_mode_keeps_state_and_agrees():
    """train=False: BN reads its running state and returns it unchanged."""
    x, _ = batch("resnet")
    p, st, qcfg = stage_params("resnet", "q", x)
    # a running state other than init's, so that eval mode reads it
    rng = np.random.default_rng(4)
    st = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(
        np.float32), "var": rng.uniform(0.5, 2, v["var"].shape).astype(
        np.float32)} for k, v in st.items()}
    (jp, js), (tp, ts) = carried(p, st)
    jcfg, tcfg = MODELS["resnet"][2], MODELS["resnet"][3]
    jl, _ = jres.apply(jp, js, jnp.asarray(x), qcfg, jcfg)
    tl, new = tres.apply(tp, ts, torch.from_numpy(x), port_qcfg(qcfg), tcfg)
    assert all(new[k] is ts[k] for k in ts)
    # float32 sums in another order (RTOL_FLOAT of the layer tests)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=RTOL_FLOAT * np.abs(np.asarray(jl)).max())


def test_resnet_to_fq_matches_reference():
    """Every conv with a BN folded, from random BN params and state: the
    weights within RTOL_FLOAT x max|w| (a float32 product by gamma /
    sqrt(var + eps), rsqrt an ulp apart); s_out within 1 ulp (the host's
    correctly rounded log against XLA's, C11, as the calibration test
    holds it); s_w, the log of max|w|, within RTOL_FLOAT (the maxima's
    relative difference) and 1 ulp; every other leaf equal."""
    cfg = MODELS["resnet"][3]
    tp, ts = tres.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    rng = np.random.default_rng(8)
    p = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in tp.items()}
    st = {}
    for k in ts:
        c = p[k]["gamma"].shape
        p[k] = {"gamma": rng.uniform(0.5, 2, c).astype(np.float32),
                "beta": rng.standard_normal(c).astype(np.float32)}
        st[k] = {"mean": rng.standard_normal(c).astype(np.float32),
                 "var": rng.uniform(0.2, 3, c).astype(np.float32)}
    (jp, js), (tp, ts) = carried(p, st)
    want = jres.to_fq(jp, js, MODELS["resnet"][2])
    got = tres.to_fq(tp, ts, cfg)
    assert set(got) == set(want)
    folded = [n for n in got if n + "_bn" in got]
    assert len(folded) == 6  # stem, 2 blocks x (c1, c2), one shortcut
    for name in got:
        for k, a in want[name].items():
            a, b = np.asarray(a), got[name][k].numpy()
            if name not in folded or k == "s_in":
                np.testing.assert_array_equal(b, a, err_msg=f"{name}.{k}")
            elif k == "w":
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=RTOL_FLOAT * np.abs(a).max(),
                    err_msg=name)
            else:
                tol = float(np.spacing(np.float32(abs(a))))
                tol += RTOL_FLOAT if k == "s_w" else 0.0
                assert abs(float(b) - float(a)) <= tol, (name, k, a, b)


FULL = {
    # ResNet-20 at full width (widths 16 / 32 / 64, 3 blocks, 21 convs),
    # stem and head FP (§4.1), B=2: Table 1's first and last stages
    # name: as test_torch_train_fq_full.CASES
    "resnet20_fp": (jres, tres, jres.ResNetConfig.resnet20(),
                    tres.ResNetConfig.resnet20(), (2, 32, 32, 3),
                    JQuantConfig(), False),
    "resnet20_q_w2a2": (jres, tres, jres.ResNetConfig.resnet20(),
                        tres.ResNetConfig.resnet20(), (2, 32, 32, 3),
                        JQuantConfig(2, 2), False),
}


@pytest.mark.parametrize("case", list(FULL))
def test_full_width_resnet20_train_matches_reference(case):
    check_full_width(case, FULL[case])


# ---------------------------------------------------------------------------
# LADDERS and PAPER_NETS
# ---------------------------------------------------------------------------


def test_ladders_are_the_references():
    assert list(tquant.LADDERS) == list(jquant.LADDERS)
    for name, ladder in jquant.LADDERS.items():
        got = tquant.LADDERS[name]
        assert [q.label() for q in got] == [q.label() for q in ladder]
        assert [dataclasses.astuple(q) for q in got] == \
            [dataclasses.astuple(q) for q in ladder], name
        assert all(isinstance(q, tquant.QuantConfig) for q in got)


def test_paper_nets_are_the_references():
    assert list(tnets.PAPER_NETS) == list(jnets.PAPER_NETS)
    fields = [f.name for f in dataclasses.fields(jnets.PaperNet)]
    assert [f.name for f in dataclasses.fields(tnets.PaperNet)] == fields
    for name, want in jnets.PAPER_NETS.items():
        got = tnets.PAPER_NETS[name]
        # the port's model module, namesake of the reference's
        assert got.module.__name__ == want.module.__name__.replace(
            "repro.", "repro_torch.", 1)
        for f in fields:
            a, b = getattr(want, f), getattr(got, f)
            if f == "module":
                continue
            if dataclasses.is_dataclass(a):
                # the port's own config class, field for field equal
                assert type(b) is getattr(got.module, type(a).__name__)
                assert dataclasses.asdict(b) == dataclasses.asdict(a), \
                    (name, f)
            else:
                assert b == a, (name, f)
        assert tnets.ladder_for(got) is tquant.LADDERS[want.ladder]
        assert [q.label() for q in tnets.ladder_for(got)] == \
            [q.label() for q in jnets.ladder_for(want)]
