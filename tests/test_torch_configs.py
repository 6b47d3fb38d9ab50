"""``repro_torch.configs`` (the registry, ``base``, ``shapes`` and the ten
arch modules) and the adapters of ``repro_torch.models.frontends``, against
the reference.

Every field of every arch's ``model`` and ``smoke`` config, and of its
``ArchConfig``, equals the reference's, with jnp dtypes mapped to torch
dtypes; the LM shapes, ``applicable`` (run or skip, and the reason) and
``input_specs`` (shapes and dtypes of every input, the decode caches
included, as ``meta`` tensors) likewise. The frontend adapter is the FQ
projection, held against the reference's on carried params.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core.quant import QuantConfig as JQ
from repro.models import frontends as JF
from repro_torch import configs as C
from repro_torch import tree
from repro_torch.models import frontends as F

import torch_zoo_ref as Z
from torch_zoo_ref import one_thread  # noqa: F401 (autouse)


def _same(j, t, path=""):
    """Field-by-field equality of a reference config value and the port's,
    dtypes compared by name."""
    if dataclasses.is_dataclass(j):
        assert dataclasses.is_dataclass(t), path
        jf = [f.name for f in dataclasses.fields(j)]
        assert jf == [f.name for f in dataclasses.fields(t)], path
        for name in jf:
            _same(getattr(j, name), getattr(t, name), f"{path}.{name}")
    elif isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(t, torch.dtype):
        assert jnp.dtype(j).name == str(t).replace("torch.", ""), path
    else:
        assert type(j) is type(t) and j == t, (path, j, t)


def test_arch_ids_and_registry():
    assert C.ARCH_IDS == JC.ARCH_IDS
    assert [a.arch_id for a in C.all_archs()] == C.ARCH_IDS
    assert C.get_arch("minitron-4b") is C.get_arch("minitron-4b")
    with pytest.raises(KeyError, match="available"):
        C.get_arch("gpt-5")


@pytest.mark.parametrize("arch_id", JC.ARCH_IDS)
def test_arch_config_fields(arch_id):
    """model, smoke and the runtime policy (mode, qcfg, serve_bits_w,
    grad_accum, notes), field by field."""
    _same(JC.get_arch(arch_id), C.get_arch(arch_id), arch_id)


@pytest.mark.parametrize("arch_id", JC.ARCH_IDS)
def test_derived_properties(arch_id):
    for which in ("model", "smoke"):
        j, t = (getattr(a.get_arch(arch_id), which) for a in (JC, C))
        assert t.head_dim_ == j.head_dim_
        assert t.attention_free == j.attention_free
        assert t.sub_quadratic == j.sub_quadratic
        jp, jn, jr = j.layer_specs()
        tp, tn, tr = t.layer_specs()
        assert jn == tn and len(jp) == len(tp) and len(jr) == len(tr)


def test_shapes():
    assert C.SHAPE_ORDER == JC.SHAPE_ORDER
    assert list(C.SHAPES) == list(JC.SHAPES)
    for name in JC.SHAPES:
        _same(JC.SHAPES[name], C.SHAPES[name], name)


@pytest.mark.parametrize("arch_id", JC.ARCH_IDS)
def test_applicable(arch_id):
    for name in JC.SHAPE_ORDER:
        want = JC.applicable(JC.get_arch(arch_id).model, JC.SHAPES[name])
        got = C.applicable(C.get_arch(arch_id).model, C.SHAPES[name])
        assert got == want, (arch_id, name)


def _specs(tree_, torch_side):
    if torch_side:
        return [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""),
                 x.is_meta) for n, x in tree.named_leaves(tree_)]
    return [(tuple(x.shape), str(x.dtype))
            for x in jax.tree_util.tree_leaves(tree_)]


@pytest.mark.parametrize("arch_id", JC.ARCH_IDS)
def test_input_specs(arch_id):
    """Every input of every shape's step, at the full model size: shapes
    and dtypes in the reference's leaf order, all ``meta`` on the port."""
    for name in JC.SHAPE_ORDER:
        want = JC.input_specs(JC.get_arch(arch_id).model, JC.SHAPES[name])
        got = C.input_specs(C.get_arch(arch_id).model, C.SHAPES[name])
        assert sorted(got) == sorted(want)
        t = _specs(got, True)
        assert all(m for *_, m in t), (arch_id, name)
        assert [x[1:3] for x in t] == _specs(want, False), (arch_id, name)


# ---------------------------------------------------------------------------
# frontends: adapters and feature specs
# ---------------------------------------------------------------------------

FRONTENDS = {"whisper": JF.AUDIO_WHISPER_TINY, "internvl": JF.VISION_INTERNVL,
             "llama4": JF.VISION_LLAMA4,
             "smoke": JF.FrontendConfig("vision", 32, 8)}


def _tfront(j):
    return F.FrontendConfig(j.kind, j.feat_dim, j.n_positions)


@pytest.mark.parametrize("name", list(FRONTENDS))
def test_feature_spec(name):
    j = FRONTENDS[name]
    want = JF.feature_spec(j, 3)
    got = F.feature_spec(_tfront(j), 3)
    assert got.is_meta and tuple(got.shape) == want.shape
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert F.feature_spec(F.FrontendConfig(), 3) is None


@pytest.mark.parametrize("qname,q", [("fp", JQ()), ("w8a8", JQ(8, 8))])
def test_adapter(qname, q):
    j = FRONTENDS["smoke"]
    jp = JF.init_adapter(jax.random.key(0), j, 40)
    tp = Z.port_params(jp)
    x = np.random.default_rng(1).standard_normal((2, 8, 32)).astype(
        np.float32)
    want, calls = Z.run_reference(
        lambda p, f: JF.apply_adapter(p, f, j, q), jp, jnp.asarray(x))
    got, taps = Z.run_port(
        lambda: F.apply_adapter(tp, torch.from_numpy(x), _tfront(j),
                                Z.tq(q)), calls)
    Z.assert_ties_only(taps, "adapter")
    Z.assert_close(got, want, "adapter", rtol=1e-5)
    assert F.init_adapter(None, F.FrontendConfig(), 40) == {}


def test_synthetic_features_and_port_adapter_init():
    cfg = _tfront(FRONTENDS["smoke"])
    g = torch.Generator().manual_seed(4)
    f = F.synthetic_features(g, cfg, 2)
    assert f.shape == (2, 8, 32) and f.dtype == torch.float32
    again = F.synthetic_features(torch.Generator().manual_seed(4), cfg, 2)
    assert torch.equal(f, again)
    p = F.init_adapter(torch.Generator().manual_seed(0), cfg, 40,
                       torch.bfloat16)
    assert p["adapter"]["w"].shape == (32, 40)
    assert p["adapter"]["w"].dtype == torch.bfloat16
    assert F.synthetic_features(g, F.FrontendConfig(), 2) is None
