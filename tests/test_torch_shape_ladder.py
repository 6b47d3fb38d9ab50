"""The serving shape ladders of repro_torch against the JAX reference's.

``repro_torch.serve.shape_ladder`` and the ladder constructors of
``repro_torch.models.frontends`` are numpy copies of the reference's. Seeded
payloads of random rank, spatial size, trailing dim and dtype go through both
ladders; ``normalize`` must give the same arrays (shape, dtype and bytes) or
the same ``None``, ``spec_for`` the same spec and ``target_for`` the same
rung. Malformed ladders and rungs below the models' limits must raise the
same ``ValueError`` with the same message. Everything is exact: crop and pad
do no arithmetic.
"""
import numpy as np
import pytest

from repro.models import darknet as jdn
from repro.models import frontends as jfront
from repro.models import kws as jkws
from repro.serve import shape_ladder as jsl
from repro_torch.models import darknet as tdn
from repro_torch.models import frontends as tfront
from repro_torch.models import kws as tkws
from repro_torch.serve import shape_ladder as tsl

# name: the specs of one ladder, as (kind, rungs, feat)
LADDERS = {
    "frames": [("frames", (16, 24, 32), 8)],
    "image": [("image", (12, (16, 20), (20, 12), 24), 3)],
    "mixed": [("frames", (5, 8), 3), ("image", (6,), 2)],
    "kws_full": [("frames", (140, 180), 39)],
    "darknet_full": [("image", (160, 224), 3)],
}


def _pair(specs):
    return (jsl.ShapeLadder(*[jsl.LadderSpec(*s) for s in specs]),
            tsl.ShapeLadder(*[tsl.LadderSpec(*s) for s in specs]))


def _spec_tuple(spec):
    return None if spec is None else (spec.kind, spec.sizes, spec.feat)


def _payloads(seed, specs, n=40):
    """Seeded payloads: mostly contract matches (so they normalize), some
    wrong trailing dims and ranks (misses), float32 and int8 codes."""
    rng = np.random.default_rng(seed)
    feats = [s[2] for s in specs]
    top = max(max(np.ravel(r)) for s in specs for r in s[1])
    out = []
    for _ in range(n):
        rank = int(rng.integers(1, 5))
        dims = [int(rng.integers(1, top + 12)) for _ in range(rank - 1)]
        feat = int(rng.choice(feats)) if rng.random() < 0.8 \
            else int(rng.integers(1, 10))
        shape = tuple(dims) + (feat,)
        if rng.random() < 0.3:
            x = rng.integers(-8, 8, size=shape).astype(np.int8)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        out.append(x)
    return out


@pytest.mark.parametrize("name", list(LADDERS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_spec_and_target_match_reference(name, seed):
    jl, tl = _pair(LADDERS[name])
    assert tl.shapes == jl.shapes
    hits = 0
    for x in _payloads(seed, LADDERS[name]):
        want, got = jl.normalize(x), tl.normalize(x)
        js, ts = jl.spec_for(x.shape), tl.spec_for(x.shape)
        assert _spec_tuple(ts) == _spec_tuple(js), x.shape
        if want is None:
            assert got is None, x.shape
            continue
        hits += 1
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), x.shape
        assert ts.target_for(x.shape) == js.target_for(x.shape)
    assert hits > 0


@pytest.mark.parametrize("cur,target", [(7, 10), (10, 7), (9, 9), (1, 8),
                                        (11, 4), (5, 6)])
@pytest.mark.parametrize("axis", [0, 1])
def test_center_crop_pad_matches_reference(cur, target, axis):
    shape = [4, 4]
    shape[axis] = cur
    x = np.random.default_rng(cur * 16 + target).standard_normal(
        shape).astype(np.float32)
    want = jsl.center_crop_pad(x, axis, target)
    got = tsl.center_crop_pad(x, axis, target)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert (got is x) == (want is x)


@pytest.mark.parametrize("args", [
    ("cube", (4,), 3),             # unknown kind
    ("frames", (), 3),             # no rung
    ("image", ((4, 4, 4),), 3),    # a rung that is not an (H, W) pair
])
def test_malformed_specs_raise_as_reference(args):
    with pytest.raises(ValueError) as want:
        jsl.LadderSpec(*args)
    with pytest.raises(ValueError) as got:
        tsl.LadderSpec(*args)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tsl.ShapeLadder()


@pytest.mark.parametrize("rungs", [None, (16, 24, 32), (8, 24), (140, 180),
                                   (128, 140)])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_kws_serving_ladder_matches_reference(rungs, size):
    jcfg, tcfg = (jkws.KWSConfig.reduced(), tkws.KWSConfig.reduced()) \
        if size == "reduced" else (jkws.KWSConfig(), tkws.KWSConfig())
    try:
        want = jfront.kws_serving_ladder(jcfg, rungs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfront.kws_serving_ladder(tcfg, rungs)
        assert str(got.value) == str(e)
        return
    assert tfront.kws_serving_ladder(tcfg, rungs).shapes == want.shapes


@pytest.mark.parametrize("sizes", [(12, 16, 20), (2, 16), (4, 16),
                                   (160, 224), (16, (31, 40)), (32, 48)])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_darknet_serving_ladder_matches_reference(sizes, size):
    jcfg, tcfg = (jdn.DarkNetConfig.reduced(), tdn.DarkNetConfig.reduced()) \
        if size == "reduced" else (jdn.DarkNetConfig(), tdn.DarkNetConfig())
    try:
        want = jfront.darknet_serving_ladder(jcfg, sizes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfront.darknet_serving_ladder(tcfg, sizes)
        assert str(got.value) == str(e)
        return
    assert tfront.darknet_serving_ladder(tcfg, sizes).shapes == want.shapes


def test_full_width_limits():
    """The receptive field and pool floor of the full-width nets: KWS
    1 + 2 (1+1+2+4+8+16+32) = 129 frames, DarkNet 2^5 = 32 pixels."""
    cfg = tkws.KWSConfig()
    assert tfront.kws_serving_ladder(cfg, (129,)).shapes == ((129, 39),)
    with pytest.raises(ValueError, match="receptive field 129"):
        tfront.kws_serving_ladder(cfg, (128, 140))
    dcfg = tdn.DarkNetConfig()
    assert tfront.darknet_serving_ladder(dcfg, (32,)).shapes == ((32, 32, 3),)
    with pytest.raises(ValueError, match="min dim >= 32"):
        tfront.darknet_serving_ladder(dcfg, (31, 224))


@pytest.mark.parametrize("name", ["AUDIO_WHISPER_TINY", "VISION_INTERNVL",
                                  "VISION_LLAMA4"])
@pytest.mark.parametrize("positions", [None, (64, 128)])
def test_frontend_serving_ladder_matches_reference(name, positions):
    jcfg, tcfg = getattr(jfront, name), getattr(tfront, name)
    assert (tcfg.kind, tcfg.feat_dim, tcfg.n_positions) == \
        (jcfg.kind, jcfg.feat_dim, jcfg.n_positions)
    assert tfront.frontend_serving_ladder(tcfg, positions).shapes == \
        jfront.frontend_serving_ladder(jcfg, positions).shapes
    assert tfront.frontend_serving_ladder(tfront.FrontendConfig()) is None
