"""The port's conv tile policy (``repro_torch.kernels.fq_conv.pick_blocks``)
against the reference's (``repro.kernels.fq_conv``), and K3's split-K on
the CPU.

Both policies read the same table documents, written to ``tmp_path`` and
stamped with the CPU backend (``jax.default_backend()`` here): the port is
given the path through its ``AUTOTUNE_TABLE_PATH`` and ``backend="cpu"``;
the reference's memoized ``AUTOTUNE_TABLE`` / ``MEASURED_KEYS`` globals are
set from the same file by ``monkeypatch``, from the test. Held equal:
explicit knobs, the table overlay, packed borrowing, the ValueErrors, pool
rounding, miss counts and warnings, and replica attribution through both
``CNNBatcher``s in lockstep. The H100 fallback differs by design (the
reference's is a VMEM budget); its own properties are held here.

The split-K plain versions (``kernels.ref.ref_splitk_partials`` and
``ref_splitk_epilogue``, the reduce-plus-epilogue that each cluster of the
split kernel runs) are held against the unsplit plain conv, bit for bit,
and so is ``fq_conv2d`` given a split ``bc`` on the CPU.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fq_conv as jfc
from repro.serve import cnn_batching as jcb
from repro_torch import kernels as tkernels
from repro_torch.core import noise as tnoise
from repro_torch.kernels import fq_conv as tfc
from repro_torch.kernels import ref as tref
from repro_torch.serve import cnn_batching as tcb

CPU = torch.device("cpu")
BACKEND = jax.default_backend()


def _doc(entries, backend=BACKEND):
    return {"format": 1, "backend": backend, "entries": entries}


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """write(doc) puts ``doc`` where both policies read it."""
    path = tmp_path / "autotune_table.json"

    def write(doc):
        path.write_text(json.dumps(doc))
        monkeypatch.setattr(jfc, "AUTOTUNE_TABLE",
                            jfc.load_autotune_table(str(path)))
        monkeypatch.setattr(jfc, "MEASURED_KEYS",
                            jfc.measured_keys(str(path)))
        monkeypatch.setattr(tfc, "AUTOTUNE_TABLE_PATH", str(path))
        jfc.AUTOTUNE_MISSES.clear()
        jfc.AUTOTUNE_MISSES_BY_REPLICA.clear()
        jfc._WARNED_KEYS.clear()
        tfc.reset_autotune_cache()
        return str(path)

    yield write
    jfc.reset_autotune_cache()
    tfc.reset_autotune_cache()


def _both(**kw):
    """(reference, port) pick_blocks on the same arguments."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (jfc.pick_blocks(**kw),
                tfc.pick_blocks(backend="cpu", **kw))


TABLE = [
    {"kh": 3, "kw": 3, "stride": 1, "bho": 16, "bco": 64, "bc": 8},
    {"kh": 1, "kw": 1, "stride": 1, "format": "int8", "bho": 32,
     "bco": 32},
    {"kh": 3, "kw": 1, "stride": 1, "format": "int4", "bco": 45},
    {"kh": 5, "kw": 5, "stride": 2, "bc": 24},
]


# -- explicit knobs, the table, packed borrowing ----------------------------


@pytest.mark.parametrize("fmt", ["int8", "ternary", "int4"])
@pytest.mark.parametrize("pool", [None, (2, 2), (3, 3)])
@pytest.mark.parametrize("bho,bco", [(7, 32), (16, 128), (1, 3)])
def test_explicit_knobs_match_reference(tables, fmt, pool, bho, bco):
    tables(_doc(TABLE))
    cin, bc = {"int8": (48, 16), "ternary": (45, 48), "int4": (45, 46)}[fmt]
    ref, port = _both(ho=17, wo=19, cin=cin, cout=70, kh=3, kw=3,
                      stride=(1, 1), pool=pool, bho=bho, bco=bco, bc=bc,
                      weight_format=fmt)
    assert port == ref


@pytest.mark.parametrize("key,cin,fmt", [
    ((3, 3, 1), 32, "int8"), ((3, 3, 1), 48, "int8"),
    ((1, 1, 1), 64, "int8"), ((5, 5, 2), 96, "int8"), ((5, 5, 2), 20, "int8"),
    ((3, 1, 1), 45, "int4"), ((3, 3, 1), 45, "ternary"),
    ((1, 1, 1), 100, "int4"), ((3, 1, 1), 100, "int8")])
def test_table_overlay_matches_reference(tables, key, cin, fmt):
    """Table entries (and, for packed keys without one, the int8 entry's
    bho / bco) are what both policies return; a table bc is rounded down
    to a divisor of cin. ho is kept under the reference's VMEM halving."""
    tables(_doc(TABLE))
    kh, kw, s = key
    ref, port = _both(ho=8, wo=8, cin=cin, cout=96, kh=kh, kw=kw,
                      stride=(s, s), weight_format=fmt)
    row = next((e for e in TABLE if (e["kh"], e["kw"], e["stride"]) == key
                and e.get("format", "int8") == fmt), None)
    if row is not None and "bc" in row:
        assert port == ref
    else:
        assert port[:2] == ref[:2]          # bho, bco: the table's
        if fmt != "int8":
            assert port[2] == ref[2]        # bc: cin_p


def test_packed_key_borrows_int8_bho_bco(tables):
    tables(_doc(TABLE))
    for fmt in ("ternary", "int4"):
        ref, port = _both(ho=10, wo=10, cin=45, cout=80, kh=3, kw=3,
                          stride=(1, 1), weight_format=fmt)
        assert port == ref == (10, 64, 48 if fmt == "ternary" else 46)


@pytest.mark.parametrize("doc", [
    _doc(TABLE, backend="not-a-backend"),           # another backend
    {"format": 2, "backend": BACKEND, "entries": TABLE},
    _doc([{"kh": "x", "kw": 3, "stride": 1, "bc": 4},  # malformed
          {"kw": 3, "stride": 1}, {"kh": 3, "kw": 3, "stride": 1,
                                   "format": "int2", "bc": 4}]),
    [1, 2, 3]])
def test_foreign_and_malformed_entries_skipped(tables, doc):
    path = tables(doc)
    want = jfc.load_autotune_table(path)
    assert tfc.load_autotune_table(path, backend=BACKEND) == want
    assert tfc.load_autotune_table(path, backend=BACKEND) == \
        {k: dict(v) for k, v in tfc._BUILTIN_TABLE.items()}
    assert tfc.measured_keys(path, backend=BACKEND) == \
        jfc.measured_keys(path)


def test_table_of_another_backend_is_ignored(tables):
    path = tables(_doc(TABLE, backend="cuda"))
    assert tfc.load_autotune_table(path, backend="cuda")[(3, 3, 1, "int8")] \
        == {"bho": 16, "bco": 64, "bc": 8}
    assert tfc.load_autotune_table(path, backend="cpu")[(3, 3, 1, "int8")] \
        == {"bco": 128}
    assert tfc.measured_keys(path, backend="cpu") == set()


def test_missing_or_corrupt_table_gives_builtins(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for p in (str(bad), str(tmp_path / "nope.json")):
        assert tfc.load_autotune_table(p) == jfc.load_autotune_table(p)
        assert tfc.measured_keys(p) == set()


# -- the ValueErrors and pool rounding --------------------------------------


@pytest.mark.parametrize("kw", [
    dict(cin=48, bc=7), dict(cin=48, bc=96), dict(cin=45, bc=44,
                                                  weight_format="ternary"),
    dict(cin=45, bc=45, weight_format="int4")])
def test_bad_bc_raises_like_reference(tables, kw):
    tables(_doc(TABLE))
    args = dict(ho=8, wo=8, cout=16, kh=3, kw=3, stride=(1, 1), **kw)
    with pytest.raises(ValueError):
        jfc.pick_blocks(**args)
    with pytest.raises(ValueError):
        tfc.pick_blocks(backend="cpu", **args)


@pytest.mark.parametrize("bho,pool", [(5, (2, 2)), (1, (2, 2)), (7, (3, 3)),
                                      (None, (2, 2)), (None, (3, 2))])
def test_pool_rounds_bho_like_reference(tables, bho, pool):
    tables(_doc(TABLE))
    ref, port = _both(ho=17, wo=17, cin=8, cout=16, kh=3, kw=3,
                      stride=(1, 1), pool=pool, bho=bho, bc=8)
    assert port[0] == ref[0] and port[0] % pool[0] == 0


def test_fq_conv2d_on_cpu_validates_bc():
    a = torch.zeros(1, 6, 6, 12, dtype=torch.int8)
    w = torch.zeros(9 * 12, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="must divide"):
        tfc.fq_conv2d(a, w, torch.tensor(0.1), kh=3, kw=3, bc=5)
    got = tfc.fq_conv2d(a, w, torch.tensor(0.1), kh=3, kw=3, bc=4)
    assert got.shape == (1, 4, 4, 4)
    wt = torch.zeros(9, 4, dtype=torch.uint8)   # 3 taps x 12 / 4
    with pytest.raises(ValueError, match="bc == cin"):
        tfc.fq_conv1d(a[:, :, 0], wt, torch.tensor(0.1), ksize=3,
                      weight_format="ternary", bc=6)
    assert tfc.fq_conv1d(a[:, :, 0], wt, torch.tensor(0.1), ksize=3,
                         weight_format="ternary", bc=12).shape == (1, 4, 4)


# -- misses: counted, warned once per key, attributed to replicas ----------


CALLS = [dict(kh=3, kw=3, stride=(1, 1), cin=8),
         dict(kh=5, kw=5, stride=(1, 1), cin=8),
         dict(kh=5, kw=5, stride=(1, 1), cin=8, bho=4, bco=8, bc=8),
         dict(kh=5, kw=5, stride=(1, 1), cin=8),
         dict(kh=1, kw=1, stride=(1, 1), cin=8, weight_format="ternary"),
         dict(kh=3, kw=1, stride=(1, 1), cin=8, weight_format="int4"),
         dict(kh=3, kw=1, stride=(1, 1), cin=8, weight_format="int4",
              bho=2, bco=2),
         dict(kh=7, kw=7, stride=(2, 2), cin=8)]


@pytest.mark.parametrize("n_calls", [1, 4, len(CALLS)])
def test_miss_counts_and_warnings_match_reference(tables, n_calls):
    tables(_doc(TABLE))
    seen = {}
    for name, mod, extra in (("ref", jfc, {}), ("port", tfc,
                                                {"backend": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for call in CALLS[:n_calls]:
                mod.pick_blocks(ho=8, wo=8, cout=8, **call, **extra)
        keys = [x.message.key for x in w
                if isinstance(x.message, mod.AutotuneMissWarning)]
        backends = {x.message.backend for x in w
                    if isinstance(x.message, mod.AutotuneMissWarning)}
        seen[name] = (dict(mod.AUTOTUNE_MISSES), keys, backends)
    assert seen["port"] == seen["ref"]
    assert len(seen["port"][1]) == len(set(seen["port"][1]))  # once a key


def test_fully_explicit_knobs_never_consult_the_table(tables):
    tables(_doc([]))
    tfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=3, kw=3, stride=(1, 1),
                    bho=8, bco=8, bc=8, backend="cpu")
    tfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=3, kw=3, stride=(1, 1),
                    bho=8, bco=8, weight_format="ternary", backend="cpu")
    assert tfc.AUTOTUNE_MISSES == {}


def test_reset_clears_misses_warnings_and_replica_tags(tables):
    tables(_doc([]))
    with pytest.warns(tfc.AutotuneMissWarning):
        with tfc.replica_scope(3):
            tfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=3, kw=3,
                            stride=(1, 1), backend="cpu")
    assert tfc.AUTOTUNE_MISSES_BY_REPLICA == {(3, (3, 3, 1, "int8")): 1}
    assert tfc._REPLICA_TAG[0] is None
    tfc.reset_autotune_cache()
    assert tfc.AUTOTUNE_MISSES == {} and tfc.AUTOTUNE_MISSES_BY_REPLICA == {}
    with pytest.warns(tfc.AutotuneMissWarning):   # warned again after reset
        tfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=3, kw=3,
                        stride=(1, 1), backend="cpu")


def _toy_ref():
    """A reference step, a closure of its own (jit traces each apart), that
    consults the policy for a key of its batch's shape."""
    def step(x):
        jfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=x.shape[1],
                        kw=x.shape[1], stride=(1, 1))
        return x.sum(axis=tuple(range(1, x.ndim))) + 0.5
    return step


def _toy_port():
    def step(x):
        tfc.pick_blocks(ho=8, wo=8, cin=8, cout=8, kh=x.shape[1],
                        kw=x.shape[1], stride=(1, 1), backend="cpu")
        return x.sum(dim=tuple(range(1, x.ndim))) + 0.5
    step.device = CPU
    return step


@pytest.mark.parametrize("mode", ["sync", "ahead"])
def test_replica_attribution_matches_reference_batcher(tables, mode):
    """Both batchers, two lanes with a step of their own each, serve one
    seeded trace of three request shapes in lockstep; each step consults
    its policy for a key of the batch's shape. The lanes that met each
    key's misses are the same; the reference records once per trace, the
    port once per eager step, so its counts are the flushes and never
    fewer."""
    tables(_doc([{"kh": 3, "kw": 3, "stride": 1, "bc": 8}]))
    rng = np.random.default_rng(11)
    shapes = [(3, 3), (5, 5), (3, 3), (1, 1)]
    kw = dict(max_batch=4, max_wait_ticks=1, max_inflight=2,
              dispatch_ahead=mode == "ahead", n_replicas=2)
    jfns, tfns = [_toy_ref(), _toy_ref()], [_toy_port(), _toy_port()]
    jb = jcb.CNNBatcher(jfns[0], replica_apply_fns=jfns, **kw)
    tb = tcb.CNNBatcher(tfns[0], replica_apply_fns=tfns, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tick in range(12):
            batch = [rng.standard_normal(shapes[int(i)]).astype(np.float32)
                     for i in rng.integers(0, len(shapes), size=3)]
            jb.submit([jcb.CNNRequest(rid=100 * tick + i, x=x)
                       for i, x in enumerate(batch)])
            tb.submit([tcb.CNNRequest(rid=100 * tick + i, x=x)
                       for i, x in enumerate(batch)])
            assert jb.tick() == tb.tick()
        for _ in range(50):
            if not jb.outstanding():
                break
            assert jb.tick() == tb.tick()
    assert jb.outstanding() == tb.outstanding() == 0
    assert tb.stats == jb.stats
    ref, port = jfc.AUTOTUNE_MISSES_BY_REPLICA, tfc.AUTOTUNE_MISSES_BY_REPLICA
    assert set(port) == set(ref) and ref
    assert {lane for lane, _ in port} == {0, 1}
    assert all(port[k] >= ref[k] for k in ref)
    assert sum(port.values()) == sum(tfc.AUTOTUNE_MISSES.values())
    assert (3, 3, 1, "int8") not in tfc.AUTOTUNE_MISSES   # measured


def test_batcher_step_runs_in_its_lanes_replica_scope():
    tags = []

    def step(x):
        tags.append(tfc._REPLICA_TAG[0])
        return x.sum(dim=tuple(range(1, x.ndim)))

    step.device = CPU
    b = tcb.CNNBatcher(step, replica_apply_fns=[step, step], n_replicas=2,
                       max_batch=2, max_wait_ticks=0, dispatch_ahead=True)
    for i in range(4):
        b.submit([tcb.CNNRequest(rid=i, x=np.zeros((2, 2), np.float32))])
        b.tick()
    b.drain()
    assert set(tags) == {0, 1} and tfc._REPLICA_TAG[0] is None


# -- the H100 fallback's own properties -------------------------------------


FALLBACK_SHAPES = [
    # (batch, side, cin, cout, ksize): DarkNet-19's convs at 224 and odd ones
    (b, side, cin, cout, ks) for b in (1, 2, 8)
    for side, cin, cout, ks in [(112, 32, 64, 3), (56, 64, 128, 3),
                                (56, 128, 64, 1), (28, 128, 256, 3),
                                (28, 256, 128, 1), (14, 256, 512, 3),
                                (14, 512, 256, 1), (7, 512, 1024, 3),
                                (7, 1024, 512, 1), (5, 96, 80, 3),
                                (3, 100, 45, 3), (9, 45, 48, 1)]]


@pytest.mark.parametrize("sms", [132, 16])
def test_fallback_properties(tables, sms):
    tables(_doc([]))
    for b, side, cin, cout, ks in FALLBACK_SHAPES:
        kw = dict(ho=side, wo=side, cin=cin, cout=cout, kh=ks, kw=ks,
                  stride=(1, 1), batch=b, backend="cpu", sms=sms)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, _, bc = tfc.pick_blocks(**kw)
            assert tfc.pick_blocks(**kw) == tfc.pick_blocks(**kw)
            for fmt in ("ternary", "int4"):
                f = 4 if fmt == "ternary" else 2
                assert tfc.pick_blocks(**kw, weight_format=fmt)[2] == \
                    -(-cin // f) * f
            assert tfc.pick_blocks(**kw, pool=(2, 2))[2] == cin
        assert cin % bc == 0
        split = cin // bc
        tiles = -(-(b * side * side) // 64) * -(-cout // 64)
        if tiles >= sms:
            assert split == 1
        if split > 1:
            assert ks * ks * bc >= tfc.SPLIT_MIN_STAGES * tfc.TILE_K
            assert tiles * split <= tfc.SPLIT_MAX_WAVES * sms
            assert cin % 16 or bc % 16 == 0


def test_fallback_splits_darknets_late_convs():
    """At B=1 the 7 x 7 convs (16 and 8 tiles) split; at B=8 DarkNet's
    large early convs do not."""
    f = tfc.split_fallback
    assert 512 // f(m=49, cin=512, cout=1024, kh=3, kw=3) == 8
    assert 1024 // f(m=49, cin=1024, cout=512, kh=1, kw=1) == 2
    assert 512 // f(m=8 * 49, cin=512, cout=1024, kh=3, kw=3) == 2
    assert f(m=8 * 56 * 56, cin=64, cout=128, kh=3, kw=3) == 64


def test_smem_footprint_fits_the_budget():
    assert tfc.smem_footprint() == 61_440 <= tfc.SMEM_BUDGET


# -- split-K on the CPU: the plain reduce-plus-epilogue, the wrapper --------


def _noise(chunks):
    if chunks is None:
        return {}
    return dict(noise_sigma_acc=torch.tensor(3.5),
                noise_seed=torch.tensor(4107458132, dtype=torch.uint32),
                mac_chunks=chunks)


@pytest.mark.parametrize("bc", [48, 24, 16, 8, 3, 1])
@pytest.mark.parametrize("epilogue,lo", [("requant", 0), ("requant", -7),
                                         ("dequant", 0)])
@pytest.mark.parametrize("chunks", [None, 1, 4])
def test_splitk_plain_equals_unsplit_plain(bc, epilogue, lo, chunks):
    rng = np.random.default_rng(bc * 7 + lo)
    a = torch.from_numpy(rng.integers(0, 8, size=(2, 9, 7, 48)).astype(
        np.int8))
    w = torch.from_numpy(rng.integers(-7, 8, size=(9 * 48, 37)).astype(
        np.int8))
    s = torch.tensor(np.float32(0.0131))
    kw = dict(kh=3, kw=3, stride=(2, 1), padding=(1, 1), dilation=(1, 2))
    want = tref.ref_fq_conv2d(a, w, s, epilogue=epilogue, n_out=7, lo=lo,
                              **kw, **_noise(chunks))
    parts = tref.ref_splitk_partials(a, w, bc=bc, **kw)
    assert parts.shape == (48 // bc, want[..., 0].numel(), 37)
    assert parts.dtype == torch.int32
    got = tref.ref_splitk_epilogue(parts, s, epilogue=epilogue, n_out=7,
                                   lo=lo, **_noise(chunks))
    assert torch.equal(got.reshape(want.shape), want)
    tkernels.reset_launch_counts()
    wrapped = tfc.fq_conv2d(a, w, s, bc=bc, epilogue=epilogue, n_out=7,
                            lo=lo, **kw, **_noise(chunks))
    assert torch.equal(wrapped, want)
    assert tkernels.split_launch_counts() == {"fq_conv2d_splitk": 0}


def test_splitk_plain_matches_reference_oracle():
    """One split conv against the reference's im2col oracle (jax)."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(3)
    a = rng.integers(0, 16, size=(2, 7, 7, 64)).astype(np.int8)
    w = rng.integers(-7, 8, size=(9 * 64, 40)).astype(np.int8)
    want = np.asarray(jops.fq_conv2d_int(
        jnp.asarray(a), jnp.asarray(w), jnp.float32(0.02), ksize=3,
        padding=1, n_out=15, impl="im2col"))
    parts = tref.ref_splitk_partials(torch.from_numpy(a), torch.from_numpy(w),
                                     kh=3, kw=3, bc=16, padding=(1, 1))
    got = tref.ref_splitk_epilogue(parts, torch.tensor(np.float32(0.02)),
                                   n_out=15)
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_splitk_noise_field_is_the_unsplit_one():
    """The epilogue pass draws the field at the conv output's global index,
    as the unsplit conv does."""
    m, n = 5, 9
    parts = torch.zeros(3, m, n, dtype=torch.int32)
    got = tref.ref_splitk_epilogue(parts, torch.tensor(1.0),
                                   epilogue="dequant", **_noise(2))
    field = tnoise.mac_noise_field(tnoise.output_index(m, n, CPU),
                                   torch.tensor(4107458132,
                                                dtype=torch.uint32),
                                   torch.tensor(3.5), chunks=2)
    assert torch.equal(got, torch.zeros(m, n) + field)


def test_split_conv_refuses_bad_knobs():
    """fq_conv2d checks a split's knobs on every device: a bc that does not
    divide Cin, a noise sigma without its seed."""
    a = torch.zeros(1, 5, 5, 48, dtype=torch.int8)
    w = torch.zeros(9 * 48, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="must divide"):
        tfc.fq_conv2d(a, w, torch.tensor(1.0), kh=3, kw=3, bc=20)
    with pytest.raises(ValueError, match="noise_seed"):
        tfc.fq_conv2d(a, w, torch.tensor(1.0), kh=3, kw=3, bc=16,
                      noise_sigma_acc=1.0)
