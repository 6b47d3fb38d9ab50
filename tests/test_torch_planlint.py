"""The port's ``analysis.planlint`` and ``analysis.report``, its stack
placement (``place_stack``, ``replicate_stack``) and
``launch.mesh.replica_devices``, against the reference.

The stacks: reduced KWS and DarkNet, int8, int4 and ternary. Their float
params come from the port's own ``init`` -> ``to_fq`` (a uniform s_out of
0.1 tied along the chain, the repo's stand-in recipe), as numpy; the
reference converts them (``convert_int``) and the port carries the
reference's stack over with ``interop``, so both linters read the same
artifact. Each check runs on both sides and must give the reference's
findings: check, subject and severity, in order (messages too where they
hold no framework repr). The mutations are ``test_analysis_mutations.py``'s:
a code out of range, a packed field that decodes to -2, a rescale of 0,
inf or a denormal, a wrong static, a static that is an array, a format
mismatch, a stale rescale against its params, a stale decode scale, a
non-terminal final layer, a dropped pool, a non-monotone fused pool, a
seed collision, a broken hand-off. The integer LM's residual-DAG hand-off
(``lint_handoff_edges``) is held on the port's reduced LM stand-in, intact
and with one broken edge, and the LM stack's ``lint_stack`` findings too.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import has_cuda, interop
from repro_torch.analysis import planlint
from repro_torch.analysis.report import Report, Severity, Suppression
from repro_torch.core import integer_inference as tii
from repro_torch.core import integer_inference as ii
from repro_torch.core.quant import QuantConfig
from repro_torch.launch import mesh
from repro_torch.models import darknet as tdn
from repro_torch.models import fq_lm as tlm
from repro_torch.models import kws as tkws
from repro_torch.serve.fleet import ModelSLO

try:
    import jax
    import jax.numpy as jnp
    from repro.analysis import planlint as jplanlint
    from repro.analysis.report import Report as JReport
    from repro.core import integer_inference as jii
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.models import darknet as jdn
    from repro.models import fq_lm as jlm
    from repro.models import kws as jkws
    from repro.serve import fleet as jfleet
except ImportError:  # the card's machine has no jax: -m cuda runs alone
    jax = None

QCFG = QuantConfig(2, 4, 4, fq=True)
if jax is not None:
    JQCFG = JQuantConfig(2, 4, 4, fq=True)
    MODELS = {"kws": (jkws, tkws, jkws.KWSConfig.reduced(),
                      tkws.KWSConfig.reduced()),
              "darknet": (jdn, tdn, jdn.DarkNetConfig.reduced(),
                          tdn.DarkNetConfig.reduced())}
else:
    MODELS = {"kws": (None, tkws, None, tkws.KWSConfig.reduced()),
              "darknet": (None, tdn, None, tdn.DarkNetConfig.reduced())}
FORMATS = ("int8", "int4", "ternary")
S_OUT = 0.1


def _np(tree):
    """Tensors and arrays in nested dicts / tuples / lists -> numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if jax is not None and isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def chain_names(model):
    """The names the stand-in ties (every conv: DarkNet's FP conv0 too)."""
    tmod, cfg = MODELS[model][1], MODELS[model][3]
    if model == "kws":
        return tkws.conv_names(cfg)
    return [f"conv{i}" for i in
            range(len([l for l in cfg.layers if l != "M"]))]


@functools.lru_cache(maxsize=None)
def standin(model):
    """(numpy FQ params, numpy BN state) of the port's seeded stand-in."""
    tmod, cfg = MODELS[model][1], MODELS[model][3]
    p, st = tmod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    p = tmod.to_fq(p, st, cfg)
    names = chain_names(model)
    for n in names:
        p[n] = {**p[n], "s_out": torch.tensor(S_OUT)}
    p = ii.sync_handoff(p, names)
    return _np(p), _np(st)


def port_stack(model, fmt="int8", device="cpu"):
    """The port's own conversion of the stand-in (no reference needed)."""
    tmod, cfg = MODELS[model][1], MODELS[model][3]
    p, st = interop.params_from_numpy(*standin(model), device=device)
    return tmod.convert_int(p, st, QCFG, cfg, weight_format=fmt), p, st


@functools.lru_cache(maxsize=None)
def stacks(model, fmt="int8"):
    """(reference stack, the port's carried copy, port params, port
    state)."""
    jmod, _, jcfg, _ = MODELS[model]
    p, st = standin(model)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, (p, st))
    ip = jmod.convert_int(jp, jst, JQCFG, jcfg, weight_format=fmt)
    carried = interop.stack_from_numpy(
        _np(ip.layers), _np(ip.extras), ip.qcfg, ip.specs,
        entry_inv_scale=(np.asarray(jnp.exp(-ip["entry"]["s_in"]))
                         if "entry" in ip.extras else None),
        device="cpu")
    tp, tst = interop.params_from_numpy(p, st, device="cpu")
    return ip, carried, tp, tst


def findings(report):
    return [(f.check, f.subject, int(f.severity)) for f in report.findings]


def proofs(report):
    return [(p["check"], p["subject"]) for p in report.proofs]


def same(jrep, trep, messages=True):
    assert findings(trep) == findings(jrep)
    assert proofs(trep) == proofs(jrep)
    if messages:
        assert [f.message for f in trep.findings] == \
            [f.message for f in jrep.findings]


def jmutated(stack, name, specs=None, **kv):
    layers = {n: dict(d) for n, d in stack.layers.items()}
    layers[name].update(kv)
    return jii.ConvertedStack(stack.qcfg, specs or stack.specs, layers,
                              dict(stack.extras))


def tmutated(stack, name, specs=None, **kv):
    layers = {n: dict(d) for n, d in stack.layers.items()}
    layers[name].update(kv)
    return tii.ConvertedStack(stack.qcfg, specs or stack.specs, layers,
                              dict(stack.extras))


def _jp(params):
    return {n: jax.tree_util.tree_map(jnp.asarray, _np(v))
            for n, v in params.items()}


# -- clean stacks ------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("model", list(MODELS))
def test_clean_stack_findings_equal_reference(model, fmt):
    """lint_handoff, lint_stack (with its params), lint_noise_seeds and,
    for DarkNet, lint_fused_pools: no finding, the reference's proofs."""
    jmod, tmod, jcfg, tcfg = MODELS[model]
    ip, st, tp, _ = stacks(model, fmt)
    names = list(st.layer_names)
    jrep, trep = JReport(), Report()
    jplanlint.lint_handoff(_jp({n: tp[n] for n in names}), names, jrep, model)
    planlint.lint_handoff(tp, names, trep, model)
    jplanlint.lint_stack(ip, jrep, model,
                         layer_params=_jp({n: tp[n] for n in names}))
    planlint.lint_stack(st, trep, model, layer_params=tp)
    jplanlint.lint_noise_seeds(names, jrep, model)
    planlint.lint_noise_seeds(names, trep, model)
    if model == "darknet":
        n_m = sum(1 for l in tcfg.layers if l == "M")
        jplanlint.lint_fused_pools(jdn.layer_plan(jcfg), n_m, jrep, model,
                                   stack=ip)
        planlint.lint_fused_pools(tdn.layer_plan(tcfg), n_m, trep, model,
                                  stack=st)
    assert not trep.findings and trep.proofs
    same(jrep, trep)
    assert [p["statement"] for p in trep.proofs] == \
        [p["statement"] for p in jrep.proofs]


def test_noise_seeds_collide_nowhere_on_many_layers():
    """The key schedule over 64 layers and 4 base seeds: distinct seeds,
    and the port's proof is the reference's."""
    names = [f"l{i}" for i in range(64)]
    jrep, trep = JReport(), Report()
    jplanlint.lint_noise_seeds(names, jrep, "deep", base_seeds=(0, 1, 2, 3))
    planlint.lint_noise_seeds(names, trep, "deep", base_seeds=(0, 1, 2, 3))
    same(jrep, trep)
    assert not trep.findings


# -- mutations ---------------------------------------------------------------

def _code_out_of_range(stack, name, arr):
    bad = np.array(_np(stack.layers[name]["w_codes"]), copy=True)
    bad.flat[0] = 100 if bad.dtype == np.int8 else 0b10
    return arr(bad)


# (id, format, layer index in the chain, what it mutates to, whether the
# stale-params check runs, expected check); the value makers take the
# side's array constructor
MUTATIONS = [
    ("zero-rescale", "int8", 1, lambda s, n, a: {"rescale": a(np.float32(0))},
     False, "planlint/rescale"),
    ("inf-rescale", "int8", 1,
     lambda s, n, a: {"rescale": a(np.float32(np.inf))}, False,
     "planlint/rescale"),
    ("denormal-rescale", "int8", 1, lambda s, n, a: {"rescale": 1e-42},
     False, "planlint/rescale"),
    ("tiny-rescale", "int8", 1,
     lambda s, n, a: {"rescale": a(np.float32(1e-30))}, False,
     "planlint/rescale"),
    ("stale-rescale", "int8", 1, lambda s, n, a: {"rescale": a(np.float32(
        2 * float(_np(s.layers[n]["rescale"]))))}, True,
     "planlint/rescale"),
    ("wrong-static", "int8", 0, lambda s, n, a: {"n_out": 31}, False,
     "planlint/static-aux"),
    ("code-range", "int8", 0,
     lambda s, n, a: {"w_codes": _code_out_of_range(s, n, a)}, False,
     "planlint/code-range"),
    ("packed-field-minus-two", "ternary", 0,
     lambda s, n, a: {"w_codes": _code_out_of_range(s, n, a)}, False,
     "planlint/code-range"),
    ("format-mismatch", "ternary", 0, lambda s, n, a: {
        "weight_format": "int4"}, False, "planlint/weight-format"),
    ("unknown-format", "int4", 0, lambda s, n, a: {
        "weight_format": "int2"}, False, "planlint/weight-format"),
]


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize(
    "fmt,index,mutate,with_params,check",
    [m[1:] for m in MUTATIONS], ids=[m[0] for m in MUTATIONS])
def test_stack_mutation_findings_equal_reference(model, fmt, index, mutate,
                                                 with_params, check):
    ip, st, tp, _ = stacks(model, fmt)
    name = ip.layer_names[index]
    jbad = jmutated(ip, name, **mutate(ip, name, jnp.asarray))
    tbad = tmutated(st, name, **mutate(st, name, torch.as_tensor))
    jrep, trep = JReport(), Report()
    kw = {}
    if with_params:
        kw = {"layer_params": {n: tp[n] for n in st.layer_names}}
        jplanlint.lint_stack(jbad, jrep, "mut", layer_params=_jp(
            kw["layer_params"]))
    else:
        jplanlint.lint_stack(jbad, jrep, "mut")
    planlint.lint_stack(tbad, trep, "mut", **kw)
    assert check in {f.check for f in trep.findings}
    assert trep.exit_code() == 1
    same(jrep, trep)


@pytest.mark.parametrize("model", list(MODELS))
def test_array_static_and_mid_chain_final_caught_as_reference(model):
    """A quantizer static that is an array (it would specialize the kernel)
    and final=True on a non-terminal layer: the reference's findings (the
    message of the first holds each framework's repr, so only check,
    subject and severity are compared)."""
    ip, st, _, _ = stacks(model)
    name = ip.layer_names[0]
    jrep, trep = JReport(), Report()
    jplanlint.lint_stack(jmutated(ip, name, n_w=jnp.int32(1)), jrep, "mut")
    planlint.lint_stack(tmutated(st, name, n_w=torch.tensor(1)), trep, "mut")
    assert "planlint/static-aux" in {f.check for f in trep.findings}
    same(jrep, trep, messages=False)
    jspecs = list(ip.specs)
    jspecs[0] = jii.LayerSpec(jspecs[0].name, final=True)
    tspecs = list(st.specs)
    tspecs[0] = tii.LayerSpec(tspecs[0].name, final=True)
    jrep, trep = JReport(), Report()
    jplanlint.lint_stack(jmutated(ip, name, specs=jspecs), jrep, "mut")
    planlint.lint_stack(tmutated(st, name, specs=tspecs), trep, "mut")
    assert "planlint/spec-mismatch" in {f.check for f in trep.findings}
    same(jrep, trep)


@pytest.mark.parametrize("model", list(MODELS))
def test_stale_decode_scale_and_broken_handoff_caught(model):
    ip, st, tp, _ = stacks(model)
    names = list(st.layer_names)
    jbad, tbad = jmutated(ip, names[0]), tmutated(st, names[0])
    jbad.extras["s_out_last"] = jnp.float32(7.7)
    tbad.extras["s_out_last"] = torch.tensor(7.7)
    lp = {n: tp[n] for n in names}
    jrep, trep = JReport(), Report()
    jplanlint.lint_stack(jbad, jrep, "mut", layer_params=_jp(lp))
    planlint.lint_stack(tbad, trep, "mut", layer_params=lp)
    assert "planlint/handoff" in {f.check for f in trep.findings}
    same(jrep, trep)
    broken = {n: dict(v) for n, v in lp.items()}
    broken[names[1]]["s_in"] = torch.tensor(0.9)
    jrep, trep = JReport(), Report()
    jplanlint.lint_handoff(_jp(broken), names, jrep, "mut")
    planlint.lint_handoff(broken, names, trep, "mut")
    assert findings(trep) == [("planlint/handoff", f"mut/{names[1]}",
                               int(Severity.ERROR))]
    same(jrep, trep)


def test_fused_pool_mutations_caught():
    """A dropped pool, and a pool fused into a non-monotone epilogue."""
    _, _, jcfg, tcfg = MODELS["darknet"]
    ip, st, _, _ = stacks("darknet")
    n_m = sum(1 for l in tcfg.layers if l == "M")
    jplan, tplan = jdn.layer_plan(jcfg), tdn.layer_plan(tcfg)
    jrep, trep = JReport(), Report()
    jplanlint.lint_fused_pools(jplan, n_m + 1, jrep, "mut", stack=ip)
    planlint.lint_fused_pools(tplan, n_m + 1, trep, "mut", stack=st)
    assert "planlint/fused-pool" in {f.check for f in trep.findings}
    same(jrep, trep)
    pooled = [s[1] for s in tplan if s[0] == "conv" and s[3]]
    assert pooled
    jrep, trep = JReport(), Report()
    jplanlint.lint_fused_pools(
        jplan, n_m, jrep, "mut",
        stack=jmutated(ip, pooled[0], rescale=jnp.float32(-1.0)))
    planlint.lint_fused_pools(
        tplan, n_m, trep, "mut",
        stack=tmutated(st, pooled[0], rescale=torch.tensor(-1.0)))
    assert findings(trep) == [("planlint/fused-pool", f"mut/{pooled[0]}",
                               int(Severity.ERROR))]
    same(jrep, trep)


def test_seed_values_collision_caught():
    jrep, trep = JReport(), Report()
    jplanlint.lint_seed_values([7, 8, 7], ["c0", "c1", "c2"], jrep, "mut")
    planlint.lint_seed_values([7, 8, 7], ["c0", "c1", "c2"], trep, "mut")
    assert trep.findings[0].details["layers"] == ["c0", "c2"]
    same(jrep, trep)


def test_lint_fleet_over_real_stacks_equals_reference():
    """A registry of both reduced stacks (clean); then a duplicate name, a
    shared canary seed, an unsatisfiable deadline and a stack with a zero
    rescale: the reference's findings in order."""
    kip, kst, _, _ = stacks("kws")
    dip, dst, _, _ = stacks("darknet", "ternary")
    slo = ModelSLO()
    jslo = jfleet.ModelSLO()
    name = kip.layer_names[1]
    for entries, jentries, stuck in (
            ([("kws", slo, 1, kst), ("dn", slo, 2, dst)],
             [("kws", jslo, 1, kip), ("dn", jslo, 2, dip)], 0),
            ([("kws", slo, 1, kst), ("kws", slo, 1, dst),
              ("bad", ModelSLO(deadline_ticks=3), 5,
               tmutated(kst, name, rescale=torch.tensor(0.0)))],
             [("kws", jslo, 1, kip), ("kws", jslo, 1, dip),
              ("bad", jfleet.ModelSLO(deadline_ticks=3), 5,
               jmutated(kip, name, rescale=jnp.float32(0.0)))], 2)):
        jrep, trep = JReport(), Report()
        jplanlint.lint_fleet(jentries, jrep, max_stuck_ticks=stuck)
        planlint.lint_fleet(entries, trep, max_stuck_ticks=stuck)
        same(jrep, trep)
    assert {"planlint/fleet-name", "planlint/fleet-seed",
            "planlint/fleet-slo", "planlint/rescale"} <= \
        {f.check for f in trep.findings}


def test_report_gate_suppressions_and_json(tmp_path):
    """The report copy: suppressions need a reason and move findings to
    ``suppressed``; the exit-code gate; the JSON artifact."""
    with pytest.raises(ValueError, match="reason"):
        Suppression("planlint/*", "kws/*", " ")
    r = Report([Suppression("planlint/handoff", "kws/*", "known stale")])
    assert r.error("planlint/handoff", "kws/conv1", "mismatch") is None
    r.warning("planlint/rescale", "darknet/conv2", "small", value=1e-9)
    assert r.exit_code() == 1 and r.exit_code(Severity.ERROR) == 0
    assert r.worst() == Severity.WARNING
    r.write_json(str(tmp_path / "r.json"))
    doc = __import__("json").loads((tmp_path / "r.json").read_text())
    assert doc["summary"]["suppressed"] == 1
    assert doc["findings"][0]["severity"] == "warning"
    assert "analysis: 1 finding(s) (1 suppressed)" in r.render_text()


# -- placement ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("model", list(MODELS))
def test_place_and_replicate_keep_digest_and_statics(model, fmt):
    ip, st, _, _ = stacks(model, fmt)
    digest = tii.stack_digest(st)
    assert digest == jii.stack_digest(ip)
    placed = tii.place_stack(st, "cpu")
    copies = tii.replicate_stack(st, mesh.replica_devices(3, device="cpu"))
    for s in [placed] + copies:
        assert tii.stack_digest(s) == digest
        for n in st.layer_names:
            for k in ("n_out", "lo", "n_w", "n_a", "weight_format"):
                assert s[n][k] == st[n][k]
                assert type(s[n][k]) is type(st[n][k])
    # replicas own their buffers; placement on the same device shares them
    ptrs = {c[st.layer_names[0]]["w_codes"].data_ptr() for c in copies}
    assert len(ptrs) == 3
    assert st[st.layer_names[0]]["w_codes"].data_ptr() not in ptrs
    assert placed[st.layer_names[0]]["w_codes"].data_ptr() == \
        st[st.layer_names[0]]["w_codes"].data_ptr()


def test_replica_devices():
    assert mesh.replica_devices(3, device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        mesh.replica_devices(0, device="cpu")


def test_replica_devices_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.replica_devices(2)


@pytest.mark.cuda
@pytest.mark.skipif(not has_cuda(), reason="needs a CUDA device")
def test_place_stack_cpu_to_cuda_and_back():
    """The port's own ternary DarkNet stack (no reference on the card's
    machine): CPU -> card -> CPU keeps the digest; two replicas on one card
    own their buffers; the placed stack lints clean."""
    st, _, _ = port_stack("darknet", "ternary")
    on_card = tii.place_stack(st, "cuda")
    assert on_card.device.type == "cuda"
    back = tii.place_stack(on_card, "cpu")
    assert tii.stack_digest(on_card) == tii.stack_digest(back) == \
        tii.stack_digest(st)
    two = tii.replicate_stack(on_card, mesh.replica_devices(2))
    assert [s.device.type for s in two] == ["cuda", "cuda"]
    assert two[0]["conv1"]["w_codes"].data_ptr() != \
        two[1]["conv1"]["w_codes"].data_ptr()
    rep = Report()
    planlint.lint_stack(on_card, rep, "card")
    assert not rep.findings


# -- the integer LM's residual-DAG hand-off ------------------------------------

LM_CFG = tlm.FQLMConfig.reduced()


@functools.lru_cache(maxsize=None)
def lm_standin():
    """numpy float params of the port's reduced LM stand-in."""
    return _np(tlm.standin_params(torch.Generator().manual_seed(0), LM_CFG,
                                  device="cpu"))


@pytest.mark.parametrize("broken", [None, "wo1.s_out", "wk0.s_in",
                                    "down0.s_out", "down1.s_in"])
def test_lint_handoff_edges_equals_reference(broken):
    """Every edge holds on the tied stand-in (one proof); one broken scale
    gives the reference's findings, subject by subject, message by
    message."""
    p = lm_standin()
    if broken:
        name, key = broken.split(".")
        p = {**p, name: {**p[name], key: np.float32(0.9)}}
    tp, _ = interop.params_from_numpy(p, {}, device="cpu")
    jrep, trep = JReport(), Report()
    jplanlint.lint_handoff_edges(_jp(p), jlm.handoff_edges(
        jlm.FQLMConfig.reduced()), jrep, "lm")
    planlint.lint_handoff_edges(tp, tlm.handoff_edges(LM_CFG), trep, "lm")
    same(jrep, trep)
    assert bool(trep.findings) == bool(broken)
    assert bool(trep.proofs) != bool(broken)


def test_lm_stack_findings_equal_reference():
    """``lint_stack`` over the LM's DAG stack (signed requant layers, the
    ReLU'd ``up``) with its layer params, the reference's findings."""
    p = lm_standin()
    jcfg = jlm.FQLMConfig.reduced()
    ip = jlm.convert_int(_jp(p), jcfg, jlm.LM_QCFG)
    st = interop.stack_from_numpy(_np(ip.layers), _np(ip.extras), ip.qcfg,
                                  ip.specs, handoff_edges=ip.handoff_edges,
                                  device="cpu")
    tp, _ = interop.params_from_numpy(p, {}, device="cpu")
    names = tlm.proj_names(LM_CFG)
    jrep, trep = JReport(), Report()
    jplanlint.lint_stack(ip, jrep, "lm", layer_params=_jp(
        {n: p[n] for n in names}))
    planlint.lint_stack(st, trep, "lm", layer_params={n: tp[n]
                                                      for n in names})
    same(jrep, trep)
