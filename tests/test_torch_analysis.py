"""The port's ``analysis.targets`` and ``python -m repro_torch.analysis``
against the reference's.

* targets: chains, served conv shapes, plans, pool markers, hand-off
  edges and core examples equal the reference's, reduced and full size
  (full size from the configs alone: no full stack is built here);
* ``run_analysis(skip_intlint=True)`` gives the reference's planlint and
  kernellint findings and proofs on the same stacks (the reference
  converts the port's stand-in params and the port carries that stack
  over with ``interop``, as ``test_torch_planlint.py`` does), both sides
  linting one candidate table;
* the command line: ``--reduced --device cpu`` exits 0 with a proof a
  trace and no warning, ``--fail-on info`` gates on the table's policy
  rows, a bad ``--mac-chunks`` is rejected and a broken ``--table`` exits
  1;
* eager cores never enter the kernel operators; a traced core holds one
  node a kernel call (DarkNet's K3b and the LM's K2 included).
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.analysis import intlint, targets
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.report import Report
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import fq_conv, library
from repro_torch.models import darknet as tdn
from repro_torch.models import fq_lm as tlm
from repro_torch.models import kws as tkws

try:
    import jax  # noqa: F401
    from repro.analysis import targets as jtargets
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.kernels import fq_conv as jfq_conv
    from repro.models import darknet as jdn
    from repro.models import fq_lm as jlm
    from repro.models import kws as jkws
    from test_torch_planlint import _jp, _np, lm_standin, stacks
except ImportError:  # pragma: no cover - the reference is on the CPU host
    jtargets = None

pytestmark = pytest.mark.skipif(jtargets is None,
                                reason="needs the reference")


def _astuples(shapes):
    return [dataclasses.astuple(s) for s in shapes]


@pytest.mark.parametrize("reduced", [True, False])
def test_declared_geometry_equals_reference(reduced):
    tk = tkws.KWSConfig.reduced() if reduced else tkws.KWSConfig()
    jk = jkws.KWSConfig.reduced() if reduced else jkws.KWSConfig()
    td = tdn.DarkNetConfig.reduced() if reduced else tdn.DarkNetConfig()
    jd = jdn.DarkNetConfig.reduced() if reduced else jdn.DarkNetConfig()
    tl = tlm.FQLMConfig.reduced() if reduced else tlm.FQLMConfig()
    jl = jlm.FQLMConfig.reduced() if reduced else jlm.FQLMConfig()
    hw = targets.DARKNET_REDUCED_INPUT if reduced else targets.DARKNET_INPUT
    assert hw == (jtargets.DARKNET_REDUCED_INPUT if reduced
                  else jtargets.DARKNET_INPUT)
    for fmt in ("int8", "ternary"):
        assert _astuples(targets.kws_conv_shapes(tk, weight_format=fmt)) == \
            _astuples(jtargets.kws_conv_shapes(jk, weight_format=fmt))
        assert _astuples(targets.darknet_conv_shapes(
            td, hw, weight_format=fmt)) == _astuples(
            jtargets.darknet_conv_shapes(jd, hw, weight_format=fmt))
    assert tkws.conv_names(tk) == jkws.conv_names(jk)
    assert tdn.int_conv_names(td) == jdn.int_conv_names(jd)
    assert tdn.layer_plan(td) == jdn.layer_plan(jd)
    assert tlm.proj_names(tl) == jlm.proj_names(jl)
    assert tlm.handoff_edges(tl) == jlm.handoff_edges(jl)
    assert targets.DEFAULT_MAC_CHUNKS == jtargets.DEFAULT_MAC_CHUNKS
    assert dataclasses.astuple(targets.DEFAULT_NOISE) == \
        dataclasses.astuple(jtargets.DEFAULT_NOISE)
    assert targets.DEFAULT_SUPPRESSIONS == jtargets.DEFAULT_SUPPRESSIONS == ()


@pytest.mark.parametrize("name", ["kws", "darknet", "kws-ternary",
                                  "darknet-ternary", "lm"])
def test_reduced_targets_equal_reference(name):
    """The port's targets (built on the CPU) hold the reference's chains,
    shapes, plans, pool markers, formats, impls and core examples."""
    fmt = "auto" if name.endswith("ternary") else None
    if name == "lm":
        t = targets.lm_target(reduced=True, device="cpu")
        jcfg = jlm.FQLMConfig.reduced()
        want = dict(name="lm-reduced", chain=jlm.proj_names(jcfg), shapes=[],
                    plan=None, n_pool_markers=0, impls=("int8",),
                    handoff_edges=jlm.handoff_edges(jcfg),
                    example=[((1, 4, jcfg.d_model), torch.int8),
                             ((jcfg.n_layers, 1, 4, jcfg.d_model),
                              torch.int8)], weight_format="int8")
    else:
        make = (targets.kws_target if name.startswith("kws")
                else targets.darknet_target)
        t = make(reduced=True, weight_format=fmt, device="cpu")
        wf = "ternary" if fmt else "int8"
        if name.startswith("kws"):
            jcfg = jkws.KWSConfig.reduced()
            want = dict(chain=jkws.conv_names(jcfg), plan=None,
                        n_pool_markers=0,
                        shapes=_astuples(jtargets.kws_conv_shapes(
                            jcfg, weight_format=wf)),
                        example=[((1, jcfg.seq_len, jcfg.embed),
                                  torch.int8)])
        else:
            jcfg = jdn.DarkNetConfig.reduced()
            plan = jdn.layer_plan(jcfg)
            h = jtargets.DARKNET_REDUCED_INPUT
            for step in plan[:jdn._split_plan(plan)]:
                h = h // 2 if step[0] == "pool" else h
            c0 = [l for l in jcfg.layers if l != "M"][0][1]
            want = dict(chain=jdn.int_conv_names(jcfg), plan=plan,
                        n_pool_markers=sum(l == "M" for l in jcfg.layers),
                        shapes=_astuples(jtargets.darknet_conv_shapes(
                            jcfg, jtargets.DARKNET_REDUCED_INPUT,
                            weight_format=wf)),
                        example=[((1, h, h, c0), torch.int8)])
        want.update(name=f"{name.split('-')[0]}-reduced"
                    + ("-ternary" if fmt else ""), impls=None,
                    handoff_edges=None, weight_format=wf)
    assert t.name == want["name"] and t.chain == want["chain"]
    assert _astuples(t.shapes) == list(want["shapes"])
    assert t.plan == want["plan"]
    assert t.n_pool_markers == want["n_pool_markers"]
    assert t.impls == want["impls"]
    assert t.handoff_edges == want["handoff_edges"]
    assert t.weight_format == want["weight_format"]
    assert [(tuple(a.shape), a.dtype) for a in t.core_example] == \
        want["example"]
    assert t.device == torch.device("cpu")
    assert t.stack.layers[t.chain[0]].get("weight_format", "int8") == \
        t.weight_format


@pytest.fixture
def foreign_table(tmp_path):
    """A candidate table measured for no backend either side serves: both
    sides lint it alike and find every served key unmeasured."""
    p = tmp_path / "table.json"
    p.write_text(json.dumps({"format": 1, "backend": "tpu", "entries": [
        {"kh": 3, "kw": 3, "stride": 1, "bco": 64}]}))
    fq_conv.reset_autotune_cache()
    jfq_conv.reset_autotune_cache()
    yield str(p)
    fq_conv.reset_autotune_cache()
    jfq_conv.reset_autotune_cache()


def _pair(model, fmt):
    """(reference target, port target) on one stack: the reference
    converts the port's stand-in params; the port carries that stack."""
    ip, carried, tp, _ = stacks(model, fmt)
    names = list(carried.layer_names)
    jmod, tmod = (jkws, tkws) if model == "kws" else (jdn, tdn)
    jcfg = jmod.KWSConfig.reduced() if model == "kws" \
        else jmod.DarkNetConfig.reduced()
    tcfg = tmod.KWSConfig.reduced() if model == "kws" \
        else tmod.DarkNetConfig.reduced()
    if model == "kws":
        jshapes = jtargets.kws_conv_shapes(jcfg, weight_format=fmt)
        tshapes = targets.kws_conv_shapes(tcfg, weight_format=fmt)
        jextra = textra = {}
    else:
        hw = targets.DARKNET_REDUCED_INPUT
        jshapes = jtargets.darknet_conv_shapes(jcfg, hw, weight_format=fmt)
        tshapes = targets.darknet_conv_shapes(tcfg, hw, weight_format=fmt)
        n_m = sum(l == "M" for l in tcfg.layers)
        jextra = dict(plan=jdn.layer_plan(jcfg), n_pool_markers=n_m)
        textra = dict(plan=tdn.layer_plan(tcfg), n_pool_markers=n_m)
    j = jtargets.StackTarget(
        name=model, module=jmod, cfg=jcfg, qcfg=JQuantConfig(2, 4, 4,
                                                             fq=True),
        fq_params=_jp({n: tp[n] for n in names}), stack=ip, chain=names,
        shapes=jshapes, weight_format=fmt, **jextra)
    t = targets.StackTarget(
        name=model, module=tmod, cfg=tcfg, qcfg=QuantConfig(2, 4, 4,
                                                            fq=True),
        fq_params=tp, stack=carried, chain=names, shapes=tshapes,
        weight_format=fmt, **textra)
    return j, t


@pytest.mark.parametrize("model,fmt", [("kws", "int8"), ("kws", "ternary"),
                                       ("darknet", "int8"),
                                       ("darknet", "ternary")])
def test_run_analysis_plan_and_kernel_findings_equal_reference(
        model, fmt, foreign_table):
    j, t = _pair(model, fmt)
    jrep = jtargets.run_analysis([j], skip_intlint=True,
                                 table_path=foreign_table)
    rep = targets.run_analysis([t], skip_intlint=True,
                               table_path=foreign_table)

    def rows(r):
        return [(f.check, f.subject, f.severity.name) for f in r.findings]
    assert rows(rep) == rows(jrep)
    assert [(p["check"], p["subject"]) for p in rep.proofs] == \
        [(p["check"], p["subject"]) for p in jrep.proofs]
    assert {f.check for f in rep.findings} == {"kernellint/autotune-miss"}
    assert rep.exit_code() == jrep.exit_code() == 1
    assert not [k for k in rep.counters if k.startswith("intlint")]


def test_run_analysis_lm_planlint_equals_reference(foreign_table):
    from repro.analysis import planlint as jplanlint
    from repro.analysis.report import Report as JReport
    from repro_torch.analysis import planlint
    p = lm_standin()
    jcfg, tcfg = jlm.FQLMConfig.reduced(), tlm.FQLMConfig.reduced()
    jrep, trep = JReport(), Report()
    jplanlint.lint_handoff_edges(_jp(p), jlm.handoff_edges(jcfg), jrep, "lm")
    planlint.lint_handoff_edges(
        targets.lm_target(reduced=True, device="cpu").fq_params,
        tlm.handoff_edges(tcfg), trep, "lm")
    assert [(x["check"], x["subject"]) for x in trep.proofs] == \
        [(x["check"], x["subject"]) for x in jrep.proofs]
    t = targets.lm_target(reduced=True, device="cpu")
    rep = targets.run_analysis([t], skip_intlint=True,
                               table_path=foreign_table)
    assert rep.findings == [] and rep.exit_code() == 0
    assert {p["check"] for p in rep.proofs} >= {
        "planlint/handoff", "planlint/static-aux", "planlint/rescale",
        "planlint/seed-collision"}


def test_cli_reduced_kws_exit_zero(tmp_path, capsys):
    out = tmp_path / "analysis.json"
    rc = cli_main(["--stack", "kws", "--reduced", "--impl", "fused",
                   "--mac-chunks", "1", "--device", "cpu", "--json",
                   str(out)])
    assert rc == 0, capsys.readouterr().out
    d = json.loads(out.read_text())
    assert d["tool"] == "repro_torch.analysis"
    # the nine policy rows of the checked-in table, as info, and nothing
    # at or above the warning gate
    assert d["summary"]["by_severity"] == {"info": 9}
    assert {f["check"] for f in d["findings"]} == {"kernellint/table-schema"}
    # (clean + mac_chunks=1) x (int8 stack + its ternary twin), each proved
    assert d["counters"]["intlint/traces"] == 4
    assert d["counters"]["intlint/kernel-nodes:fq_conv2d"] == 4 * 3
    traces = [p for p in d["proofs"] if p["check"] == "intlint"]
    assert len(traces) == 4
    assert all(p["details"]["kernel_nodes"] == {"fq_conv2d": 3}
               for p in traces)
    assert cli_main(["--stack", "kws", "--reduced", "--skip-intlint",
                     "--device", "cpu", "--fail-on", "info"]) == 1


@pytest.mark.parametrize("bad", ["0", "x", ","])
def test_cli_rejects_bad_mac_chunks(bad):
    with pytest.raises(SystemExit):
        cli_main(["--mac-chunks", bad, "--device", "cpu"])


@pytest.mark.mutation
def test_cli_gates_on_broken_table(tmp_path):
    p = tmp_path / "table.json"
    p.write_text(json.dumps({"format": 1, "backend": "cuda", "entries": [
        {"kh": 3, "kw": 3, "stride": 1, "bc": -4}]}))
    rep = tmp_path / "rep.json"
    rc = cli_main(["--stack", "kws", "--reduced", "--skip-intlint",
                   "--table", str(p), "--device", "cpu", "--json",
                   str(rep)])
    assert rc == 1
    d = json.loads(rep.read_text())
    assert any(f["check"] == "kernellint/table-schema" and
               f["severity"] == "error" for f in d["findings"])
    fq_conv.reset_autotune_cache()


@pytest.mark.parametrize("name", ["kws", "darknet", "lm"])
def test_eager_never_enters_the_operators(name):
    """An eager core calls no operator; its trace holds one node a kernel
    call and runs each operator once a node, with the eager result."""
    t = getattr(targets, f"{name}_target")(reduced=True, device="cpu")
    impls = t.impls or ("fused", "im2col")
    library.reset_op_calls()
    eager = {impl: t.module.int_core(t.stack, *t.core_example, t.qcfg,
                                     t.cfg, impl=impl) for impl in impls}
    assert sum(library.op_calls.values()) == 0
    for impl in impls:
        library.reset_op_calls()
        gm = intlint.trace(
            lambda *a, impl=impl: t.module.int_core(t.stack, *a, t.qcfg,
                                                    t.cfg, impl=impl),
            t.core_example)
        nodes = dict(intlint.kernel_nodes(gm))
        assert nodes == {k: v for k, v in library.op_calls.items() if v}
        want = {("lm", "int8"): {"fq_matmul": 12},
                ("kws", "fused"): {"fq_conv2d": 3},
                ("kws", "im2col"): {"fq_matmul": 3},
                ("darknet", "fused"): {"fq_conv2d": 3, "fq_conv2d_pool": 1},
                ("darknet", "im2col"): {"fq_matmul": 4}}[(name, impl)]
        assert nodes == want
        out = gm(*t.core_example)
        ref = eager[impl]
        if isinstance(ref, tuple):
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
        else:
            assert torch.equal(out, ref)
    library.reset_op_calls()


def test_traces_in_worker_processes_equal_serial():
    """``jobs`` > 1 ships the stacks to spawned processes: the same
    report, proof for proof, as the serial run."""
    t = targets.kws_target(reduced=True, weight_format="auto", device="cpu")
    kw = dict(impls=("fused", "im2col"), mac_chunks=(4,))
    serial, par = {}, {}
    a = targets.run_analysis([t], figures=serial, **kw)
    b = targets.run_analysis([t], figures=par, jobs=2, **kw)
    assert a.to_dict() == b.to_dict() and len(a.proofs) > 4
    assert serial.keys() == par.keys() and len(serial) == 4
    assert all(serial[k]["nodes"] == par[k]["nodes"] for k in serial)
