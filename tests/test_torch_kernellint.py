"""The port's ``analysis.kernellint`` against the reference's.

* schema: both linters read the same table documents (the reference's
  mutation documents, a packed row with a dead ``bc``, a row with no knob,
  the port's checked-in table) and must give the same findings: check,
  subject, severity and message. The one stated difference is the port's
  ``policy`` rule: a row that names a policy and no knob is info in the
  port, where the reference warns "carries no block knobs";
* shapes: the port's ``kws_conv_shapes`` / ``darknet_conv_shapes`` equal
  the reference's, and ``lint_shapes`` gives the reference's table-driven
  findings (``autotune-miss``, ``table-drift``) on them, with ``table=`` /
  ``measured=`` passed to both sides;
* ``kernellint/smem`` (the port's counterpart of ``kernellint/vmem``) and
  the split-K legality rules, clean on the served shapes and firing on
  their mutations;
* ``runtime_miss_counters``, replica divergence included, against the
  reference's on the same sequence of table lookups.
"""
import dataclasses
import json
import warnings

import pytest

from repro_torch.analysis import kernellint, targets
from repro_torch.analysis.kernellint import ConvShape
from repro_torch.analysis.report import Report
from repro_torch.kernels import fq_conv
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws

try:
    from repro.analysis import kernellint as jkl
    from repro.analysis import targets as jtargets
    from repro.analysis.report import Report as JReport
    from repro.kernels import fq_conv as jfq_conv
except ImportError:  # pragma: no cover - the reference is on the CPU host
    jkl = None

pytestmark = pytest.mark.skipif(jkl is None, reason="needs the reference")


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Table lookups count misses on both sides: start and end clean."""
    fq_conv.reset_autotune_cache()
    if jkl is not None:
        jfq_conv.reset_autotune_cache()
    yield
    fq_conv.reset_autotune_cache()
    if jkl is not None:
        jfq_conv.reset_autotune_cache()


def _write_table(tmp_path, entries, **doc):
    p = tmp_path / "table.json"
    body = {"format": 1, "backend": "cuda", "entries": entries}
    body.update(doc)
    p.write_text(json.dumps(body))
    return str(p)


def _rows(report, checks=None):
    return [(f.check, f.subject, f.severity.name, f.message)
            for f in report.findings if checks is None or f.check in checks]


# the reference's mutation documents (test_analysis_mutations.py) and a few
# rows of our own
DOCS = {
    "malformed-rows": ([
        {"kh": 3, "kw": 3, "stride": 1, "bc": 0},
        {"kh": 3, "kw": 3, "stride": 1, "bco": 64},
        {"kh": "x", "kw": 3, "stride": 1},
        17,
    ], {}),
    "format-tag": ([], {"format": 2}),
    "unknown-packed-format": ([
        {"kh": 3, "kw": 3, "stride": 1, "bco": 64, "format": "int3"}], {}),
    "negative-bc": ([{"kh": 3, "kw": 3, "stride": 1, "bc": -4}], {}),
    "packed-bc-dead": ([
        {"kh": 3, "kw": 3, "stride": 1, "bco": 64, "bc": 32,
         "format": "ternary"}], {}),
    "no-knob": ([{"kh": 1, "kw": 1, "stride": 1}], {}),
    "bool-knob-bad-backend": ([
        {"kh": 1, "kw": 1, "stride": 1, "bho": True}], {"backend": ""}),
    "clean": ([{"kh": 3, "kw": 3, "stride": 1, "bco": 64, "bc": 32},
               {"kh": 3, "kw": 3, "stride": 1, "bco": 128,
                "format": "int4"}], {}),
    "not-an-object": (None, {}),
}


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_schema_findings_equal_reference(tmp_path, doc):
    entries, extra = DOCS[doc]
    if entries is None:
        path = tmp_path / "table.json"
        path.write_text("[1, 2]")
        path = str(path)
    else:
        path = _write_table(tmp_path, entries, **extra)
    r, jr = Report(), JReport()
    kernellint.lint_table_schema(r, path)
    jkl.lint_table_schema(jr, path)
    assert _rows(r) == _rows(jr)
    assert r.exit_code() == jr.exit_code()
    assert r.counters == jr.counters
    assert [p["statement"] for p in r.proofs] == \
        [p["statement"] for p in jr.proofs]
    if doc != "clean":
        assert r.exit_code() == 1


def test_schema_policy_rule_is_the_one_difference(tmp_path):
    """The port's checked-in table: every row names a policy and no knob.
    The reference warns on each; the port records each as info, and
    nothing else differs."""
    r, jr = Report(), JReport()
    kernellint.lint_table_schema(r)
    jkl.lint_table_schema(jr, fq_conv.AUTOTUNE_TABLE_PATH)
    doc = json.load(open(fq_conv.AUTOTUNE_TABLE_PATH))
    n = len(doc["entries"])
    assert n == 9 and all("policy" in e for e in doc["entries"])
    assert [(f.check, f.subject) for f in r.findings] == \
        [(f.check, f.subject) for f in jr.findings]
    assert [f.severity.name for f in r.findings] == ["INFO"] * n
    assert [f.severity.name for f in jr.findings] == ["WARNING"] * n
    assert all("no block knobs" in f.message for f in jr.findings)
    assert all("policy" in f.message for f in r.findings)
    assert r.exit_code() == 0 and jr.exit_code() == 1
    assert r.proofs and r.counters == jr.counters
    # a row with a policy and no knob still warns once the policy is empty
    path = _write_table(tmp_path, [{"kh": 1, "kw": 1, "stride": 1,
                                    "policy": " "}])
    r = Report()
    kernellint.lint_table_schema(r, path)
    assert [f.severity.name for f in r.findings] == ["WARNING"]


def _shape_sets():
    jk, jd = jtargets.kws, jtargets.darknet
    return {
        "kws": (targets.kws_conv_shapes(tkws.KWSConfig()),
                jtargets.kws_conv_shapes(jk.KWSConfig())),
        "kws-reduced-ternary": (
            targets.kws_conv_shapes(tkws.KWSConfig.reduced(),
                                    weight_format="ternary"),
            jtargets.kws_conv_shapes(jk.KWSConfig.reduced(),
                                     weight_format="ternary")),
        "darknet": (
            targets.darknet_conv_shapes(tdn.DarkNetConfig(),
                                        targets.DARKNET_INPUT),
            jtargets.darknet_conv_shapes(jd.DarkNetConfig(),
                                         jtargets.DARKNET_INPUT)),
        "darknet-reduced-int4": (
            targets.darknet_conv_shapes(tdn.DarkNetConfig.reduced(),
                                        targets.DARKNET_REDUCED_INPUT,
                                        weight_format="int4"),
            jtargets.darknet_conv_shapes(jd.DarkNetConfig.reduced(),
                                         jtargets.DARKNET_REDUCED_INPUT,
                                         weight_format="int4")),
    }


TABLES = {
    "empty": ({}, set()),
    "drift": ({(3, 1, 1, "int8"): {"bc": 45}, (3, 3, 1, "int8"): {"bc": 48},
               (1, 1, 1, "int8"): {"bc": 100}},
              {(3, 1, 1, "int8"), (3, 3, 1, "int8"), (1, 1, 1, "int8")}),
    "measured": ({}, {(3, 1, 1, "int8"), (3, 3, 1, "int8"),
                      (1, 1, 1, "int8"), (3, 1, 1, "ternary")}),
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("shapes", ["kws", "kws-reduced-ternary", "darknet",
                                    "darknet-reduced-int4"])
def test_lint_shapes_equal_reference(shapes, table):
    ours, theirs = _shape_sets()[shapes]
    assert [dataclasses.astuple(s) for s in ours] == \
        [dataclasses.astuple(s) for s in theirs]
    tab, meas = TABLES[table]
    r, jr = Report(), JReport()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kernellint.lint_shapes(ours, r, table=tab, measured=meas)
        jkl.lint_shapes(theirs, jr, backend="cuda", table=tab,
                        measured=meas)
    drift = ("kernellint/table-drift",)
    drift_rows = _rows(r, drift)
    assert drift_rows == _rows(jr, drift)
    miss = [(f.check, f.subject, f.severity.name, f.details["key"],
             f.details["layers"]) for f in r.findings
            if f.check == "kernellint/autotune-miss"]
    jmiss = [(f.check, f.subject, f.severity.name, f.details["key"],
              f.details["layers"]) for f in jr.findings
             if f.check == "kernellint/autotune-miss"]
    assert miss == jmiss
    assert r.counters.get("kernellint/autotune-misses") == \
        jr.counters.get("kernellint/autotune-misses")
    assert r.counters["kernellint/shapes-checked"] == len(ours)
    assert r.exit_code() == jr.exit_code() == int(bool(miss or drift_rows))
    # the port's picks are legal on every served shape
    assert not [f for f in r.findings if f.check in (
        "kernellint/blockspec", "kernellint/smem", "kernellint/split-k")]


def test_served_shapes_clean_and_split():
    """Full-size KWS and DarkNet-19 at 224, int8 and ternary, against the
    checked-in table: no finding, a proof, and the fallback's split-K on
    DarkNet's late convs at batch 1 passes the legality rules."""
    shapes = []
    for fmt in ("int8", "ternary"):
        shapes += targets.kws_conv_shapes(tkws.KWSConfig(),
                                          weight_format=fmt)
        shapes += targets.darknet_conv_shapes(
            tdn.DarkNetConfig(), targets.DARKNET_INPUT, weight_format=fmt)
    r = Report()
    kernellint.lint_shapes(shapes, r)
    assert r.findings == [], [f.message for f in r.findings]
    assert r.counters["kernellint/shapes-checked"] == len(shapes)
    assert r.counters["kernellint/split-k-shapes"] >= 1
    assert [p["check"] for p in r.proofs] == ["kernellint/blockspec"]


@pytest.mark.mutation
def test_smem_over_budget_caught(monkeypatch):
    shape = ConvShape("mut/conv", ho=28, wo=28, cin=64, cout=64, kh=3, kw=3)
    assert fq_conv.smem_footprint() <= fq_conv.SMEM_BUDGET
    r = Report()
    kernellint.lint_shapes([shape], r, table={}, measured={shape.key})
    assert r.findings == [] and r.proofs
    monkeypatch.setattr(fq_conv, "SMEM_BUDGET", fq_conv.smem_footprint() - 1)
    r = Report()
    kernellint.lint_shapes([shape], r, table={}, measured={shape.key})
    assert [f.check for f in r.findings] == ["kernellint/smem"]
    assert r.findings[0].details["smem_bytes"] == 61_440
    assert r.exit_code() == 1 and not r.proofs


SPLITS = {
    # (shape, bc, check fired or None, severity)
    "pooled": (ConvShape("mut/pooled", ho=14, wo=14, cin=64, cout=64, kh=3,
                         kw=3, pool=(2, 2)), 16, "ERROR"),
    "packed": (ConvShape("mut/packed", ho=14, wo=14, cin=64, cout=64, kh=3,
                         kw=3, weight_format="int4"), 16, "ERROR"),
    "non-divisor": (ConvShape("mut/div", ho=7, wo=7, cin=48, cout=64, kh=3,
                              kw=3), 20, "ERROR"),
    "loses-vector-loader": (ConvShape("mut/span", ho=7, wo=7, cin=32,
                                      cout=64, kh=1, kw=1), 8, "WARNING"),
    "legal": (ConvShape("ok/split", ho=7, wo=7, cin=512, cout=64, kh=3,
                        kw=3), 128, None),
    "no-split": (ConvShape("ok/whole", ho=7, wo=7, cin=512, cout=64, kh=3,
                           kw=3, pool=(2, 2)), 512, None),
}


@pytest.mark.mutation
@pytest.mark.parametrize("case", sorted(SPLITS))
def test_split_k_legality(case):
    shape, bc, severity = SPLITS[case]
    r = Report()
    legal = kernellint.lint_split(shape, bc, r)
    if severity is None:
        assert legal and r.findings == []
        return
    assert [(f.check, f.severity.name) for f in r.findings] == \
        [("kernellint/split-k", severity)]
    assert legal == (severity == "WARNING")
    assert r.exit_code() == 1


@pytest.mark.mutation
def test_table_split_through_lint_shapes():
    """A table bc reaches the split rules as the launch would take it: on
    an unpooled int8 conv it splits (legal here), on the pooled conv of the
    same key it is not read."""
    key = (3, 3, 1, "int8")
    shapes = [ConvShape("t/conv", ho=7, wo=7, cin=512, cout=64, kh=3, kw=3),
              ConvShape("t/pooled", ho=14, wo=14, cin=512, cout=64, kh=3,
                        kw=3, pool=(2, 2))]
    r = Report()
    kernellint.lint_shapes(shapes, r, table={key: {"bc": 128}},
                           measured={key})
    assert r.findings == [] and r.counters["kernellint/split-k-shapes"] == 1
    r = Report()
    kernellint.lint_shapes(shapes[:1], r, table={key: {"bc": 8}},
                           measured={key})
    assert [(f.check, f.severity.name) for f in r.findings] == \
        [("kernellint/split-k", "WARNING")]


@pytest.mark.mutation
def test_blockspec_degenerate_shape_caught():
    shape = ConvShape("mut/empty", ho=8, wo=8, cin=16, cout=0, kh=3, kw=3)
    r = Report()
    kernellint.lint_shapes([shape], r, table={}, measured={shape.key})
    assert [f.check for f in r.findings] == ["kernellint/blockspec"]
    assert r.exit_code() == 1


def _misses(module, scope):
    """The same lookups on either side: a key twice outside any replica,
    one key on replica "a", that key and another on replica "b"."""
    kw = dict(ho=8, wo=8, cin=8, cout=8, stride=(1, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        module.pick_blocks(kh=5, kw=5, **kw)
        module.pick_blocks(kh=5, kw=5, **kw)
        with scope("a"):
            module.pick_blocks(kh=7, kw=7, **kw)
        with scope("b"):
            module.pick_blocks(kh=7, kw=7, **kw)
            module.pick_blocks(kh=5, kw=3, **kw)


def test_runtime_miss_counters_equal_reference():
    _misses(fq_conv, fq_conv.replica_scope)
    _misses(jfq_conv, jfq_conv.replica_scope)
    r, jr = Report(), JReport()
    kernellint.runtime_miss_counters(r)
    jkl.runtime_miss_counters(jr)
    assert r.counters == jr.counters
    assert r.counters["kernellint/runtime-miss:(5, 5, 1, 'int8')"] == 2
    assert _rows(r) == _rows(jr)
    assert [(f.check, f.subject) for f in r.findings] == \
        [("kernellint/replica-miss-divergence", "replica[a]")]
    assert r.exit_code() == 1
