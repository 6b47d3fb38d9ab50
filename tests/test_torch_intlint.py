"""The port's ``analysis.absint`` and ``analysis.intlint`` on the CPU.

* absint's rules on programs of known bound, modelled on the reference's
  ``tests/test_analysis.py``: a dot bound is depth x the extreme product,
  the requant epilogue lands in [lo, n], a kernel node's rule is its
  contract's, a signed spill fires the wrap hook;
* each kernel operator's contract: its int32 accumulator read from the
  lines of ``csrc/`` it cites, its depth (split-K slices included), packed
  weights decoded from their bytes, the noise and dequant ranges;
* the reference's mutations (``test_analysis_mutations.py``): a float
  leak, a depth-300,000 overflow, an int16 accumulator, a float output,
  the ternary unpack without sign extension (caught; the correct unpack
  clean), and the port's own: an unsanctioned float op, a failed trace,
  an incomplete analysis;
* the clean reduced KWS and DarkNet stacks, their ternary twins and the
  LM prove, with one kernel node per kernel call, and the largest bound
  equals the one computed in numpy from the stack's weights: per layer the
  depth times the extreme product of the input codes' range (the entry's
  int8 range, then each layer's requant range) and the weight codes.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import absint, intlint, targets
from repro_torch.analysis.intlint import TraceSpec
from repro_torch.analysis.report import Report
from repro_torch.core import quant
from repro_torch.kernels import library
from repro_torch.kernels.fq_conv import fq_conv2d
from repro_torch.kernels.fq_matmul import fq_matmul
from repro_torch.kernels.library import CONTRACTS

CSRC = Path(library.__file__).resolve().parent / "csrc"


def _bounds(fn, *example, checker=None):
    """Trace fn and return its outputs' abstract bounds: integer inputs
    tainted at their dtype's range, others by their concrete values."""
    gm = intlint.trace(fn, example)
    vals = [absint.dtype_interval(a.dtype, tainted=True)
            if absint._is_int(a.dtype) else absint.abs_of_concrete(a)
            for a in example]
    return absint.Interp(checker or absint.Checker()).run(gm, vals)


class _Recorder(absint.Checker):
    def __init__(self):
        self.contractions, self.wraps = [], []

    def on_contraction(self, interp, node, **kw):
        self.contractions.append(kw)

    def on_signed_wrap(self, interp, node, raw, dtype):
        self.wraps.append((raw.lo, raw.hi, dtype))


def _checks(report):
    return {f.check for f in report.findings}


def _assert_caught(report, check):
    assert check in _checks(report), sorted(_checks(report))
    assert report.exit_code() == 1


# ---------------------------------------------------------------------------
# absint's rules
# ---------------------------------------------------------------------------


def test_absint_dot_bound_is_depth_times_product():
    k = 64
    w = torch.ones((k, 4), dtype=torch.int8)

    def f(codes):
        return torch.mm(codes.to(torch.int32), w.to(torch.int32))

    (out,) = _bounds(f, torch.zeros((2, k), dtype=torch.int8))
    # codes tainted at [-128, 127]; w a constant of ones
    assert (out.lo, out.hi) == (-128 * k, 127 * k) and out.tainted


def test_absint_requant_epilogue_bound():
    """clip(round(acc * rescale), lo, n) lands exactly in [lo, n]."""
    def f(acc):
        v = torch.round(acc.to(torch.float32) * 0.01)
        return torch.clamp(v, 0, 15).to(torch.int8)

    (out,) = _bounds(f, torch.zeros((4,), dtype=torch.int32))
    assert (out.lo, out.hi) == (0.0, 15.0)


def test_absint_kernel_node_accumulation():
    """K2's node: the accumulator is the depth times the product bound,
    the requant clamps the output."""
    b = torch.ones((256, 8), dtype=torch.int8)
    s = torch.tensor(0.01)
    rec = _Recorder()

    def f(a):
        return fq_matmul(a, b, s, n_out=15, lo=0)

    (out,) = _bounds(f, torch.zeros((8, 256), dtype=torch.int8),
                     checker=rec)
    assert (out.lo, out.hi) == (0.0, 15.0)
    (c,) = rec.contractions
    assert c["depth"] == 256 and c["acc_dtype"] == torch.int32
    assert (c["acc"].lo, c["acc"].hi) == (-128 * 256, 127 * 256)
    assert c["contract"] is CONTRACTS["fq_matmul"]


def test_absint_signed_wrap_hook_fires():
    rec = _Recorder()

    def f(x):
        return x.to(torch.int32) * (2 ** 25)   # 128 * 2^25 > int32

    _bounds(f, torch.zeros((2,), dtype=torch.int8), checker=rec)
    assert rec.wraps and rec.wraps[0][2] == torch.int32


def test_absint_unsigned_masks_and_threefry_do_not_wrap():
    """The noise key's threefry rounds on int64 words, masked to 32 bits,
    stay inside int64: no wrap reaches the hook, and the words stay in
    [0, 2^32)."""
    from repro_torch.core import prng
    rec = _Recorder()
    key = prng.PRNGKey(7)
    gm = intlint.trace(lambda k: prng.bits(k, (5,)), (key,))
    outs = absint.Interp(rec).run(gm, [absint.abs_of_concrete(key)])
    assert rec.wraps == []
    assert (outs[0].lo, outs[0].hi) == (0.0, float(prng.M32))


# ---------------------------------------------------------------------------
# the kernels' contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", sorted(CONTRACTS))
def test_contract_accumulator_read_from_sources(op):
    """The contract's int32 accumulator is what the kernel sources say:
    each cited line holds its text (the MMA's .s32 += .s8 x .s8 and the
    int fragment of the kernel's epilogue)."""
    c = CONTRACTS[op]
    assert c.acc_dtype == torch.int32 and c.a_dtype == torch.int8
    kinds = set()
    for name, line, text in c.acc_sources:
        lines = (CSRC / name).read_text().splitlines()
        assert text in lines[line - 1], (name, line, lines[line - 1])
        kinds.add("mma" if ".s32.s8.s8" in text else "acc")
        if kinds == {"acc"}:
            assert re.search(r"\bint acc\[", lines[line - 1])
    assert kinds == {"mma", "acc"}
    assert getattr(torch.ops.repro_torch, op).default._schema.name == \
        f"repro_torch::{op}"


def _conv_case(fmt="int8", pool=None, epilogue="requant", bc=None,
               noise=False, cin=64):
    gen = torch.Generator().manual_seed(0)
    codes = torch.randint(-1, 2, (9 * cin, 32), generator=gen,
                          dtype=torch.int8)
    w = quant.pack_im2col_codes(codes, 9, fmt) if fmt != "int8" else codes
    s = torch.tensor(0.05)
    kw = {}
    if noise:
        kw = dict(noise_sigma_acc=torch.tensor(2.0),
                  noise_seed=torch.tensor(5, dtype=torch.uint32),
                  mac_chunks=4)

    def f(a):
        return fq_conv2d(a, w, s, kh=3, kw=3, padding=(1, 1),
                                 pool=pool, epilogue=epilogue, n_out=7,
                                 lo=-7, weight_format=fmt, bc=bc, **kw)
    return f, torch.zeros((1, 8, 8, cin), dtype=torch.int8)


@pytest.mark.parametrize("case", [
    dict(), dict(bc=16), dict(pool=(2, 2)), dict(fmt="ternary"),
    dict(fmt="int4", pool=(2, 2)), dict(epilogue="dequant"),
    dict(epilogue="dequant", noise=True), dict(noise=True, bc=32)])
def test_contract_conv_depth_weights_and_range(case):
    f, a = _conv_case(**case)
    rec = _Recorder()
    gm = intlint.trace(f, (a,))
    (node,) = [n for n in gm.graph.nodes if n.op == "call_function"]
    op = "fq_conv2d" if case.get("pool") is None else "fq_conv2d_pool"
    assert library.op_name(node.target) == op
    (out,) = absint.Interp(rec).run(
        gm, [absint.dtype_interval(torch.int8, tainted=True)])
    (c,) = rec.contractions
    contract = CONTRACTS[op]
    args = {k: (absint.node_shape(v) if isinstance(v, torch.fx.Node) else v)
            for k, v in absint.bind(node).items()}
    assert c["depth"] == contract.depth(args) == 9 * 64
    bc = case.get("bc")
    split = (64 // bc, 9 * bc) if bc else (1, 9 * 64)
    assert contract.slices(args) == split
    assert args["bc"] == (bc or 64)
    # ternary / int4 weights decoded from their bytes: the codes' range
    assert (c["weights"].lo, c["weights"].hi) == (-1.0, 1.0)
    assert (c["acc"].lo, c["acc"].hi) == (-128 * 576, 128 * 576)
    if case.get("epilogue") == "dequant":
        m = 6 * 2.0 if case.get("noise") else 0.0
        lo, hi = (-128 * 576 - m) * 0.05, (128 * 576 + m) * 0.05
        assert out.lo == pytest.approx(lo) and out.hi == pytest.approx(hi)
    else:
        assert (out.lo, out.hi) == (-7.0, 7.0)


# ---------------------------------------------------------------------------
# mutations: each must be caught with exit code 1
# ---------------------------------------------------------------------------


@pytest.mark.mutation
def test_float_leak_caught():
    w = torch.ones((8, 4))

    def leaky(codes):
        return codes.to(torch.float32) @ w      # float mm on codes

    r = Report()
    intlint.lint_trace(TraceSpec("mut/float-leak", leaky,
                                 (torch.zeros((2, 8), dtype=torch.int8),),
                                 expect_float_out=True), r)
    _assert_caught(r, "intlint/float-leak")
    assert not r.proofs


@pytest.mark.mutation
def test_acc_overflow_depth_caught():
    k = 300_000
    w = torch.full((k, 4), 127, dtype=torch.int8)  # 128 x 127 x 300k

    def deep(codes):
        return torch.mm(codes.to(torch.int32), w.to(torch.int32))

    r = Report()
    intlint.lint_trace(TraceSpec("mut/overflow", deep,
                                 (torch.zeros((1, k), dtype=torch.int8),)),
                       r)
    _assert_caught(r, "intlint/acc-overflow")


@pytest.mark.mutation
def test_narrow_accumulator_caught():
    w = torch.ones((8, 4), dtype=torch.int16)

    def narrow(codes):
        return torch.mm(codes.to(torch.int16), w)

    r = Report()
    intlint.lint_trace(TraceSpec("mut/narrow", narrow,
                                 (torch.zeros((2, 8), dtype=torch.int8),)),
                       r)
    _assert_caught(r, "intlint/narrow-accumulator")


@pytest.mark.mutation
def test_float_output_caught():
    def dequant(codes):
        return codes.to(torch.float32) * 0.05

    r = Report()
    intlint.lint_trace(TraceSpec("mut/float-out", dequant,
                                 (torch.zeros((4,), dtype=torch.int8),)), r)
    _assert_caught(r, "intlint/float-output")


@pytest.mark.mutation
def test_unsanctioned_float_warned():
    def odd(codes):
        return torch.remainder(codes.to(torch.float32), 3.0).to(torch.int8)

    r = Report()
    intlint.lint_trace(TraceSpec("mut/unsanctioned", odd,
                                 (torch.zeros((4,), dtype=torch.int8),)), r)
    _assert_caught(r, "intlint/unsanctioned-float")
    assert r.worst().name == "WARNING"


@pytest.mark.mutation
def test_trace_failed_caught():
    def broken(codes):
        raise RuntimeError("no trace")

    r = Report()
    assert intlint.lint_trace(TraceSpec(
        "mut/trace", broken, (torch.zeros((4,), dtype=torch.int8),)),
        r) is None
    _assert_caught(r, "intlint/trace-failed")


@pytest.mark.mutation
def test_analysis_incomplete_caught(monkeypatch):
    monkeypatch.setattr(absint, "MAX_NODES", 2)

    def f(codes):
        return (codes.to(torch.int32) + 1).clamp(0, 7).to(torch.int8)

    r = Report()
    intlint.lint_trace(TraceSpec("mut/big", f,
                                 (torch.zeros((4,), dtype=torch.int8),)), r)
    _assert_caught(r, "intlint/analysis-incomplete")


@pytest.mark.mutation
def test_packed_sign_extension_bug_caught():
    """Unpack without the two's-complement sign extension leaves ternary
    fields in [0, 3] instead of [-2, 1]; the weight-range check on the
    contraction's weight operand must fire. The correct unpack of the same
    bytes stays clean."""
    fmt, k, n = "ternary", 12, 4
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        -1, 2, (k, n)).astype(np.int8))
    packed = quant.pack_codes(codes, fmt)
    bits, factor = 2, 4
    mask = (1 << bits) - 1

    def buggy_core(a, p):
        p32 = p.to(torch.int32)
        fields = [(p32 >> (i * bits)) & mask for i in range(factor)]
        w = torch.stack(fields, dim=1).reshape(-1, p.shape[1])[:k]
        acc = torch.mm(a.to(torch.int32), w)
        return torch.clamp(torch.round(acc * 0.01), -7, 7).to(torch.int8)

    r = Report()
    intlint.lint_trace(TraceSpec(
        "mut/sign-extension", buggy_core,
        (torch.zeros((2, k), dtype=torch.int8), packed),
        tainted_args=(0,), weight_range=quant.format_interval(fmt)), r)
    _assert_caught(r, "intlint/weight-range")

    def good_core(a, p):
        w = quant.unpack_codes(p, fmt, rows=k).to(torch.int32)
        acc = torch.mm(a.to(torch.int32), w)
        return torch.clamp(torch.round(acc * 0.01), -7, 7).to(torch.int8)

    r2 = Report()
    intlint.lint_trace(TraceSpec(
        "mut/sign-extension-ok", good_core,
        (torch.zeros((2, k), dtype=torch.int8), packed),
        tainted_args=(0,), weight_range=quant.format_interval(fmt)), r2)
    assert "intlint/weight-range" not in _checks(r2)
    assert r2.exit_code() == 0 and r2.proofs


# ---------------------------------------------------------------------------
# the clean reduced stacks prove, at the bound numpy computes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _target(name):
    if name.startswith("lm"):
        return targets.lm_target(reduced=True, device="cpu")
    make = targets.kws_target if name.startswith("kws") \
        else targets.darknet_target
    fmt = "auto" if name.endswith("ternary") else None
    return make(reduced=True, weight_format=fmt, device="cpu")


def _layer_bound(layer, depth_of, a_lo, a_hi):
    w = quant.unpack_codes(layer["w_codes"],
                           layer.get("weight_format", "int8")).numpy()
    depth = depth_of(layer)
    prods = [a * b for a in (a_lo, a_hi)
             for b in (int(w.min()), int(w.max()))]
    return depth * max(abs(p) for p in prods)


def _conv_bound(t, impl):
    """max over layers of depth x |extreme product|: the entry's codes are
    int8, every later layer reads its predecessor's [lo, n_out]."""
    fmt = t.weight_format
    factor = quant.format_factor(fmt)
    if t.name.startswith("kws"):
        ks, cins = t.cfg.ksize, [t.cfg.embed] + [t.cfg.filters] * (
            len(t.chain) - 1)
        taps = {n: ks for n in t.chain}
    else:
        steps = [s for s in t.plan if s[0] == "conv"]
        taps = {s[1]: s[2] * s[2] for s in steps}
        convs = [l for l in t.cfg.layers if l != "M"]
        cins = [convs[int(n[4:]) - 1][1] for n in t.chain]
    bound, a_lo, a_hi = 0, -128, 127
    for name, cin in zip(t.chain, cins):
        layer = t.stack.layers[name]
        cin_eff = -(-cin // factor) * factor if impl == "fused" else cin
        bound = max(bound, _layer_bound(
            layer, lambda _: taps[name] * cin_eff, a_lo, a_hi))
        a_lo, a_hi = layer["lo"], layer["n_out"]
    return float(bound)


def _lm_bound(t):
    bound = 0
    h = (-128, 127)
    for i in range(t.cfg.n_layers):
        st = {k: t.stack[f"{k}{i}"] for k in
              ("wq", "wk", "wv", "wo", "up", "down")}
        n_out = st["wq"]["n_out"]
        d = lambda layer: layer["w_codes"].shape[0]
        for k in ("wq", "wk", "wv"):
            bound = max(bound, _layer_bound(st[k], d, *h))
        bound = max(bound, _layer_bound(st["wo"], d, -128, 127))
        h = (-n_out, n_out)
        bound = max(bound, _layer_bound(st["up"], d, *h))
        bound = max(bound, _layer_bound(st["down"], d, st["up"]["lo"],
                                        st["up"]["n_out"]))
    return float(bound)


CLEAN = [("kws", "fused", "fq_conv2d", 3), ("kws", "im2col", "fq_matmul", 3),
         ("kws-ternary", "fused", "fq_conv2d", 3),
         ("kws-ternary", "im2col", "fq_matmul", 3),
         ("darknet", "fused", None, 4), ("darknet", "im2col", "fq_matmul", 4),
         ("darknet-ternary", "fused", None, 4),
         ("darknet-ternary", "im2col", "fq_matmul", 4),
         ("lm", "int8", "fq_matmul", 12)]


@pytest.mark.parametrize("name,impl,op,n", CLEAN)
def test_clean_reduced_core_proves_at_numpy_bound(name, impl, op, n):
    t = _target(name)
    (spec,) = targets.core_traces(t, impls=(impl,), mac_chunks=())
    r = Report()
    fig = intlint.lint_trace(spec, r)
    assert r.findings == [], [f.message for f in r.findings]
    (proof,) = r.proofs
    assert proof["subject"] == f"{t.name}/{impl}/clean"
    if op is None:   # DarkNet fused: K3, and K3b where a pool fuses
        assert fig["kernel_nodes"] == {"fq_conv2d": 3, "fq_conv2d_pool": 1}
    else:
        assert fig["kernel_nodes"] == {op: n}
    assert fig["contractions"] == n
    want = _lm_bound(t) if name == "lm" else _conv_bound(t, impl)
    assert fig["max_int_bound"] == want
    assert 0 < fig["int32_headroom"] < 1


@pytest.mark.parametrize("name,impl", [("kws", "fused"),
                                       ("kws-ternary", "im2col"),
                                       ("lm", "int8")])
def test_noisy_reduced_core_proves(name, impl):
    """The noise model (code perturbation by the threefry key schedule, the
    ADC field in the kernels) stays integer-pure and in int32."""
    t = _target(name)
    specs = targets.core_traces(t, impls=(impl,), mac_chunks=(4,))
    r = Report()
    fig = intlint.lint_trace(specs[1], r)
    assert r.findings == [], [f.message for f in r.findings]
    assert r.proofs[0]["subject"].endswith("/noise/mac_chunks=4")
    assert fig["nodes"] > 1000 and 0 < fig["max_int_bound"] < 2 ** 31 - 1
