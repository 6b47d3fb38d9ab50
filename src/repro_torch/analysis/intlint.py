"""intlint: dtype purity + interval analysis over traced integer cores.

Counterpart of ``repro.analysis.intlint``. Traces a stack's integer
segment (``int_core``: int8 codes in -> int8 codes out) with
``make_fx(..., tracing_mode="real")`` and abstractly interprets the fx
graph (:mod:`.absint`) to establish, per stack x impl x mac_chunks:

1. **integer purity**: no op promotes code-derived data to float outside
   the sanctioned requant/dequant edges. The sanction list is the closed
   set of float ops the deployment recipe needs, under their aten names:
   the noise model's code perturbation (``codes + sigma * g`` -> round ->
   clamp -> int cast), dequant edges, and elementwise/monotone structure
   ops. Float contractions (``mm``, ``convolution``...), float pooling
   (``max_pool2d``, ``amax``) and float reductions on tainted data are
   violations: real math left the integer domain.
2. **no accumulator overflow**: worst-case contract bounds (codes at their
   dtype's range, every reduction at its declared depth, any
   ``mac_chunks``) stay inside int32. Any signed-integer bound spill is an
   ERROR.
3. **no narrow accumulation**: an integer contraction whose accumulator is
   below 4 bytes is flagged even if its bound fits.

The kernels K2, K3 and K3b are one node each in the graph; their
contracts (``kernels.library.CONTRACTS``) stand in for their bodies: the
accumulator dtype read from ``csrc/``, the reduction depth, the weight
format and the epilogue's range.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from ..kernels.library import op_name
from . import absint
from .absint import (AbsVal, AnalysisIncomplete, Checker, Interp, node_dtype,
                     target_name)
from .report import Report

# Float ops that are sanctioned on tainted (code-derived) data: the noise
# model's perturbation and the dequant edges, and structure/monotone ops.
# Everything float and tainted outside this set is a purity finding.
SANCTIONED_TAINTED_FLOAT = frozenset({
    # requant / dequant arithmetic
    "_to_copy", "copy", "add", "sub", "rsub", "mul", "div", "neg", "abs",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "round",
    "floor", "ceil", "trunc", "sign", "exp",
    # selection & structure
    "where", "view", "_unsafe_view", "reshape", "squeeze", "unsqueeze",
    "slice", "select", "permute", "transpose", "t", "flip", "clone",
    "contiguous", "expand", "cat", "stack", "constant_pad_nd", "pad",
    "gather", "index", "index_select", "slice_scatter", "select_scatter",
    "detach", "alias", "lift_fresh_copy", "unbind", "split", "getitem",
    "full_like", "zeros_like", "ones_like", "empty_like",
    # comparisons produce bools; harmless
    "eq", "ne", "lt", "le", "gt", "ge", "isfinite",
})

# Heavy float math that is *never* sanctioned on tainted data: if one of
# these shows up tainted and float, the integer contract is broken.
_HEAVY_FLOAT = frozenset({
    "mm", "bmm", "matmul", "addmm", "linear", "convolution", "sum", "mean",
    "cumsum", "prod", "amax", "amin", "max", "min", "max_pool2d",
    "max_pool2d_with_indices", "tanh", "sigmoid", "log", "log1p", "sqrt",
    "rsqrt", "pow", "erfinv", "_softmax", "softmax", "logsumexp",
})

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _base_name(node) -> str:
    name = target_name(node.target)
    if absint._is_inplace(node.target, name) and name.endswith("_"):
        name = absint._ALIASES.get(name[:-1], name[:-1])
    return name


class IntLintChecker(Checker):
    def __init__(self, report: Report, subject: str, weight_range=None):
        self.report = report
        self.subject = subject
        self.max_acc_bound = 0.0   # widest finite integer accumulation seen
        self.contraction_depths = []
        self.kernels = collections.Counter()
        # (lo, hi) bound every contraction's WEIGHT operand must provably
        # lie in: set for packed cores to the sign-extended decode range
        # of the declared weight_format, so a broken unpack (e.g. missing
        # sign extension: fields in [0, 2^bits-1] instead of the symmetric
        # code range) is a finding, not silent garbage.
        self.weight_range = weight_range

    # -- purity --------------------------------------------------------------

    def on_node(self, interp: Interp, node, ins, out):
        if op_name(node.target) is not None:
            return   # the kernels: checked against their contracts
        if not absint._t(*ins):
            return
        name = _base_name(node)
        out_float = absint._is_float(node_dtype(node))
        in_float = any(absint._is_float(node_dtype(a))
                       for a in pytree.tree_leaves(node.args)
                       if isinstance(a, torch.fx.Node))
        if not (out_float or in_float):
            return   # pure integer op on codes: fine, purity-wise
        where = interp.where()
        if name in _HEAVY_FLOAT:
            self.report.error(
                "intlint/float-leak", self.subject,
                f"float `{name}` consumes code-derived data at {where} — "
                "integer math left the int domain", primitive=name,
                location=where, out_shape=absint.node_shape(node))
        elif name not in SANCTIONED_TAINTED_FLOAT \
                and name not in absint._TRANSFER:
            # unknown op touching floats + taint: flag, don't guess
            self.report.error(
                "intlint/float-leak", self.subject,
                f"unrecognized op `{name}` mixes tainted data with floats at "
                f"{where} — cannot prove purity", primitive=name,
                location=where)
        elif name not in SANCTIONED_TAINTED_FLOAT:
            self.report.warning(
                "intlint/unsanctioned-float", self.subject,
                f"float `{name}` on code-derived data at {where} is outside "
                "the sanctioned requant/dequant edge set", primitive=name,
                location=where)

    # -- contraction width / overflow ----------------------------------------

    def on_contraction(self, interp, node, *, depth, acc, acc_dtype,
                       weights, contract=None):
        where = interp.where()
        name = contract.op if contract is not None else _base_name(node)
        self.contraction_depths.append(depth)
        if contract is not None:
            self.kernels[contract.op] += 1
            a_dtype = node_dtype(node.args[0])
            if a_dtype is not None and a_dtype.is_floating_point:
                self.report.error(
                    "intlint/float-leak", self.subject,
                    f"kernel `{name}` ({contract.kernel}) takes {a_dtype} "
                    f"activations at {where}; its contract is "
                    f"{contract.a_dtype} codes", primitive=name,
                    location=where)
        if acc_dtype.itemsize < 4:
            self.report.error(
                "intlint/narrow-accumulator", self.subject,
                f"integer `{name}` accumulates into {acc_dtype} (itemsize "
                f"{acc_dtype.itemsize} < 4) at {where}", primitive=name,
                dtype=str(acc_dtype), depth=depth, location=where)
        if self.weight_range is not None:
            lo, hi = self.weight_range
            if not weights.finite or weights.lo < lo or weights.hi > hi:
                self.report.error(
                    "intlint/weight-range", self.subject,
                    f"`{name}` weight operand bound [{weights.lo:.3g}, "
                    f"{weights.hi:.3g}] is not provably inside the declared "
                    f"packed-weight decode range [{lo}, {hi}] at {where} — "
                    "a broken unpack (sign extension, field masks) would "
                    "look exactly like this", primitive=name,
                    lo=weights.lo, hi=weights.hi, expected=(lo, hi),
                    location=where)
        self.note_acc(acc)

    def on_signed_wrap(self, interp, node, raw: AbsVal, dtype):
        name = op_name(node.target) or _base_name(node)
        self.report.error(
            "intlint/acc-overflow", self.subject,
            f"`{name}` bound [{raw.lo:.3g}, {raw.hi:.3g}] exceeds {dtype} "
            f"range at {interp.where()} — worst-case codes can silently "
            "wrap", primitive=name, lo=raw.lo, hi=raw.hi, dtype=str(dtype),
            location=interp.where())

    def note_acc(self, v: AbsVal):
        if v.finite:
            self.max_acc_bound = max(self.max_acc_bound, abs(v.lo),
                                     abs(v.hi))


@dataclasses.dataclass
class TraceSpec:
    """One integer core to verify."""

    subject: str                   # e.g. "kws/im2col/mac_chunks=1"
    fn: Callable                   # codes -> codes (or codes -> float out)
    example_args: Sequence         # concrete tensors to trace with
    expect_float_out: bool = False
    # which positional args carry quantized codes (tainted at entry);
    # None: every integer tensor argument
    tainted_args: Optional[Sequence[int]] = None
    # (lo, hi) decode range every contraction's weight operand must
    # provably lie in: set for packed-weight cores
    # (core.quant.format_interval), None disables the check
    weight_range: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def _one_fake_mode():
    """make_fx stores each node's shape and dtype as a fake tensor; with no
    fake mode in its tracing context it builds a new one a node. One shared
    mode halves the trace time (ignored where torch lacks the hook)."""
    try:
        from torch._guards import TracingContext, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode
        ctx = tracing(TracingContext(FakeTensorMode(
            allow_fallback_kernels=True)))
    except (ImportError, AttributeError, TypeError):
        ctx = contextlib.nullcontext()
    with ctx:
        yield


def trace(fn: Callable, example_args: Sequence) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="real")(*example_args)``: the kernels
    enter the graph as their ``repro_torch::`` operators."""
    def positional(*args):   # defaulted parameters are not inputs
        return fn(*args)

    with _one_fake_mode():
        return make_fx(positional, tracing_mode="real")(*example_args)


def kernel_nodes(gm: torch.fx.GraphModule) -> collections.Counter:
    """Kernel operator nodes of a graph, by operator."""
    return collections.Counter(
        op_name(n.target) for n in gm.graph.nodes
        if n.op == "call_function" and op_name(n.target) is not None)


def _input_vals(spec: TraceSpec):
    vals = []
    for i, a in enumerate(spec.example_args):
        taint_this = spec.tainted_args is None or i in tuple(
            spec.tainted_args)
        for leaf in pytree.tree_leaves(a):
            if not isinstance(leaf, torch.Tensor):
                continue
            if taint_this and absint._is_int(leaf.dtype):
                vals.append(absint.dtype_interval(leaf.dtype, tainted=True))
            else:
                vals.append(absint.abs_of_concrete(leaf))
    return vals


def lint_trace(spec: TraceSpec, report: Report) -> Optional[dict]:
    """Trace ``spec.fn`` and abstractly interpret it; findings and proofs
    go into ``report``. Returns the trace's figures (nodes, kernel nodes,
    contractions, largest bound), or None when it failed."""
    subject = spec.subject
    t0 = time.perf_counter()
    try:
        gm = trace(spec.fn, spec.example_args)
    except Exception as e:  # noqa: BLE001 - a tracing failure is a finding
        report.error("intlint/trace-failed", subject,
                     f"make_fx failed: {type(e).__name__}: {e}")
        return None
    in_vals = _input_vals(spec)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(in_vals) != len(placeholders):
        report.error("intlint/trace-failed", subject,
                     f"arg leaves ({len(in_vals)}) != graph placeholders "
                     f"({len(placeholders)})")
        return None

    checker = IntLintChecker(report, subject,
                             weight_range=spec.weight_range)
    interp = Interp(checker)
    n_before = len(report.findings) + len(report.suppressed)
    try:
        outs = interp.run(gm, in_vals)
    except AnalysisIncomplete as e:
        report.error("intlint/analysis-incomplete", subject, str(e))
        return None
    except RecursionError:
        report.error("intlint/analysis-incomplete", subject,
                     "the graph exceeded the interpreter's recursion budget")
        return None

    # output dtype contract: integer out unless the core declares a final
    # dequant (expect_float_out)
    out_nodes = [x for x in pytree.tree_leaves(
        [n.args[0] for n in gm.graph.nodes if n.op == "output"])
        if isinstance(x, torch.fx.Node)]
    for i, (node, bound) in enumerate(zip(out_nodes, outs)):
        dtype = node_dtype(node)
        is_f = absint._is_float(dtype)
        if is_f and not spec.expect_float_out:
            report.error(
                "intlint/float-output", subject,
                f"core output {i} is {dtype} — the integer segment must "
                "hand off int codes", index=i, dtype=str(dtype))
        if not is_f:
            checker.note_acc(bound)

    depths = checker.contraction_depths
    figures = {
        "nodes": interp.node_count,
        "kernel_nodes": dict(sorted(checker.kernels.items())),
        "contractions": len(depths),
        "max_contraction_depth": max(depths) if depths else 0,
        "max_int_bound": checker.max_acc_bound,
        "int32_headroom": ((INT32_MAX - checker.max_acc_bound) / INT32_MAX
                           if checker.max_acc_bound else 1.0),
        "seconds": time.perf_counter() - t0,   # host: trace + interpret
    }
    report.count("intlint/nodes", interp.node_count)
    report.count("intlint/traces")
    for k, n in checker.kernels.items():
        report.count(f"intlint/kernel-nodes:{k}", n)
    if len(report.findings) + len(report.suppressed) > n_before:
        return figures   # violations (or exemptions) found: nothing proved
    report.prove(
        "intlint", subject,
        "integer purity + int32 accumulator safety hold at contract "
        "bounds (codes at dtype range, declared shapes)",
        **{k: v for k, v in figures.items() if k != "seconds"})
    return figures
