"""Abstract interpretation of torch.fx graphs: interval + taint domain.

The machinery behind :mod:`.intlint`, the counterpart of
``repro.analysis.absint``, which walks jaxprs. Here the graph is the one
``make_fx(fn, tracing_mode="real")`` records: aten operators, and the
kernels K2, K3 and K3b as one ``repro_torch::`` node each
(``kernels.library``). Each node is mapped to an :class:`AbsVal`, an
interval ``[lo, hi]`` bounding *every element* of the tensor, plus a
``tainted`` bit marking data derived from quantized integer codes. The
interpreter walks the nodes in order and calls back into a
:class:`Checker` at each one, so passes can flag violations.

Soundness model (docs/ANALYSIS.md, "Soundness limits"):

* Placeholders that carry codes get their dtype's range and are tainted;
  other placeholders (a noise key) keep their concrete min and max,
  untainted. ``get_attr`` constants (weights, scales) are untainted and
  known exactly: a node whose inputs are all constants is evaluated on
  them (``const``), so an unpack of packed weight bytes yields the true
  codes. A proved bound holds for every code the input dtype admits.
* The kernels have no body in the graph. Their rule is their contract
  (``kernels.library.CONTRACTS``): the int32 accumulator is the depth
  times the extreme products of the operand intervals (packed weights
  decoded from their concrete bytes, else the format's decode range), the
  ADC noise adds at most 6 sigma, and the epilogue's output range follows.
* Unknown operators fall back to their dtype's range and the join of the
  input taints (the checker's ``on_unknown`` hook sees them).
* Integer results past their dtype's range: signed ones call the
  checker's ``on_signed_wrap``; unsigned ones wrap, modular by design.
* In-place operators write their value back to the tensor and, through
  a view, to its base (a strong update when the view covers the base). A
  tensor from ``empty`` holds no value until it is written: reading it
  unwritten gives its dtype's range, and the parts never written of a
  partly written one are not bounded (``torch.empty`` holds garbage).
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.fx

from ..core import quant
from ..kernels.library import CONTRACTS, op_name

INF = float("inf")
FOLD_LIMIT = 1 << 22     # largest constant (elements) evaluated exactly
MAX_NODES = 1 << 20      # larger graphs are refused (analysis-incomplete)

# ---------------------------------------------------------------------------
# the abstract domain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Interval bound over all elements of a tensor + code-taint bit;
    ``const`` is the tensor itself when it is a known constant."""

    lo: float
    hi: float
    tainted: bool = False
    const: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.lo > self.hi:  # pragma: no cover - defensive
            object.__setattr__(self, "lo", -INF)
            object.__setattr__(self, "hi", INF)

    @property
    def finite(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)

    @property
    def concrete(self) -> bool:
        return self.lo == self.hi

    def taint(self, t: bool) -> "AbsVal":
        return self if self.tainted == t else AbsVal(self.lo, self.hi, t)

    def __repr__(self):
        t = "!" if self.tainted else ""
        return f"[{self.lo:g},{self.hi:g}]{t}"


@dataclasses.dataclass(frozen=True)
class Uninit:
    """A tensor from ``empty``: no value until written."""

    dtype: torch.dtype

    def read(self) -> AbsVal:
        return dtype_interval(self.dtype)


def join(*vals: AbsVal) -> AbsVal:
    return AbsVal(min(v.lo for v in vals), max(v.hi for v in vals),
                  any(v.tainted for v in vals))


def _is_int(dtype) -> bool:
    return (isinstance(dtype, torch.dtype) and not dtype.is_floating_point
            and not dtype.is_complex and dtype != torch.bool)


def _is_float(dtype) -> bool:
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def _signed(dtype) -> bool:
    return _is_int(dtype) and torch.iinfo(dtype).min < 0


def dtype_interval(dtype, tainted: bool = False) -> AbsVal:
    """Range every element of a tensor of this dtype must lie in."""
    if isinstance(dtype, np.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    if dtype == torch.bool:
        return AbsVal(0, 1, tainted)
    if _is_int(dtype):
        ii = torch.iinfo(dtype)
        return AbsVal(float(ii.min), float(ii.max), tainted)
    return AbsVal(-INF, INF, tainted)


def abs_of_concrete(x, tainted: bool = False, keep: bool = False) -> AbsVal:
    """Abstract a concrete tensor (or number) by its actual min/max;
    ``keep`` also keeps the tensor itself as the value's ``const``."""
    if isinstance(x, (bool, int, float)):
        return AbsVal(float(x), float(x), tainted)
    t = torch.as_tensor(x)
    if t.numel() == 0:
        return AbsVal(0.0, 0.0, tainted, t if keep else None)
    if t.dtype == torch.bool:
        t2 = t.to(torch.uint8)
    elif t.is_floating_point() or _is_int(t.dtype):
        t2 = t
    else:
        return AbsVal(-INF, INF, tainted)
    lo, hi = torch.aminmax(t2.to(torch.float64) if t2.dtype in (
        torch.uint16, torch.uint32, torch.uint64) else t2)
    lo, hi = float(lo), float(hi)
    if math.isnan(lo) or math.isnan(hi):
        return AbsVal(-INF, INF, tainted)
    return AbsVal(lo, hi, tainted, t if keep else None)


# ---------------------------------------------------------------------------
# checker callback
# ---------------------------------------------------------------------------


class Checker:
    """Per-node hooks; intlint subclasses this to emit findings."""

    def on_node(self, interp: "Interp", node, ins: Sequence, out):
        pass

    def on_unknown(self, interp: "Interp", node, ins, out):
        pass

    def on_signed_wrap(self, interp: "Interp", node, raw: AbsVal, dtype):
        """A signed-integer result's exact bound spilled past its dtype's
        range (a potential silent overflow). Unsigned wrap is modular by
        design and does not reach this hook."""
        pass

    def on_contraction(self, interp: "Interp", node, *, depth: int,
                       acc: AbsVal, acc_dtype: torch.dtype,
                       weights: AbsVal, contract=None):
        """An integer contraction: an aten matmul or conv on integer
        tensors, or a kernel node (``contract`` set), with its
        accumulator's bound before any wrap."""
        pass


class AnalysisIncomplete(Exception):
    """Raised when the abstract run cannot bound something it must bound."""


# ---------------------------------------------------------------------------
# interval helpers
# ---------------------------------------------------------------------------


def _mul_bound(a: float, b: float) -> float:
    # inf * 0 is nan in IEEE; the exact product over a set holding 0 is 0
    r = a * b
    return 0.0 if math.isnan(r) else r


def _interval_mul(a: AbsVal, b: AbsVal) -> Tuple[float, float]:
    c = [_mul_bound(a.lo, b.lo), _mul_bound(a.lo, b.hi),
         _mul_bound(a.hi, b.lo), _mul_bound(a.hi, b.hi)]
    return min(c), max(c)


def _monotone(fn: Callable[[float], float], a: AbsVal) -> Tuple[float, float]:
    try:
        lo, hi = fn(a.lo), fn(a.hi)
    except (OverflowError, ValueError):
        return -INF, INF
    if math.isnan(lo) or math.isnan(hi):
        return -INF, INF
    return min(lo, hi), max(lo, hi)


def _safe_exp(x: float) -> float:
    if x == -INF:
        return 0.0
    try:
        return math.exp(x)
    except OverflowError:
        return INF


def _pow2_mask_above(hi: float) -> float:
    """Smallest 2^k - 1 >= hi (an all-ones mask covering hi's bits)."""
    m = 1
    while m - 1 < int(hi):
        m <<= 1
    return float(m - 1)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

# ops whose output aliases their first argument (an in-place write through
# them reaches the base)
_VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "slice", "select", "unsqueeze",
    "squeeze", "expand", "permute", "transpose", "t", "alias", "unfold",
    "as_strided", "diagonal", "narrow", "detach", "view_as", "expand_as",
    "movedim", "flatten"})
_NO_FOLD = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "rand", "randn", "randint",
                      "rand_like", "randn_like", "normal", "uniform",
                      "bernoulli"})
_ALIASES = {"__rshift__": "bitwise_right_shift",
            "__lshift__": "bitwise_left_shift", "__and__": "bitwise_and",
            "__or__": "bitwise_or", "__xor__": "bitwise_xor",
            "rshift": "bitwise_right_shift", "lshift": "bitwise_left_shift"}


def target_name(target) -> str:
    """``aten.add_.Tensor`` -> ``"add_"``; ``operator.getitem`` ->
    ``"getitem"``; a kernel operator -> its name."""
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "_opname", None) or getattr(target, "__name__",
                                                       str(target))
    return _ALIASES.get(name, name)


def _is_inplace(target, name: str) -> bool:
    schema = getattr(target, "_schema", None)
    return (schema is not None and schema.is_mutable
            and not name.startswith("_"))


def _meta(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def node_dtype(node) -> Optional[torch.dtype]:
    v = _meta(node)
    if isinstance(v, (list, tuple)):
        v = v[0] if v else None
    return getattr(v, "dtype", None)


def node_shape(node) -> Optional[Tuple[int, ...]]:
    v = _meta(node)
    return None if getattr(v, "shape", None) is None else tuple(v.shape)


def _numel(node) -> Optional[int]:
    v = _meta(node)
    if isinstance(v, (list, tuple)):
        return sum(int(x.numel()) for x in v if hasattr(x, "numel"))
    return int(v.numel()) if hasattr(v, "numel") else None


class Interp:
    """Walks one fx graph; :meth:`run` returns the outputs' values."""

    def __init__(self, checker: Optional[Checker] = None):
        self.checker = checker or Checker()
        self.node: Optional[torch.fx.Node] = None
        self.node_count = 0
        self._base: Dict = {}

    def where(self) -> str:
        n = self.node
        return "<top>" if n is None else f"{n.name} ({n.target})"

    # -- entry point ---------------------------------------------------------

    def run(self, gm: torch.fx.GraphModule,
            in_vals: Sequence[AbsVal]) -> List[AbsVal]:
        nodes = list(gm.graph.nodes)
        if len(nodes) > MAX_NODES:
            raise AnalysisIncomplete(
                f"graph has {len(nodes)} nodes (> {MAX_NODES})")
        env: Dict = {}
        self._env = env
        self._base = {}
        ins = iter(in_vals)
        outs = []
        for node in nodes:
            self.node = node
            if node.op == "placeholder":
                env[node] = next(ins)
            elif node.op == "get_attr":
                t = gm
                for part in node.target.split("."):
                    t = getattr(t, part)
                env[node] = abs_of_concrete(t, keep=True)
            elif node.op == "call_function":
                self.node_count += 1
                env[node] = self._eval(node)
            elif node.op == "output":
                outs = [self._read(x) for x in torch.utils._pytree.
                        tree_leaves(node.args[0])
                        if isinstance(x, torch.fx.Node)]
            else:
                raise AnalysisIncomplete(
                    f"node {node.name} is a {node.op!r}: only aten and "
                    "kernel calls are interpreted")
        self.node = None
        return outs

    def _read(self, node) -> AbsVal:
        v = self._env[node]
        if isinstance(v, Uninit):
            return v.read()
        if isinstance(v, (list, tuple)):
            return join(*[self._val(x) for x in v])
        return v

    @staticmethod
    def _val(x) -> AbsVal:
        if isinstance(x, Uninit):
            return x.read()
        return x

    def _arg(self, a):
        if isinstance(a, torch.fx.Node):
            return self._env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x) for x in a)
        return a

    # -- one node ------------------------------------------------------------

    def _eval(self, node):
        name = target_name(node.target)
        args = [self._arg(a) for a in node.args]
        kwargs = {k: self._arg(v) for k, v in node.kwargs.items()}
        if op_name(node.target) is not None:
            out = _kernel(self, node, args, kwargs)
            self.checker.on_node(self, node, args, out)
            return out
        inplace = _is_inplace(node.target, name)
        out = self._fold(node, name, args, kwargs, inplace)
        if out is None:
            base = name[:-1] if inplace and name.endswith("_") else name
            base = _ALIASES.get(base, base)
            fn = _TRANSFER.get(base)
            vals = [self._val(a) if isinstance(a, Uninit) else a
                    for a in args]
            if fn is None:
                out = self._unknown(node, vals)
                self.checker.on_unknown(self, node, vals, out)
            else:
                out = fn(self, node, vals, kwargs)
        if inplace and node.args and isinstance(node.args[0],
                                                torch.fx.Node):
            self._write(node.args[0], out)
        if name in _VIEWS and node.args and isinstance(node.args[0],
                                                       torch.fx.Node):
            self._base[node] = self._base.get(node.args[0], node.args[0])
        self.checker.on_node(self, node, args, out)
        return out

    def _fold(self, node, name, args, kwargs, inplace):
        """Evaluate a node whose tensor inputs are all constants."""
        if inplace or name in _NO_FOLD or name == "getitem":
            return None
        if not str(getattr(node.target, "namespace", "")) == "aten":
            return None
        n = _numel(node)
        if n is None or n > FOLD_LIMIT:
            return None
        ok = [True]

        def sub(x):
            if isinstance(x, AbsVal):
                if x.const is None:
                    ok[0] = False
                return x.const
            if isinstance(x, Uninit):
                ok[0] = False
                return None
            if isinstance(x, (list, tuple)):
                return type(x)(sub(y) for y in x)
            return x
        cargs = [sub(a) for a in args]
        ckw = {k: sub(v) for k, v in kwargs.items()}
        if not ok[0]:
            return None
        res = node.target(*cargs, **ckw)
        if isinstance(res, (list, tuple)):
            return [abs_of_concrete(r, keep=True) for r in res]
        return abs_of_concrete(res, keep=True)

    def _write(self, dst, val):
        """An in-place write of ``val`` into ``dst`` (and its base)."""
        self._env[dst] = val
        base = self._base.get(dst)
        if base is None:
            return
        old = self._env[base]
        if node_dtype(base) != node_dtype(dst):
            self._env[base] = dtype_interval(node_dtype(base),
                                             self._val(old).tainted
                                             or val.tainted)
        elif isinstance(old, Uninit) or _numel(dst) == _numel(base):
            self._env[base] = val
        else:
            self._env[base] = join(old, val)

    def _unknown(self, node, ins):
        """Dtype-top fallback: sound for any elementwise/structural op."""
        t = _t(*ins)
        v = _meta(node)
        if isinstance(v, (list, tuple)):
            return [dtype_interval(x.dtype, t) for x in v]
        return dtype_interval(node_dtype(node), t)


# ---------------------------------------------------------------------------
# transfer functions: f(interp, node, args, kwargs) -> value
# ---------------------------------------------------------------------------


def _t(*xs) -> bool:
    out = False
    for x in xs:
        if isinstance(x, AbsVal):
            out = out or x.tainted
        elif isinstance(x, (list, tuple)):
            out = out or _t(*x)
    return out


def _v(x) -> AbsVal:
    """An argument as an interval (Python numbers are exact)."""
    if isinstance(x, AbsVal):
        return x
    if isinstance(x, Uninit):
        return x.read()
    if isinstance(x, (bool, int, float)):
        return AbsVal(float(x), float(x))
    return AbsVal(-INF, INF)


def _clip_wrap(interp: Interp, node, v: AbsVal,
               dtype: Optional[torch.dtype] = None) -> AbsVal:
    """Integer results past their dtype's range: signed ones notify the
    checker (a potential silent overflow) and widen to the range; unsigned
    ones wrap (modular). Bools are [0, 1]; floats pass."""
    dtype = dtype or node_dtype(node)
    if dtype == torch.bool:
        return AbsVal(0, 1, v.tainted)
    if not _is_int(dtype):
        return AbsVal(v.lo, v.hi, v.tainted)
    rng = dtype_interval(dtype)
    if v.lo < rng.lo or v.hi > rng.hi:
        if _signed(dtype):
            interp.checker.on_signed_wrap(interp, node, v, dtype)
        return AbsVal(rng.lo, rng.hi, v.tainted)
    return AbsVal(v.lo, v.hi, v.tainted)


def _pass(interp, node, args, kw):
    a = _v(args[0])
    out = AbsVal(a.lo, a.hi, a.tainted)
    v = _meta(node)
    return [out] * len(v) if isinstance(v, (list, tuple)) else out


def _pass_pair(interp, node, args, kw):
    """(values, indices): max.dim, max_pool2d_with_indices."""
    a = _v(args[0])
    return [AbsVal(a.lo, a.hi, a.tainted), dtype_interval(torch.int64)]


def _scaled(b: AbsVal, alpha) -> AbsVal:
    if alpha is None or alpha == 1:
        return b
    lo, hi = _interval_mul(b, _v(alpha))
    return AbsVal(lo, hi, b.tainted)


def _add(interp, node, args, kw):
    a, b = _v(args[0]), _scaled(_v(args[1]), kw.get("alpha"))
    return _clip_wrap(interp, node, AbsVal(a.lo + b.lo, a.hi + b.hi,
                                           _t(a, b)))


def _sub(interp, node, args, kw):
    a, b = _v(args[0]), _scaled(_v(args[1]), kw.get("alpha"))
    return _clip_wrap(interp, node, AbsVal(a.lo - b.hi, a.hi - b.lo,
                                           _t(a, b)))


def _rsub(interp, node, args, kw):
    return _sub(interp, node, [args[1], args[0]], kw)


def _mul(interp, node, args, kw):
    a, b = _v(args[0]), _v(args[1])
    lo, hi = _interval_mul(a, b)
    return _clip_wrap(interp, node, AbsVal(lo, hi, _t(a, b)))


def _div(interp, node, args, kw):
    a, b = _v(args[0]), _v(args[1])
    t = _t(a, b)
    if b.lo <= 0 <= b.hi or not (a.finite and b.finite):
        return dtype_interval(node_dtype(node), t)
    rnd = {"floor": math.floor, "trunc": math.trunc}.get(
        kw.get("rounding_mode"), lambda q: q)
    cands = [rnd(x / y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return _clip_wrap(interp, node, AbsVal(min(cands), max(cands), t))


def _floor_divide(interp, node, args, kw):
    return _div(interp, node, args, {"rounding_mode": "floor"})


def _remainder(interp, node, args, kw):
    a, b = _v(args[0]), _v(args[1])
    t = _t(a, b)
    if b.finite and b.lo > 0:
        if a.lo >= 0 and _is_int(node_dtype(node)):
            return AbsVal(0, min(b.hi - 1, a.hi), t)
        return AbsVal(0, b.hi, t)
    return dtype_interval(node_dtype(node), t)


def _neg(interp, node, args, kw):
    a = _v(args[0])
    return _clip_wrap(interp, node, AbsVal(-a.hi, -a.lo, a.tainted))


def _abs(interp, node, args, kw):
    a = _v(args[0])
    if a.lo >= 0:
        return AbsVal(a.lo, a.hi, a.tainted)
    hi = max(abs(a.lo), abs(a.hi))
    lo = 0.0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
    return _clip_wrap(interp, node, AbsVal(lo, hi, a.tainted))


def _sign(interp, node, args, kw):
    return AbsVal(-1, 1, _v(args[0]).tainted)


def _maximum(interp, node, args, kw):
    a, b = _v(args[0]), _v(args[1])
    return AbsVal(max(a.lo, b.lo), max(a.hi, b.hi), _t(a, b))


def _minimum(interp, node, args, kw):
    a, b = _v(args[0]), _v(args[1])
    return AbsVal(min(a.lo, b.lo), min(a.hi, b.hi), _t(a, b))


def _clamp(interp, node, args, kw):
    x = _v(args[0])
    mn = args[1] if len(args) > 1 else kw.get("min")
    mx = args[2] if len(args) > 2 else kw.get("max")
    lo, hi, t = x.lo, x.hi, x.tainted
    if mn is not None:
        m = _v(mn)
        lo, hi, t = max(lo, m.lo), max(hi, m.lo), t or m.tainted
    if mx is not None:
        m = _v(mx)
        lo, hi, t = min(lo, m.hi), min(hi, m.hi), t or m.tainted
    return AbsVal(min(lo, hi), hi, t)


def _clamp_min(interp, node, args, kw):
    return _clamp(interp, node, [args[0], args[1], None], {})


def _clamp_max(interp, node, args, kw):
    return _clamp(interp, node, [args[0], None, args[1]], {})


def _round_like(fn):
    def rule(interp, node, args, kw):
        a = _v(args[0])
        lo = a.lo if not math.isfinite(a.lo) else float(fn(a.lo))
        hi = a.hi if not math.isfinite(a.hi) else float(fn(a.hi))
        return AbsVal(lo, hi, a.tainted)
    return rule


def _exp(interp, node, args, kw):
    lo, hi = _monotone(_safe_exp, _v(args[0]))
    return AbsVal(lo, hi, _v(args[0]).tainted)


def _log(interp, node, args, kw, shift=0.0):
    """log(x + shift): monotone where x + shift > 0."""
    a = _v(args[0])
    lo, hi = a.lo + shift, a.hi + shift
    if hi <= 0:
        return AbsVal(-INF, INF, a.tainted)
    return AbsVal(math.log(lo) if lo > 0 else -INF,
                  math.log(hi) if math.isfinite(hi) else INF, a.tainted)


def _log1p(interp, node, args, kw):
    return _log(interp, node, args, kw, shift=1.0)


def _sqrt(interp, node, args, kw):
    a = _v(args[0])
    lo = math.sqrt(max(a.lo, 0.0)) if math.isfinite(a.lo) else 0.0
    hi = math.sqrt(a.hi) if (math.isfinite(a.hi) and a.hi >= 0) else INF
    return AbsVal(lo, hi, a.tainted)


def _unbounded(interp, node, args, kw):
    return AbsVal(-INF, INF, _t(*args))


def _convert(interp, node, args, kw):
    """``_to_copy`` / ``copy_``: a dtype conversion, floats truncated
    toward zero into integers."""
    a = _v(args[1] if target_name(node.target).startswith("copy")
           else args[0])
    dtype = node_dtype(node)
    if dtype == torch.bool:
        return AbsVal(0, 1, a.tainted)
    if _is_int(dtype):
        lo = a.lo if not math.isfinite(a.lo) else float(math.trunc(a.lo))
        hi = a.hi if not math.isfinite(a.hi) else float(math.trunc(a.hi))
        return _clip_wrap(interp, node, AbsVal(lo, hi, a.tainted), dtype)
    return AbsVal(a.lo, a.hi, a.tainted)


def _bitcast(interp, node, args, kw):
    """``view(dtype)``: int32 bit patterns of non-negative finite floats
    read as float32 are monotone in the pattern."""
    a = _v(args[0])
    src, dst = node_dtype(node.args[0]), node_dtype(node)
    if (src == torch.int32 and dst == torch.float32 and a.finite
            and 0 <= a.lo and a.hi <= 0x7F7FFFFF):
        f = np.array([int(a.lo), int(a.hi)], np.int32).view(np.float32)
        return AbsVal(float(f[0]), float(f[1]), a.tainted)
    return dtype_interval(dst, a.tainted)


def _view(interp, node, args, kw):
    if len(node.args) > 1 and isinstance(node.args[1], torch.dtype):
        return _bitcast(interp, node, args, kw)
    return _pass(interp, node, args, kw)


def _fill(value):
    def rule(interp, node, args, kw):
        return AbsVal(float(value), float(value))
    return rule


def _full_like(interp, node, args, kw):
    return _v(args[1] if len(args) > 1 else kw.get("fill_value"))


def _full(interp, node, args, kw):
    return _v(args[1] if len(args) > 1 else kw.get("fill_value"))


def _new_full(interp, node, args, kw):
    return _v(args[2] if len(args) > 2 else kw.get("fill_value"))


def _empty(interp, node, args, kw):
    return Uninit(node_dtype(node))


def _arange(interp, node, args, kw):
    nums = [float(a) for a in args if isinstance(a, (int, float))]
    if len(nums) == 1:
        start, end, step = 0.0, nums[0], 1.0
    else:
        start, end = nums[0], nums[1]
        step = nums[2] if len(nums) > 2 else 1.0
    last = start + step * max(math.ceil((end - start) / step) - 1, 0)
    return AbsVal(min(start, last), max(start, last))


def _where(interp, node, args, kw):
    c, a, b = _v(args[0]), _v(args[1]), _v(args[2])
    out = join(a, b)
    return out.taint(out.tainted or c.tainted)


def _cat(interp, node, args, kw):
    return join(*[_v(x) for x in args[0]])


def _pad(interp, node, args, kw):
    x = _v(args[0])
    pads = args[1] if len(args) > 1 else kw.get("pad", ())
    if not any(p > 0 for p in pads):
        return x
    value = args[2] if len(args) > 2 else kw.get("value", 0.0)
    return join(x, _v(0.0 if value is None else value))


def _scatter_like(interp, node, args, kw):
    """``slice_scatter``, ``select_scatter``, ``index_put``, ``scatter``,
    ``masked_fill``: the base joined with what is written."""
    vals = [_v(a) for a in args
            if isinstance(a, (AbsVal, Uninit, int, float))]
    return join(*vals)


def _cmp(interp, node, args, kw):
    return AbsVal(0, 1, _t(*args))


def _bitwise_not(interp, node, args, kw):
    a = _v(args[0])
    if node_dtype(node) == torch.bool:
        return AbsVal(0, 1, a.tainted)
    if _signed(node_dtype(node)):   # ~x == -x - 1
        return AbsVal(-a.hi - 1, -a.lo - 1, a.tainted)
    return dtype_interval(node_dtype(node), a.tainted)


def _bitwise_and(interp, node, args, kw):
    """x & y stays in [0, x] whenever x >= 0, for any y (every result bit
    is one of x's bits): what bounds masks and the packed unpack chains."""
    if node_dtype(node) == torch.bool:
        return AbsVal(0, 1, _t(*args))
    vals = [_v(a) for a in args[:2]]
    his = [v.hi for v in vals if v.lo >= 0 and v.finite]
    if his:
        return AbsVal(0.0, float(min(his)), _t(*vals))
    return dtype_interval(node_dtype(node), _t(*vals))


def _bitwise_or_xor(interp, node, args, kw):
    """For non-negative x, y: x|y and x^y set no bit above max(x, y)'s
    highest, so both lie in [0, 2^k - 1]; x|y >= max(x, y)."""
    if node_dtype(node) == torch.bool:
        return AbsVal(0, 1, _t(*args))
    a, b = _v(args[0]), _v(args[1])
    t = _t(a, b)
    if a.lo >= 0 and b.lo >= 0 and a.finite and b.finite:
        hi = _pow2_mask_above(max(a.hi, b.hi))
        lo = (max(a.lo, b.lo)
              if target_name(node.target).startswith("bitwise_or") else 0.0)
        return AbsVal(lo, hi, t)
    return dtype_interval(node_dtype(node), t)


def _shift_left(interp, node, args, kw):
    a, s = _v(args[0]), _v(args[1])
    t = _t(a, s)
    if a.finite and s.concrete and s.finite and 0 <= s.lo < 63:
        k = int(s.lo)
        return _clip_wrap(interp, node, AbsVal(float(int(a.lo) << k),
                                               float(int(a.hi) << k), t))
    return dtype_interval(node_dtype(node), t)


def _shift_right(interp, node, args, kw):
    """torch's >> on signed integers is arithmetic: Python's >>."""
    a, s = _v(args[0]), _v(args[1])
    t = _t(a, s)
    if a.finite and s.finite and s.lo >= 0:
        lo = int(a.lo) >> int(s.hi if a.lo >= 0 else s.lo)
        hi = int(a.hi) >> int(s.lo if a.hi >= 0 else s.hi)
        return AbsVal(float(lo), float(hi), t)
    return dtype_interval(node_dtype(node), t)


def _reduce_count(node, dims) -> int:
    shape = node_shape(node.args[0]) or ()
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return int(np.prod(shape)) if shape else 1
    if isinstance(dims, int):
        dims = [dims]
    return int(np.prod([shape[d] for d in dims]))


def _sum(interp, node, args, kw):
    a = _v(args[0])
    dims = args[1] if len(args) > 1 else kw.get("dim")
    n = _reduce_count(node, dims)
    lo, hi = _interval_mul(a, AbsVal(n, n))
    return _clip_wrap(interp, node, AbsVal(lo, hi, a.tainted))


def _cumsum(interp, node, args, kw):
    a = _v(args[0])
    n = _reduce_count(node, args[1] if len(args) > 1 else kw.get("dim"))
    lo, hi = _interval_mul(a, AbsVal(n, n))
    return _clip_wrap(interp, node, AbsVal(min(lo, a.lo), max(hi, a.hi),
                                           a.tainted))


def _contract(interp, node, a: AbsVal, w: AbsVal, depth: int,
              bias: Optional[AbsVal] = None):
    plo, phi = _interval_mul(a, w)
    lo, hi = _interval_mul(AbsVal(plo, phi), AbsVal(depth, depth))
    acc = AbsVal(lo, hi, _t(a, w))
    if bias is not None:
        acc = AbsVal(acc.lo + bias.lo, acc.hi + bias.hi, acc.tainted
                     or bias.tainted)
    dtype = node_dtype(node)
    if _is_int(dtype):
        interp.checker.on_contraction(interp, node, depth=depth, acc=acc,
                                      acc_dtype=dtype, weights=w)
    return _clip_wrap(interp, node, acc)


def _mm(interp, node, args, kw):
    shape = node_shape(node.args[0])
    return _contract(interp, node, _v(args[0]), _v(args[1]), shape[-1])


def _addmm(interp, node, args, kw):
    shape = node_shape(node.args[1])
    return _contract(interp, node, _v(args[1]), _v(args[2]), shape[-1],
                     bias=_v(args[0]))


def _linear(interp, node, args, kw):
    shape = node_shape(node.args[0])
    bias = _v(args[2]) if len(args) > 2 and args[2] is not None else None
    return _contract(interp, node, _v(args[0]), _v(args[1]), shape[-1],
                     bias=bias)


def _convolution(interp, node, args, kw):
    wshape = node_shape(node.args[1])
    depth = int(np.prod(wshape[1:]))
    bias = _v(args[2]) if len(args) > 2 and args[2] is not None else None
    return _contract(interp, node, _v(args[0]), _v(args[1]), depth,
                     bias=bias)


def _getitem(interp, node, args, kw):
    return args[0][args[1]]


# ---------------------------------------------------------------------------
# the kernels: their contracts stand in for their bodies
# ---------------------------------------------------------------------------


def bind(node) -> Dict:
    """A kernel node's arguments by schema name."""
    schema = node.target._schema
    out = {}
    for i, arg in enumerate(schema.arguments):
        if i < len(node.args):
            out[arg.name] = node.args[i]
        elif arg.name in node.kwargs:
            out[arg.name] = node.kwargs[arg.name]
    return out


def decoded_weights(w: AbsVal, fmt: str) -> AbsVal:
    """The interval of the codes a kernel decodes from its weight operand:
    packed bytes that are constants are decoded; other packed bytes give
    the format's sign-extended range."""
    if fmt == "int8":
        return w
    if w.const is not None:
        return abs_of_concrete(quant.unpack_codes(w.const, fmt),
                               tainted=w.tainted)
    lo, hi = quant.format_interval(fmt)
    return AbsVal(lo, hi, w.tainted)


def _kernel(interp: Interp, node, args, kwargs):
    name = op_name(node.target)
    contract = CONTRACTS.get(name)
    if contract is None:
        raise AnalysisIncomplete(f"kernel operator {name!r} has no contract")
    raw = bind(node)
    vals = dict(zip([a.name for a in node.target._schema.arguments], args))
    vals.update(kwargs)
    shapes = {k: (node_shape(v) if isinstance(v, torch.fx.Node) else v)
              for k, v in raw.items()}
    a = _v(vals["a_codes"])
    fmt = shapes["weight_format"]
    w = decoded_weights(_v(vals[contract.weights]), fmt)
    depth = contract.depth(shapes)
    plo, phi = _interval_mul(a, w)
    lo, hi = _interval_mul(AbsVal(plo, phi), AbsVal(depth, depth))
    acc = AbsVal(lo, hi, _t(a, w))
    interp.checker.on_contraction(interp, node, depth=depth, acc=acc,
                                  acc_dtype=contract.acc_dtype, weights=w,
                                  contract=contract)
    acc = _clip_wrap(interp, node, acc, contract.acc_dtype)
    sigma = vals.get("noise_sigma_acc")
    if sigma is not None:
        # the ADC field is (sigma / K) times a sum of K draws in [-6, 6]
        s = _v(sigma)
        m = 6.0 * max(abs(s.lo), abs(s.hi))
        acc = AbsVal(acc.lo - m, acc.hi + m, acc.tainted or s.tainted)
    lo, hi = _interval_mul(acc, _v(vals["scale"]))
    t = acc.tainted or _v(vals["scale"]).tainted
    rng = contract.out_range(shapes)
    if rng is None:
        return AbsVal(lo, hi, t)
    lo = lo if not math.isfinite(lo) else float(np.round(lo))
    hi = hi if not math.isfinite(hi) else float(np.round(hi))
    out = AbsVal(min(max(lo, rng[0]), rng[1]), max(min(hi, rng[1]), rng[0]),
                 t)
    return _clip_wrap(interp, node, AbsVal(min(out.lo, out.hi), out.hi, t),
                      torch.int8)


_TRANSFER: Dict[str, Callable] = {
    # structure
    **{k: _pass for k in (
        "_unsafe_view", "reshape", "slice", "select", "unsqueeze",
        "squeeze", "expand", "permute", "transpose", "t", "alias", "unfold",
        "as_strided", "diagonal", "narrow", "detach", "view_as",
        "expand_as", "movedim", "flatten", "clone", "contiguous",
        "lift_fresh_copy", "lift_fresh", "index", "index_select", "gather",
        "take", "repeat", "roll", "flip", "amax", "amin", "max_pool2d",
        "mean", "unbind", "split", "split_with_sizes", "chunk",
        "nextafter", "to", "_to_dim_order_copy")},
    "view": _view, "_to_copy": _convert, "copy": _convert,
    "max": _pass_pair, "min": _pass_pair,
    "max_pool2d_with_indices": _pass_pair,
    "cat": _cat, "stack": _cat, "constant_pad_nd": _pad, "pad": _pad,
    "slice_scatter": _scatter_like, "select_scatter": _scatter_like,
    "index_put": _scatter_like, "scatter": _scatter_like,
    "masked_fill": _scatter_like, "where": _where,
    # arithmetic
    "add": _add, "sub": _sub, "rsub": _rsub, "mul": _mul, "div": _div,
    "floor_divide": _floor_divide, "remainder": _remainder,
    "fmod": _remainder, "neg": _neg, "abs": _abs, "sign": _sign,
    "maximum": _maximum, "minimum": _minimum, "fmax": _maximum,
    "fmin": _minimum, "clamp": _clamp, "clamp_min": _clamp_min,
    "clamp_max": _clamp_max, "round": _round_like(np.round),
    "floor": _round_like(math.floor), "ceil": _round_like(math.ceil),
    "trunc": _round_like(math.trunc),
    "exp": _exp, "log": _log, "log1p": _log1p, "sqrt": _sqrt,
    "rsqrt": _unbounded, "erfinv": _unbounded, "pow": _unbounded,
    "tanh": lambda i, n, a, k: AbsVal(-1, 1, _t(*a)),
    "sigmoid": lambda i, n, a, k: AbsVal(0, 1, _t(*a)),
    # comparisons / logic
    **{k: _cmp for k in ("eq", "ne", "lt", "le", "gt", "ge", "isfinite",
                         "isnan", "isinf", "logical_and", "logical_or",
                         "logical_not", "logical_xor")},
    "bitwise_and": _bitwise_and, "bitwise_or": _bitwise_or_xor,
    "bitwise_xor": _bitwise_or_xor, "bitwise_not": _bitwise_not,
    "bitwise_left_shift": _shift_left,
    "bitwise_right_shift": _shift_right,
    # factories
    "zeros": _fill(0), "zeros_like": _fill(0), "new_zeros": _fill(0),
    "ones": _fill(1), "ones_like": _fill(1), "new_ones": _fill(1),
    "full": _full, "full_like": _full_like, "new_full": _new_full,
    "scalar_tensor": lambda i, n, a, k: _v(a[0]),
    "empty": _empty, "empty_like": _empty, "new_empty": _empty,
    "empty_strided": _empty, "arange": _arange,
    # reductions / contractions
    "sum": _sum, "cumsum": _cumsum,
    "mm": _mm, "bmm": _mm, "matmul": _mm, "_int_mm": _mm, "addmm": _addmm,
    "linear": _linear, "convolution": _convolution,
    "getitem": _getitem,
}
