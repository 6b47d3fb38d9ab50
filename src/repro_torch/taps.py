"""Taps on a training forward, to hold one run of it against another.

Two runs of one float forward (the port on the card and on the CPU, or the
port against the JAX reference) sum in other orders, so where a value sits
on a boundary the runs part on a discrete choice:

  * a quantizer's code (a *code flip*: the input rounds to another code;
    a *rounding tie* where both runs' inputs lie within float32 rounding
    of the half-LSB boundary between the two codes, as sums of lattice
    values do);
  * whether the input sits on a clip bound, where the straight-through
    gradient is 0.5, against 1 inside and 0 outside (a *tie flip*: a conv
    of quantized operands sums to exactly 0 in one order and not in the
    other);
  * the element of a 2x2 max-pool window that is its maximum (a *pool
    flip*: the gradient goes to another position);
  * the side of 0 of a ReLU's or leaky ReLU's input (a *ReLU flip*:
    gradient 1 against 0 or 0.1).

Each moves one gradient term by O(1). :class:`Taps` wraps the functions
that make those choices (``fq_layers.learned_quantize``, KWS's and the
ResNets' ReLU, DarkNet's leaky ReLU and the float max-pool
``kernels.ops.maxpool2d``;
a pool of int8 codes passes through untapped), records their inputs, counts the positions
where this run parts from a reference run's inputs and pins them to the
reference's values (the value pinned, the gradient passed through), so that
both runs differentiate the same forward. It also sums, for the leaves
named in ``paths``, the magnitude M of the terms each one's gradient sums: a
log-scale's over its quantizers and noise draws, BN's gamma and beta over
positions. Those terms cancel, so float32 sums of them in two orders
differ by ~sqrt(N) eps M, whatever the result. Where a reference run is
given, it also sums for each log-scale D, the terms' forward difference:
g x sum |dL/dQ| x |x - x_ref| over its quantizers' inputs. A log-scale
whose every term is 0 in exact arithmetic (its quantizer's inputs exactly
0 wherever gradient flows) has M = 0 in one run and float32 residue in the
other; D bounds that residue.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from . import tree
from .core import fq_layers as fql
from .core import quant
from .kernels import ops
from .models import darknet, kws, resnet

# A code flip is a rounding tie where both inputs lie within this much of
# the half-LSB boundary, relative to the boundary (in LSBs, at least 1):
# 128 float32 ulps
ROUND_TIE_EPS = 2.0 ** -16

# (module, function name) of each tapped function
_TAPPED = ((fql, "learned_quantize"), (fql, "add_lsb_noise"),
           (fql, "batchnorm"), (ops, "maxpool2d"),
           (darknet, "_leaky_relu"), (kws, "_relu"), (resnet, "_relu"))
# of them, the models' (leaky) ReLUs, tapped by the sign of their input
_SIGNED = ("_relu", "_leaky_relu")


def category(x, e, b, n):
    """(code, clip class, clipped input in LSBs) of ``x`` under the
    quantizer of scale ``e``, lower bound ``b`` and ``n`` levels: the class
    is 0 below b, 1 on b, 2 inside, 3 on 1, 4 above 1."""
    v = torch.div(x, e)
    u = torch.clamp(v, b, 1.0) * n
    cls = torch.where(v < b, 0, torch.where(v == b, 1, torch.where(
        v < 1, 2, torch.where(v == 1, 3, 4))))
    return torch.round(u), cls, u


def rounding_ties(code, u, code_r, u_r):
    """Where the two codes are one apart and both inputs (in LSBs) lie
    within ROUND_TIE_EPS of the half-LSB boundary between them."""
    mid = (code + code_r) / 2
    tol = ROUND_TIE_EPS * torch.clamp(mid.abs(), min=1.0)
    return (((code - code_r).abs() == 1) & ((u - mid).abs() <= tol)
            & ((u_r - mid).abs() <= tol))


def _pin(x, mask, ref):
    """``ref``'s value at ``mask``, ``x``'s elsewhere; ``x``'s gradient."""
    if not bool(mask.any()):
        return x
    return torch.where(mask, ref, x) + torch.where(
        mask, x - x.detach(), torch.zeros_like(x))


class Taps:
    """A context in which ``fq_layers`` and the models' forwards run
    through the taps (module doc).

    ``record``: keep each quantizer's, pool's and (leaky) ReLU's input
    (``calls``, ``pools``, ``relus``), to serve as another run's ``ref``.
    ``ref``: a run's recorded inputs (a :class:`Taps`, or
    :func:`recorded`), call by call; a kind it holds None for is not
    compared. Positions whose code or class differ are counted and, with
    ``pin``, pinned; the code flips that are rounding ties are counted
    again in ``round_ties``. With ``relu_ulps``, a ReLU flip is pinned only
    where both inputs lie within that many float32 ulps of the reference
    input's largest magnitude in the call (an input 0 in exact arithmetic,
    signed by rounding); the others are counted in ``relu_far`` and left
    as they are. ``paths``: {id(leaf): name} of the leaves whose M is
    summed into ``mag`` as the backward runs, and, with a ``ref``, the
    log-scales' forward difference D into ``fwd``; a contiguous view into a
    named leaf (one layer's slice of a stacked leaf) sums under
    ``"name[i:j]"``, its elements in the leaf.
    """

    def __init__(self, ref=None, *, pin: bool = True, record: bool = False,
                 relu_ulps: Optional[float] = None,
                 paths: Optional[Dict[int, str]] = None):
        self.ref, self.pin, self.record = ref, pin, record
        self.relu_ulps = relu_ulps
        self.paths = paths or {}
        self.calls, self.pools, self.relus = [], [], []
        self.count = {"calls": 0, "pools": 0, "relus": 0}
        self.mag: Dict[str, float] = {}
        self.fwd: Dict[str, float] = {}
        self.code_flips = self.tie_flips = self.positions = 0
        self.round_ties = 0  # of the code flips
        self.pool_flips = self.windows = 0
        self.relu_flips = self.relu_positions = self.relu_far = 0

    # -- bookkeeping -------------------------------------------------------

    def _reference(self, kind, x):
        """The reference's input of this call of ``kind``, on x's device,
        or None where the reference has none of that kind."""
        i = self.count[kind]
        self.count[kind] += 1
        refs = None if self.ref is None else getattr(self.ref, kind)
        if refs is None:
            return None
        if i >= len(refs):
            raise AssertionError(f"{kind}: call {i}, the reference made "
                                 f"{len(refs)}")
        ref = refs[i].to(x.device)
        if ref.shape != x.shape:
            raise AssertionError(f"{kind} {i}: {tuple(x.shape)}, the "
                                 f"reference's {tuple(ref.shape)}")
        return ref

    def _keep(self, kind, x):
        if self.record:
            getattr(self, kind).append(x.detach().clone())

    def _name(self, leaf):
        """The leaf's name in ``paths``; for a contiguous view into a named
        leaf (a layer's slice of a stacked leaf) the leaf's name and the
        view's elements, ``"name[i:j]"``; None for any other tensor."""
        name = self.paths.get(id(leaf))
        base = leaf._base
        if name is None and base is not None and id(base) in self.paths \
                and leaf.is_contiguous():
            off = leaf.storage_offset() - base.storage_offset()
            name = f"{self.paths[id(base)]}[{off}:{off + leaf.numel()}]"
        return name

    def _add(self, leaf, value, into=None):
        into = self.mag if into is None else into
        name = self._name(leaf)
        into[name] = into.get(name, 0.0) + value

    def matched(self):
        """Raises unless this run made as many calls of each kind as the
        reference."""
        for kind, n in self.count.items():
            refs = getattr(self.ref, kind)
            if refs is not None and len(refs) != n:
                raise AssertionError(f"{kind}: {n} calls, the reference "
                                     f"made {len(refs)}")

    # -- the tapped functions ---------------------------------------------

    def quantize(self, x, s, *, bits, b, stabilize=True):
        lq = self._orig["learned_quantize"]
        if bits is None or bits >= 32:
            return lq(x, s, bits=bits, b=b, stabilize=stabilize)
        n = quant.n_levels(bits)
        g = 1.0 / math.sqrt(max(x.numel(), 1) * n) if stabilize else 1.0
        ref = self._reference("calls", x)
        if ref is not None:
            sd = s.detach()
            e = quant.exp(quant._grad_scale(sd, g) if stabilize else sd)
            (code, cls, u), (code_r, cls_r, u_r) = (
                category(v, e.to(x.dtype), b, n) for v in (x.detach(), ref))
            cf = code != code_r
            tf = (cls != cls_r) & ~cf
            self.code_flips += int(cf.sum())
            self.round_ties += int(rounding_ties(code, u, code_r, u_r).sum())
            self.tie_flips += int(tf.sum())
            self.positions += x.numel()
            if self.pin:
                x = _pin(x, cf | tf, ref)
        self._keep("calls", x)
        q = lq(x, s, bits=bits, b=b, stabilize=stabilize)
        if q.requires_grad and self._name(s) is not None:
            size = (q.detach().abs() + x.detach().abs()).double()
            q.register_hook(lambda gq, s=s, size=size, g=g: self._add(
                s, g * float((gq.double().abs() * size).sum())))
            if ref is not None:
                dx = (x.detach() - ref).abs().double()
                q.register_hook(lambda gq, s=s, dx=dx, g=g: self._add(
                    s, g * float((gq.double().abs() * dx).sum()), self.fwd))
        return q

    def noise(self, x, key, sigma, s, bits):
        y = self._orig["add_lsb_noise"](x, key, sigma, s, bits)
        if y is not x and y.requires_grad and self._name(s) is not None:
            d = (y - x).detach().abs().double()
            y.register_hook(lambda gy, s=s, d=d: self._add(
                s, float((gy.double().abs() * d).sum())))
        return y

    def batchnorm(self, p, st, x, **kw):
        """M of gamma and beta: the L2 norm over channels of sum |dL/dy|
        (beta) and of sum |dL/dy * x_hat| (gamma)."""
        y, new = self._orig["batchnorm"](p, st, x, **kw)
        if y.requires_grad and self._name(p["beta"]) is not None:
            xhat = (y.detach() - p["beta"].detach()) / p["gamma"].detach()
            dims = tuple(range(y.dim() - 1))

            def hook(gy, p=p, xhat=xhat):
                a = gy.double().abs()
                self._add(p["beta"], float(a.sum(dims).norm()))
                self._add(p["gamma"], float((a * xhat.abs()).sum(dims)
                                            .norm()))
            y.register_hook(hook)
        return y, new

    def pool(self, h, **kw):
        if not h.is_floating_point() or kw:
            return self._orig["maxpool2d"](h, **kw)
        ref = self._reference("pools", h)
        if ref is not None:
            idx = [torch.nn.functional.max_pool2d(
                v.movedim(-1, 1), 2, 2, return_indices=True)[1]
                for v in (h.detach(), ref)]
            moved = idx[0] != idx[1]
            self.pool_flips += int(moved.sum())
            self.windows += moved.numel()
            if self.pin and bool(moved.any()):
                mask = moved.repeat_interleave(2, 2).repeat_interleave(2, 3)
                mask = torch.nn.functional.pad(mask, (
                    0, h.shape[2] - mask.shape[3],
                    0, h.shape[1] - mask.shape[2])).movedim(1, -1)
                h = _pin(h, mask, ref)
        self._keep("pools", h)
        return self._orig["maxpool2d"](h)

    def _signs(self, h):
        ref = self._reference("relus", h)
        if ref is not None:
            mask = torch.sign(h.detach()) != torch.sign(ref)
            self.relu_flips += int(mask.sum())
            self.relu_positions += h.numel()
            if self.relu_ulps is not None and bool(mask.any()):
                tol = (self.relu_ulps * torch.finfo(ref.dtype).eps
                       * ref.abs().max())
                near = torch.maximum(h.detach().abs(), ref.abs()) <= tol
                self.relu_far += int((mask & ~near).sum())
                mask = mask & near
            if self.pin:
                h = _pin(h, mask, ref)
        self._keep("relus", h)
        return h

    def _signed(self, fn):
        """A model's (leaky) ReLU ``fn`` through :meth:`_signs`."""
        return lambda h: fn(self._signs(h))

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in _TAPPED]
        self._orig = {name: fn for _, name, fn in self._saved
                      if name not in _SIGNED}
        taps = {"learned_quantize": self.quantize,
                "add_lsb_noise": self.noise, "batchnorm": self.batchnorm,
                "maxpool2d": self.pool}
        for mod, name, fn in self._saved:
            setattr(mod, name, self._signed(fn) if name in _SIGNED
                    else taps[name])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class recorded:
    """Another run's recorded inputs as a ``Taps(ref=)``: tensors or
    arrays, call by call; None for a kind not recorded."""

    def __init__(self, calls=None, pools=None, relus=None):
        self.calls, self.pools, self.relus = (
            None if v is None else [torch.as_tensor(a) for a in v]
            for v in (calls, pools, relus))


def value_and_grad(fn: Callable, params, taps: Taps):
    """``(value, aux), {path: grad}`` of ``fn(params) -> (value, aux)``
    run through ``taps``, over fresh leaves as ``tree.value_and_grad``
    takes them (zeros where the value does not depend on a leaf); the taps
    sum M for every leaf."""
    named = tree.named_leaves(params)
    live = [t.detach().requires_grad_(True) for _, t in named]
    taps.paths = {id(t): k for (k, _), t in zip(named, live)}
    with taps, torch.enable_grad():
        value, aux = fn(tree.unflatten(params, live))
        grads = torch.autograd.grad(value, live, allow_unused=True)
    return (value.detach(), aux), {
        k: torch.zeros_like(t) if g is None else g
        for (k, _), t, g in zip(named, live, grads)}


def head_value_and_grad(fn: Callable, params, taps: Taps, head=None):
    """As :func:`value_and_grad` for ``fn(params) -> (value, (logits,
    ...))``, with the gradient of the value by the logits (the head's)
    returned third. With ``head`` (another run's head gradient) the
    backward below the logits starts from ``head`` instead of this run's
    own, so that the network below the head is compared alone; the head
    gradient returned is still this run's own."""
    named = tree.named_leaves(params)
    live = [t.detach().requires_grad_(True) for _, t in named]
    taps.paths = {id(t): k for (k, _), t in zip(named, live)}
    with taps, torch.enable_grad():
        value, aux = fn(tree.unflatten(params, live))
        logits = aux[0]
        if head is None:
            *grads, g_head = torch.autograd.grad(value, live + [logits],
                                                 allow_unused=True)
        else:
            g_head, = torch.autograd.grad(value, logits, retain_graph=True)
            grads = torch.autograd.grad(logits, live,
                                        grad_outputs=head.to(logits.device),
                                        allow_unused=True)
    return (value.detach(), aux), {
        k: torch.zeros_like(t) if g is None else g
        for (k, _), t, g in zip(named, live, grads)}, g_head.detach()
