"""Nested dicts (and tuples / lists) of tensors, the port's parameter trees.

The reference maps its parameter pytrees with ``jax.tree`` and takes
gradients with ``jax.value_and_grad``; these are the few pieces of that the
port needs. Dict keys are visited in sorted order, as ``jax.tree`` does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch


def _children(t):
    if isinstance(t, dict):
        return [t[k] for k in sorted(t)]
    if isinstance(t, (tuple, list)):
        return list(t)
    return None


def _rebuild(t, kids):
    if isinstance(t, dict):
        return dict(zip(sorted(t), kids))
    return type(t)(kids)


def map(fn: Callable, t, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` applied leaf by leaf over trees of one structure."""
    kids = None if is_leaf is not None and is_leaf(t) else _children(t)
    if kids is None:
        return fn(t, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(t, [map(fn, k, *(o[i] for o in others), is_leaf=is_leaf)
                        for i, k in enumerate(kids)])


def leaves(t, is_leaf: Optional[Callable] = None) -> List[Any]:
    kids = None if is_leaf is not None and is_leaf(t) else _children(t)
    if kids is None:
        return [t]
    return [leaf for k in kids for leaf in leaves(k, is_leaf)]


def named_leaves(t, prefix: str = "", sep: str = ".") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in ``leaves`` order, a path the dict keys and list
    indices from the root joined by ``sep`` (``"conv3.s_w"``)."""
    kids = _children(t)
    if kids is None:
        return [(prefix[:-len(sep)], t)]
    names = sorted(t) if isinstance(t, dict) else range(len(kids))
    return [nl for k, kid in zip(names, kids)
            for nl in named_leaves(kid, f"{prefix}{k}{sep}", sep)]


def unflatten(t, values) -> Any:
    """A tree of ``t``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    return map(lambda _: next(it), t)


def value_and_grad(fn: Callable, *, has_aux: bool = False):
    """``jax.value_and_grad`` over the first argument, a tree of float
    tensors: ``g(params, *args) -> (value, grads)`` (``((value, aux),
    grads)`` with ``has_aux``). The gradients come from
    ``torch.autograd.grad`` over fresh leaves holding the params' values; a
    leaf the value does not depend on gets zeros, as in JAX."""
    def wrapped(params, *args, **kwargs) -> Tuple[Any, Any]:
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            out = fn(unflatten(params, live), *args, **kwargs)
            value, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, live)]
        value = value.detach()
        return ((value, aux) if has_aux else value), unflatten(params, grads)
    return wrapped
