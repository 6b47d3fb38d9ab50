"""SGD with Nesterov momentum and weight decay (paper §4.1 / 4.3: "SGD with
Nesterov Momentum (0.9), weight decay 5E-4"): counterpart of
``repro.optim.sgd``.

    opt = make(...)
    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, step)

Parameters, gradients and the momentum are nested dicts of tensors mapped
leaf by leaf (``repro_torch.tree``). ``update`` is pure, as the
reference's: the QAT step's callers (the fleet's retrain job, the
``train_fq`` stages of ``chip_smoke.py``) may go on reading the params they
passed in. Adam's update, which the LM step runs at full width, writes in
place instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def make(lr_fn, *, momentum: float = 0.9, nesterov: bool = True,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree.map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(params, grads, state, step):
        lr = lr_fn(step)

        def upd(p, g, mu):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            mu_new = momentum * mu + g
            step_dir = g + momentum * mu_new if nesterov else mu_new
            return (p.to(torch.float32) - lr * step_dir) \
                .to(p.dtype), mu_new

        out = [upd(p, g, mu) for p, g, mu in zip(
            tree.leaves(params), tree.leaves(grads),
            tree.leaves(state["mu"]))]
        return (tree.unflatten(params, [r[0] for r in out]),
                {"mu": tree.unflatten(params, [r[1] for r in out])})

    return Optimizer(init, update)
