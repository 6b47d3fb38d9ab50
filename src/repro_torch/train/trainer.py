"""The deployment-in-the-loop (QAT) train step and its resumable finetune.

Counterpart of the QAT part of ``repro.train.trainer``: ``global_norm``,
``clip_by_global_norm``, ``make_qat_train_step`` and ``QATFinetune``. The
reference module's LM step (microbatching, sharding, gradient compression)
is not ported here.

A step is ``tree.value_and_grad`` of a loss whose forward runs through a
``qat_apply`` (``models.kws``, ``models.darknet``): the loss is evaluated on
the deployed integer path (codes, the kernels' ADC noise, ``mac_chunks``)
while the gradients come from the float FQ/STE surrogate; then the
gradients are clipped to a global norm and the optimizer updates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tree
from ..core import deploy_qat, prng
from ..optim.sgd import Optimizer


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded on every device: torch's CPU sqrt
    calls MKL's vmsSqrt, whose accuracy has depended on the state of its
    first call in the process (ROADMAP C8), so the CPU takes numpy's."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(np.atleast_1d(t.numpy()))).reshape(
            t.shape)
    return torch.sqrt(t)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum, over the leaves in ``tree.leaves`` order (jax's),
    of each leaf's sum of squares in float32."""
    total = None
    for g in tree.leaves(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return _sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / max(n, 1e-12)), n)``, n the global
    norm; the division tensor by tensor (C7)."""
    n = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=n.device)
    scale = torch.minimum(one, torch.div(
        torch.full_like(n, max_norm), torch.maximum(n, torch.full_like(
            n, 1e-12))))
    clipped = tree.map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                       grads)
    return clipped, n


def make_qat_train_step(qat_loss_fn, opt: Optimizer, *,
                        clip_norm: Optional[float] = None):
    """``step(params, opt_state, batch, step_idx, rng) -> (params,
    opt_state, metrics)``.

    ``qat_loss_fn(params, batch, rng) -> scalar`` must run its forward
    through a ``qat_apply``; ``rng`` should be the per-step key
    (``deploy_qat.train_step_key(base, step_idx)``), so any step's noise
    draw replays at serving bit for bit. ``metrics`` holds the loss and,
    with ``clip_norm``, the global norm before clipping (0-d tensors).
    """
    value_and_grad = tree.value_and_grad(qat_loss_fn)

    def step(params, opt_state, batch, step_idx, rng):
        loss, grads = value_and_grad(params, batch, rng)
        metrics = {"loss": loss}
        if clip_norm is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads,
                                                              clip_norm)
        params, opt_state = opt.update(params, grads, opt_state, step_idx)
        return params, opt_state, metrics

    return step


class QATFinetune:
    """Budgeted, resumable deploy-QAT finetune: the fleet's retrain job and
    the engine under the Table 7 retrain.

    Step ``i`` samples its batch with ``randint(fold_in(base, 2 i), (batch,),
    0, N)`` and draws its deployed-noise key with
    ``deploy_qat.train_step_key(base, 2 i + 1)``, where ``base =
    PRNGKey(1000 + seed)`` (``jax.random.key(1000 + seed)`` holds the same
    words). The schedule is a pure function of ``(seed, i)``, so a finetune
    advanced ``k`` steps at a time is bit-identical with one run to the end.

    ``loss_fn(params, batch, rng) -> scalar`` must run its forward through
    a ``qat_apply``; ``data`` is the whole ``(x, y)`` training set (tensors
    on one device) the schedule samples from.
    """

    def __init__(self, loss_fn, params, opt: Optimizer, *, data, steps: int,
                 batch: int, seed: int = 0,
                 clip_norm: Optional[float] = 1.0):
        self._step_fn = make_qat_train_step(loss_fn, opt,
                                            clip_norm=clip_norm)
        self._opt_state = opt.init(params)
        self.params = params
        self._data = data
        self.steps = int(steps)
        self.batch = int(batch)
        self.steps_done = 0
        self._base = prng.PRNGKey(1000 + seed, device=data[0].device)
        self.last_loss: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.steps_done >= self.steps

    def step(self, n: int = 1) -> dict:
        """Advance up to ``n`` steps (bounded by the remaining budget)."""
        xtr, ytr = self._data
        ntr = xtr.shape[0]
        for _ in range(min(int(n), self.steps - self.steps_done)):
            i = self.steps_done
            idx = prng.randint(prng.fold_in(self._base, 2 * i),
                               (self.batch,), 0, ntr)
            rng = deploy_qat.train_step_key(self._base, 2 * i + 1)
            self.params, self._opt_state, m = self._step_fn(
                self.params, self._opt_state, (xtr[idx], ytr[idx]), i, rng)
            self.steps_done += 1
            self.last_loss = float(m["loss"])
        return {"steps_done": self.steps_done, "loss": self.last_loss}

    def run(self):
        """Run the remaining budget to completion; returns the params."""
        self.step(self.steps - self.steps_done)
        return self.params
