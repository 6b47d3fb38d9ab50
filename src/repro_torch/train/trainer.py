"""Train steps: the LM step with gradient accumulation and clipping, and
the deployment-in-the-loop (QAT) step with its resumable finetune.

Counterpart of ``repro.train.trainer``. The LM step (``TrainConfig``,
``make_grad_fn``, ``make_train_step``) takes ``tree.value_and_grad`` of
``models.transformer.loss_fn`` a microbatch at a time, sums the gradients
in float32, clips them to a global norm and lets the optimizer update. The
reference's sharded jit of it (``train_shardings``, ``jit_train_step``) and
its cross-pod gradient compression come with the mesh slice; without a
mesh the reference skips the compression too.

A QAT step is ``tree.value_and_grad`` of a loss whose forward runs through
a ``qat_apply`` (``models.kws``, ``models.darknet``): the loss is evaluated
on the deployed integer path (codes, the kernels' ADC noise,
``mac_chunks``) while the gradients come from the float FQ/STE surrogate;
then the gradients are clipped to a global norm and the optimizer updates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import tree
from ..core import deploy_qat, prng, quant
from ..core.quant import QuantConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer as T
from ..optim.sgd import Optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    clip_norm: Optional[float] = 1.0
    lb_coef: float = 0.01
    z_coef: float = 1e-3
    pod_compress: bool = False     # a mesh's pod axis; none without one


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum, over the leaves in ``tree.leaves`` order (jax's),
    of each leaf's sum of squares in float32."""
    total = None
    for g in tree.leaves(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return quant.sqrt(total)


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


def _split_micro(batch, accum: int):
    """(B, ...) -> (accum, B / accum, ...) for every leaf."""
    def r(x):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        return x.reshape(accum, b // accum, *x.shape[1:])
    return tree.map(r, batch)


def make_grad_fn(model_cfg, qcfg: QuantConfig, tc: TrainConfig):
    """``(params, batch) -> (grads, metrics)`` with microbatch
    accumulation: over ``tc.grad_accum`` microbatches the gradients are
    summed in float32 and scaled by 1 / accum, the metrics then the
    reference's (the mean loss as loss and ce, zero aux)."""
    def loss(p, b):
        return T.loss_fn(p, b, model_cfg, qcfg, lb_coef=tc.lb_coef,
                         z_coef=tc.z_coef)

    vg = tree.value_and_grad(loss, has_aux=True)

    def grad_fn(params, batch):
        if tc.grad_accum <= 1:
            (l, metrics), grads = vg(params, batch)
            return grads, {"loss": l, **tree.map(torch.Tensor.detach,
                                                 metrics)}
        micro = _split_micro(batch, tc.grad_accum)
        dev = tree.leaves(params)[0].device
        g = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        l_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(tc.grad_accum):
            (l, _), gi = vg(params, tree.map(lambda x: x[i], micro))
            tree.map(lambda a, x: a.add_(x.to(torch.float32)), g, gi)
            l_acc = l_acc + l
            del gi
        inv = 1.0 / tc.grad_accum
        grads = tree.map(lambda x: x.mul_(inv), g)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return grads, {"loss": l_acc * inv, "ce": l_acc * inv,
                       "load_balance": zero, "router_z": zero}

    return grad_fn


def make_train_step(model_cfg, qcfg: QuantConfig, opt: Optimizer,
                    tc: TrainConfig = TrainConfig(), mesh=None, *,
                    device: DeviceLike = None):
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)`` on ``device`` (CUDA unless the CPU is asked for), where the
    params and state must lie; the batch is moved there. Adam's update
    writes the new params and state into those it was given (the
    reference's jitted step donates its buffers); SGD's returns new ones.
    ``mesh`` must be None: meshes come with the mesh slice."""
    if mesh is not None:
        raise NotImplementedError("make_train_step: meshes (and pod_compress "
                                  "over a pod axis) come with the mesh slice")
    dev = resolve_device(device)
    grad_fn = make_grad_fn(model_cfg, qcfg, tc)

    def step(params, opt_state, batch, step_idx):
        where = tree.leaves(params)[0].device
        if where != dev:
            raise ValueError(f"train step on {dev}: params on {where}")
        batch = tree.map(lambda x: x.to(dev), batch)
        grads, metrics = grad_fn(params, batch)
        if tc.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
            metrics = {**metrics, "grad_norm": gnorm}
        params, opt_state = opt.update(params, grads, opt_state, step_idx)
        return params, opt_state, metrics

    return step


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
