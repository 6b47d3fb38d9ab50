"""Fleet control plane: canary -> background retrain -> hot-swap as one loop.

Counterpart of ``repro.serve.fleet``, with the reference's states, events,
event fields and decisions, so one seeded schedule gives the reference's
trace. ``FleetRuntime`` hosts a registry of named ``ConvertedStack``s, each
behind its own ``CNNBatcher`` with a per-model SLO; it watches each model's
noise canary for a drop against a rolling clean-agreement baseline, and on
a breach runs a *background* deploy-QAT finetune (:class:`QATFinetuneJob`,
a bounded number of steps per scheduler tick, so serving never stops),
followed by ``ConvertedStack.rederive`` and ``CNNBatcher.swap_apply_fn``.

Per-model control-plane states::

    HEALTHY --(canary median < baseline - max_agreement_drop)--> RETRAINING
    RETRAINING --(finetune budget spent: rederive + swap)-------> HEALTHY
    HEALTHY/RETRAINING --(flush retries exhausted, post-swap)---> DEGRADED
    HEALTHY --(breach, no finetune_factory registered)----------> BREACHED

``DEGRADED`` re-serves the last-good stack (the one before the most recent
swap); ``BREACHED`` keeps serving while flagging the drift.

Fault tolerance (:mod:`.faults`): one seeded ``FaultyDevice`` is shared by
every batcher and canary, so flush failures retry with bounded backoff,
stuck in-flight results surface as bounded ``inflight_age``, and corrupted
canary observations are ridden out by the median filter over the rolling
window. Deadline-expired requests are shed with a structured error before
they can stall a window: every submitted request completes exactly once,
served within the SLO deadline or shed with ``CNNRequest.error``.

Every decision appends to a :class:`~.trace.Trace`; :func:`.trace.replay`
reproduces the incident from the recorded seeds and step keys.

On the card: each model's clean flushes replay CUDA graphs (the batcher's);
the canary runs eagerly on the current stream, its key
``prng.fold_in(prng.PRNGKey(canary_seed), trial)`` bit-exact with the
reference's ``jax.random.fold_in(jax.random.key(seed), trial)``, and its
argmax agreement is computed on the host. With ``n_replicas`` > 1 every
lane serves its own device copy of the stack (``replicate_stack``). Where
the reference catches every exception to let a unit test's toy model share
one closure or digest as None, the port takes that branch only for an
object that is not a ``ConvertedStack``: a real stack that fails to place
or to digest raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import planlint
from ..analysis.report import Report, Severity
from ..core import prng
from ..core.integer_inference import (ConvertedStack, replicate_stack,
                                      stack_digest)
from ..core.noise import NoiseConfig
from .cnn_batching import CNNBatcher, CNNRequest
from .faults import FaultPlan, FaultyDevice
from .trace import Trace, digest

HEALTHY = "HEALTHY"
RETRAINING = "RETRAINING"
BREACHED = "BREACHED"
DEGRADED = "DEGRADED"


class FleetConfigError(ValueError):
    """Registry invariant violated (planlint.lint_fleet findings)."""


@dataclasses.dataclass(frozen=True)
class ModelSLO:
    """Per-model serving objectives.

    ``deadline_ticks`` bounds submit -> completion end to end; the runtime
    sheds queued requests early enough that even a maximally stuck
    in-flight result still resolves within the deadline (planlint enforces
    ``deadline_ticks > 1 + max_stuck_ticks``). ``max_agreement_drop`` is
    the breach threshold below the rolling baseline; the canary fires
    every ``canary_every`` ticks (0 = off), keeps a ``canary_window``-deep
    median-filtered window, and establishes a fresh baseline from the first
    ``baseline_obs`` observations of each generation. A breach retrains
    ``retrain_steps_per_tick`` deploy-QAT steps per tick in the background.
    """

    deadline_ticks: int = 8
    max_agreement_drop: float = 0.2
    canary_every: int = 1
    canary_window: int = 5
    baseline_obs: int = 3
    retrain_steps_per_tick: int = 10

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """A replayable request descriptor: the payload is a pure function of
    ``(seed, rid, shape, dtype)``, so a trace that records specs (not
    tensors) can regenerate the exact traffic at replay."""

    rid: int
    seed: int
    shape: Tuple[int, ...]
    dtype: str = "float32"

    def payload(self) -> np.ndarray:
        rng = np.random.default_rng((int(self.seed), int(self.rid)))
        return rng.standard_normal(self.shape).astype(np.dtype(self.dtype))


@dataclasses.dataclass
class _Model:
    """Internal per-model control-plane state."""

    name: str
    stack: object
    serve_builder: Callable
    slo: ModelSLO
    probe: np.ndarray
    canary_seed: int
    finetune_factory: Optional[Callable]
    batcher: CNNBatcher
    condition: Optional[NoiseConfig] = None
    state: str = HEALTHY
    baseline: Optional[float] = None
    obs: List[float] = dataclasses.field(default_factory=list)
    window: deque = dataclasses.field(default_factory=deque)
    trial: int = 0                 # monotone: canary keys never reuse
    job: object = None
    last_good: Optional[tuple] = None   # (stack, batcher generation)
    reqs: List[CNNRequest] = dataclasses.field(default_factory=list)
    rids: set = dataclasses.field(default_factory=set)
    clean_ref: Optional[np.ndarray] = None
    clean_fn: Optional[Callable] = None
    noisy_fn: Optional[Callable] = None
    exhausted: bool = False
    n_replicas: int = 1
    devices: Optional[list] = None      # replica placement (None: shared)


def _host(y) -> np.ndarray:
    """A step's output (a tensor on any device, or an array) as numpy."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


class FleetRuntime:
    """A registry of named integer stacks behind one fault-aware
    scheduler, self-healing via canary -> retrain -> hot-swap."""

    def __init__(self, *, fault_plan: Optional[FaultPlan] = None,
                 trace: Optional[Trace] = None, lint: bool = True):
        self.trace = trace if trace is not None else Trace()
        self.fault_plan = fault_plan
        self._device = FaultyDevice(fault_plan) \
            if fault_plan is not None and fault_plan.active else None
        self._max_stuck = fault_plan.max_stuck_ticks \
            if self._device is not None else 0
        self._models: Dict[str, _Model] = {}
        self._tick = 0
        self._lint = lint

    # -- registry -----------------------------------------------------------

    def register(self, name: str, stack, serve_builder: Callable, *,
                 slo: ModelSLO = ModelSLO(), probe: np.ndarray,
                 canary_seed: int, finetune_factory: Optional[Callable]
                 = None, condition: Optional[NoiseConfig] = None,
                 batcher_kw: Optional[dict] = None, n_replicas: int = 1):
        """Add a named model to the fleet.

        ``serve_builder(stack) -> apply_fn(x, noise=None, rng=None)`` (the
        models' ``int_serve_fn``); it is re-invoked at every swap.
        ``probe`` is the fixed canary batch; ``finetune_factory(stack,
        condition) -> job`` returns a background retrain job exposing
        ``step(n) -> metrics``, ``done`` and ``result() -> (layer_params,
        extras)`` (see :class:`QATFinetuneJob`). The would-be registry must
        pass ``planlint.lint_fleet`` (names unique, SLOs satisfiable
        against the fault plan, canary seeds distinct, stacks clean):
        violations raise :class:`FleetConfigError`.

        ``n_replicas`` > 1 serves the model on that many replica lanes:
        placement round-robins over ``launch.mesh.replica_devices`` (the
        CUDA devices; the CPU for a stack or closure on the CPU) and each
        lane gets its own closure over a ``replicate_stack`` copy (an
        object that is not a ``ConvertedStack``, a unit test's toy, shares
        one closure). Canary, retrain and hot-swap stay fleet-level
        decisions; swaps install lane by lane between flushes and surface
        as ``swap-replica`` trace events under the fleet's own ``swap``.
        """
        entries = [(m.name, m.slo, m.canary_seed, m.stack)
                   for m in self._models.values()]
        entries.append((name, slo, canary_seed, stack))
        if self._lint:
            report = Report()
            planlint.lint_fleet(entries, report,
                                max_stuck_ticks=self._max_stuck)
            errs = [f for f in report.findings
                    if f.severity >= Severity.ERROR]
            if errs:
                raise FleetConfigError("; ".join(
                    f"{f.check}[{f.subject}]: {f.message}" for f in errs))
        kw = dict(batcher_kw or {})
        n_replicas = int(kw.pop("n_replicas", n_replicas))
        m = _Model(name=name, stack=stack, serve_builder=serve_builder,
                   slo=slo, probe=np.asarray(probe),
                   canary_seed=int(canary_seed),
                   finetune_factory=finetune_factory,
                   batcher=None, condition=condition,
                   n_replicas=n_replicas)
        m.window = deque(maxlen=slo.canary_window)
        apply_fn = serve_builder(stack)
        if n_replicas > 1 and "replica_devices" not in kw:
            from ..launch import mesh as mesh_mod
            m.devices = mesh_mod.replica_devices(
                n_replicas, device=self._placement(stack, apply_fn))
            kw["replica_devices"] = m.devices
        m.batcher = CNNBatcher(
            apply_fn, device=self._device,
            on_event=lambda etype, kw, _m=m: self._bridge(_m, etype, kw),
            n_replicas=n_replicas,
            replica_apply_fns=self._replica_fns(m), **kw)
        self._rebuild_canary(m)
        self._models[name] = m
        self.trace.emit(
            "register", tick=self._tick, model=name, slo=slo.to_dict(),
            canary_seed=m.canary_seed, stack=self._digest(stack),
            probe=digest(m.probe), condition=self._nc_list(condition),
            has_finetune=finetune_factory is not None,
            n_replicas=n_replicas)
        return m

    @staticmethod
    def _placement(stack, apply_fn):
        """``replica_devices``' device: "cpu" for a stack (or, for a toy,
        a closure) that lives on the CPU, else None (the CUDA devices)."""
        dev = stack.device if isinstance(stack, ConvertedStack) \
            else getattr(apply_fn, "device", None)
        return "cpu" if dev is not None \
            and torch.device(dev).type == "cpu" else None

    def _replica_fns(self, m: _Model):
        """Per-lane apply closures over placed stack copies, or None to
        share one step across lanes (one lane; lanes the caller placed
        itself; an object that is not a ConvertedStack)."""
        if m.n_replicas <= 1 or m.devices is None \
                or not isinstance(m.stack, ConvertedStack):
            return None
        return [m.serve_builder(s)
                for s in replicate_stack(m.stack, m.devices)]

    @staticmethod
    def _nc_list(nc: Optional[NoiseConfig]):
        return None if nc is None else [nc.sigma_w, nc.sigma_a, nc.sigma_mac]

    @staticmethod
    def _digest(stack):
        """Digest for the trace; an object that is not a ConvertedStack (a
        unit test's toy) digests as None."""
        if not isinstance(stack, ConvertedStack):
            return None
        return stack_digest(stack)

    def _rebuild_canary(self, m: _Model):
        """Rebuild the canary closures and pin the clean reference for the
        CURRENT stack + field condition. Eager, like the reference's."""
        apply_fn = m.serve_builder(m.stack)
        m.clean_fn = lambda x: apply_fn(x)
        nc = m.condition
        if nc is not None and nc.enabled:
            m.noisy_fn = lambda x, key: apply_fn(x, noise=nc, rng=key)
        else:
            m.noisy_fn = None
        with torch.no_grad():
            m.clean_ref = _host(m.clean_fn(m.probe)).argmax(-1)
        m.baseline = None
        m.obs = []
        m.window.clear()

    # -- schedule API (the replayable inputs) -------------------------------

    def submit(self, name: str, specs: List[RequestSpec]):
        m = self._model(name)
        for s in specs:
            if s.rid in m.rids:
                raise ValueError(f"duplicate rid {s.rid} for model {name}")
            m.rids.add(s.rid)
        self.trace.emit("submit", tick=self._tick, model=name, specs=specs)
        reqs = [CNNRequest(rid=s.rid, x=s.payload()) for s in specs]
        m.reqs.extend(reqs)
        m.batcher.submit(reqs)

    def set_condition(self, name: str, nc):
        """Field-drift injection: the noise the model's canary now sees at
        deployment (a Table-7 condition, or None for clean)."""
        if nc is not None and not isinstance(nc, NoiseConfig):
            nc = NoiseConfig(*nc)
        m = self._model(name)
        self.trace.emit("set-condition", tick=self._tick, model=name,
                        nc=self._nc_list(nc))
        m.condition = nc
        apply_fn = m.serve_builder(m.stack)
        m.noisy_fn = (lambda x, key: apply_fn(x, noise=nc, rng=key)) \
            if nc is not None and nc.enabled else None

    def tick(self) -> int:
        """One fleet scheduling quantum: shed-expired -> serve -> fault
        handling -> background retrain -> canary, per model."""
        self.trace.emit("tick", tick=self._tick)
        served = 0
        for m in self._models.values():
            shed_age = m.slo.deadline_ticks - 1 - self._max_stuck
            m.batcher.shed_expired(shed_age)
            served += m.batcher.tick()
            if m.exhausted:
                m.exhausted = False
                self._degrade(m, reason="flush-retries-exhausted")
            if m.state == RETRAINING and m.job is not None:
                metrics = m.job.step(m.slo.retrain_steps_per_tick)
                self.trace.emit("retrain", tick=self._tick, model=m.name,
                                **metrics)
                if m.job.done:
                    self._install(m)
            if m.slo.canary_every > 0 \
                    and self._tick % m.slo.canary_every == 0:
                self._canary(m)
        self._tick += 1
        return served

    def drain(self) -> int:
        """Shutdown / end of load: shed what already missed its deadline,
        then flush + resolve everything else immediately."""
        self.trace.emit("drain", tick=self._tick)
        served = 0
        for m in self._models.values():
            m.batcher.shed_expired(m.slo.deadline_ticks - 1 -
                                   self._max_stuck)
            served += m.batcher.drain()
        return served

    # -- canary + breach ----------------------------------------------------

    def _canary(self, m: _Model):
        key = prng.fold_in(prng.PRNGKey(m.canary_seed), m.trial)
        trial = m.trial
        m.trial += 1
        with torch.no_grad():
            if m.noisy_fn is not None:
                y = m.noisy_fn(m.probe, key)
            else:
                y = m.clean_fn(m.probe)
            agree = float((_host(y).argmax(-1) == m.clean_ref).mean())
        corrupted = False
        if self._device is not None:
            corrupt, junk = self._device.canary_fate()
            if corrupt:
                corrupted, agree = True, float(junk)
        self.trace.emit("canary", tick=self._tick, model=m.name,
                        trial=trial, agreement=agree, corrupted=corrupted,
                        generation=m.batcher.generation)
        if m.baseline is None:
            m.obs.append(agree)
            if len(m.obs) >= m.slo.baseline_obs:
                # median, not mean: a corrupted observation must not
                # poison the baseline the whole generation breaches against
                m.baseline = float(np.median(m.obs))
                self.trace.emit("baseline", tick=self._tick, model=m.name,
                                baseline=m.baseline,
                                generation=m.batcher.generation)
            return
        m.window.append(agree)
        if m.state != HEALTHY or len(m.window) < m.window.maxlen:
            return
        med = float(np.median(m.window))
        if med < m.baseline - m.slo.max_agreement_drop:
            self._breach(m, med)

    def _breach(self, m: _Model, median: float):
        self.trace.emit("breach", tick=self._tick, model=m.name,
                        median=median, baseline=m.baseline,
                        drop=m.baseline - median,
                        generation=m.batcher.generation)
        if m.finetune_factory is None:
            m.state = BREACHED
            return
        m.job = m.finetune_factory(m.stack, m.condition)
        m.state = RETRAINING
        self.trace.emit("retrain-start", tick=self._tick, model=m.name,
                        steps=getattr(m.job, "steps", None))

    # -- swap / degrade -----------------------------------------------------

    def _install(self, m: _Model):
        """Finished retrain: rederive the stack and hot-swap it in. A failed
        rederive degrades instead of taking the model down (control-plane
        semantics: the error text goes into the trace)."""
        try:
            layer_params, extras = m.job.result()
            new_stack = m.stack.rederive(layer_params, extras=extras)
        except Exception as err:  # noqa: BLE001 — degrade, don't crash
            m.job = None
            m.state = DEGRADED
            self.trace.emit("degrade", tick=self._tick, model=m.name,
                            reason="rederive-failed", detail=str(err)[:200])
            return
        m.job = None
        m.last_good = (m.stack, m.batcher.generation)
        m.stack = new_stack
        m.batcher.swap_apply_fn(m.serve_builder(new_stack),
                                replica_apply_fns=self._replica_fns(m))
        self._rebuild_canary(m)
        m.state = HEALTHY
        self.trace.emit("swap", tick=self._tick, model=m.name,
                        generation=m.batcher.generation,
                        stack=self._digest(new_stack))

    def _degrade(self, m: _Model, *, reason: str):
        """Flush-fault exhaustion: fall back to the last-good stack (the one
        serving before the most recent swap), if there is one."""
        if m.last_good is None:
            self.trace.emit("degrade", tick=self._tick, model=m.name,
                            reason=reason, to_generation=None)
            return
        stack, gen = m.last_good
        m.last_good = None
        m.job = None
        m.stack = stack
        m.batcher.swap_apply_fn(m.serve_builder(stack),
                                replica_apply_fns=self._replica_fns(m))
        self._rebuild_canary(m)
        m.state = DEGRADED
        self.trace.emit("degrade", tick=self._tick, model=m.name,
                        reason=reason, to_generation=gen,
                        generation=m.batcher.generation,
                        stack=self._digest(stack))

    # -- batcher event bridge ----------------------------------------------

    def _bridge(self, m: _Model, etype: str, kw: dict):
        """Translate batcher events into model-tagged trace events."""
        if etype == "swap":
            # the fleet emits its own swap/degrade DECISION event; the
            # per-lane installs surface as replica-tagged rollout events
            if "replica" in kw:
                self.trace.emit("swap-replica", model=m.name, **kw)
            return
        evt = {"model": m.name}
        if "key" in kw:
            shape, dtype = kw.pop("key")
            evt["shape"] = list(shape)
            evt["dtype"] = dtype
        if etype == "resolve":
            reqs = kw.pop("reqs")
            evt["rids"] = [r.rid for r in reqs]
            evt["outs"] = [digest(r.out) for r in reqs]
        evt.update(kw)
        self.trace.emit(etype, **evt)
        if etype == "shed" and kw.get("code") == "flush-fault":
            m.exhausted = True

    # -- accounting ---------------------------------------------------------

    def _model(self, name: str) -> _Model:
        try:
            return self._models[name]
        except KeyError:
            raise FleetConfigError(f"unknown model {name!r}") from None

    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(self._models)

    def requests(self, name: str) -> List[CNNRequest]:
        return list(self._model(name).reqs)

    def audit(self, name: str) -> dict:
        """Exactly-once + SLO accounting over every submitted request:
        served (out, no error), shed (structured error, no out), lost
        (neither: must be 0 after drain), and whether every served request
        completed within ``deadline_ticks``."""
        m = self._model(name)
        served = [r for r in m.reqs if r.done and r.error is None]
        shed = [r for r in m.reqs if r.done and r.error is not None]
        lost = [r for r in m.reqs if not r.done]
        bad = [r for r in served if r.out is None] + \
              [r for r in shed if r.out is not None]
        late = [r for r in served
                if r.finish_tick - r.submit_tick > m.slo.deadline_ticks]
        return {
            "n": len(m.reqs), "served": len(served), "shed": len(shed),
            "lost": len(lost), "inconsistent": len(bad),
            "late": len(late),
            "exactly_once": not lost and not bad,
            "within_slo": not late,
            "shed_codes": sorted({r.error["code"] for r in shed}),
        }

    def stats(self) -> dict:
        out = {}
        for name, m in self._models.items():
            out[name] = {
                **m.batcher.stats, "state": m.state,
                "baseline": m.baseline,
                "condition": self._nc_list(m.condition),
            }
        if self._device is not None:
            out["fault_draws"] = self._device.draws
        return out


class QATFinetuneJob:
    """The concrete background retrain job for the integer stacks.

    Bridges ``train.trainer.QATFinetune`` to the fleet's job protocol:
    builds the deploy-QAT loss against the breached field condition (the
    mean over ``draws`` noise draws, each keyed ``prng.fold_in(rng, d)``,
    as in the Table-7 retrain benchmark), advances ``step(n)`` at a time,
    and on ``result()`` syncs the scale hand-off and returns
    ``(layer_params, extras)`` ready for ``ConvertedStack.rederive``.

    ``module`` is ``models.kws`` or ``models.darknet``; ``params`` are the
    CURRENT float (BN-folded FQ) params the stack was converted from, and
    ``data`` the ``(x, y)`` training set, on the device the job trains on;
    the caller owns keeping the params in sync across swaps
    (``on_result`` receives the synced params).
    """

    def __init__(self, module, params, state, cfg, qcfg, condition, *,
                 data, steps: int, lr: float = 0.01, batch: int = 64,
                 draws: int = 4, seed: int = 7,
                 on_result: Optional[Callable] = None):
        from ..core import distill
        from ..optim import schedules, sgd
        from ..train.trainer import QATFinetune
        self.module, self.state, self.cfg, self.qcfg = \
            module, state, cfg, qcfg
        self._on_result = on_result
        n_draws = draws if condition is not None and condition.enabled else 1

        def loss_fn(p, batch_, rng):
            xb, yb = batch_
            onehot = torch.nn.functional.one_hot(
                yb.long(), cfg.num_classes).to(torch.float32)
            total = None
            for d in range(n_draws):
                logits = module.qat_apply(
                    p, state, xb, qcfg, cfg, noise=condition,
                    rng=prng.fold_in(rng, d))
                loss = torch.mean(
                    distill.softmax_cross_entropy(logits, onehot))
                total = loss if total is None else total + loss
            # tensor by tensor (C7): no reciprocal multiply on the card
            return torch.div(total, torch.full_like(total, n_draws))

        opt = sgd.make(schedules.cosine(lr, steps))
        self._ft = QATFinetune(loss_fn, params, opt, data=data,
                               steps=steps, batch=batch, seed=seed)
        self.steps = steps

    @property
    def done(self) -> bool:
        return self._ft.done

    @property
    def params(self):
        """The finetune's current (unsynced) float params."""
        return self._ft.params

    def step(self, n: int = 1) -> dict:
        return self._ft.step(n)

    def result(self):
        from ..core import integer_inference as ii
        names_fn = getattr(self.module, "conv_names", None) \
            or self.module.int_conv_names
        names = names_fn(self.cfg)
        synced = ii.sync_handoff(self._ft.params, names)
        extras = self.module.int_extras(synced, self.state, self.cfg)
        layer_params = {n: synced[n] for n in names}
        if self._on_result is not None:
            self._on_result(synced)
        return layer_params, extras
