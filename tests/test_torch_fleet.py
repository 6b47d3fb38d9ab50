"""The port's fleet control plane (``repro_torch.serve.fleet``) and
``trace.replay``, against the reference's (``repro.serve.fleet``).

* Counterparts of each test of ``tests/test_fleet.py`` on the port's toy
  (``ToyStack`` / ``ToyJob`` / ``make_fleet``: the gain is visible in every
  output; the drift scrambles outputs with ``prng.normal``, as the
  reference's toy does with ``jax.random.normal``).
* Lockstep on the toy: one seeded schedule with an active ``FaultPlan``, a
  drift, a breach, a retrain and a swap, through both runtimes. Here the
  drift draws uniforms on both sides (``prng.uniform`` is bit-exact with
  ``jax.random.uniform``; normals are not, C4), so the two ``Trace``s are
  equal event for event under ``trace.compare``.
* ``trace.replay`` of a port incident is bit-exact (also through a JSONL
  round-trip) and a drifted model factory is caught at the first
  ``register``.
* ``cuda``-marked: a replay on the card, on two CUDA lanes (it skips
  without a GPU).

The real-stack lockstep (reduced KWS and DarkNet, ``QATFinetuneJob``) is
in ``test_torch_fleet_real.py``.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch import has_cuda
from repro_torch.analysis import planlint
from repro_torch.analysis.report import Report, Severity
from repro_torch.core import prng
from repro_torch.serve import trace as tr
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.fleet import (BREACHED, DEGRADED, HEALTHY,
                                     FleetConfigError, FleetRuntime,
                                     ModelSLO, RequestSpec)

try:
    import jax
    from repro.analysis import planlint as jplanlint
    from repro.analysis.report import Report as JReport
    from repro.serve import faults as jfaults
    from repro.serve import fleet as jfleet
    from repro.serve import trace as jtrace
except ImportError:  # the card's machine has no jax: -m cuda runs alone
    jax = None

pytestmark = pytest.mark.fleet
CPU = torch.device("cpu")


class ToyStack:
    """gain is observable in every output, so a swap is detectable."""

    def __init__(self, gain):
        self.gain = float(gain)

    def rederive(self, layer_params, *, extras=None, check_handoff=True):
        return ToyStack(self.gain + 1.0)


def toy_builder(stack, draw=prng.normal, device=CPU):
    g = stack.gain

    def fn(x, noise=None, rng=None):
        y = torch.as_tensor(x, dtype=torch.float32, device=device) * g
        if noise is not None and rng is not None:
            # drift model: deployment noise scrambles the outputs
            y = y + draw(rng.to(device), tuple(y.shape)) \
                * noise.sigma_mac * 100.0
        return y
    fn.device = torch.device(device)
    return fn


class ToyJob:
    """Deterministic stand-in for QATFinetuneJob."""

    def __init__(self, steps=25):
        self.n, self.steps = 0, steps

    @property
    def done(self):
        return self.n >= self.steps

    def step(self, k):
        self.n = min(self.n + k, self.steps)
        return {"steps_done": self.n, "loss": 1.0 / (1 + self.n)}

    def result(self):
        return {}, None


PROBE = np.random.default_rng(0).standard_normal((8, 6, 3)).astype(np.float32)
SLO = ModelSLO(deadline_ticks=8, max_agreement_drop=0.2, canary_every=1,
               canary_window=3, baseline_obs=2, retrain_steps_per_tick=10)
BATCHER_KW = dict(max_batch=4, max_wait_ticks=1, max_inflight=2)


def make_fleet(fresh_trace, *, plan=None, factory=lambda s, c: ToyJob(),
               slo=SLO, dispatch_ahead=True, builder=toy_builder,
               n_replicas=1):
    fresh_trace.emit("config", note="toy")
    fl = FleetRuntime(fault_plan=plan, trace=fresh_trace)
    fl.register("toy", ToyStack(2.0), builder, slo=slo, probe=PROBE,
                canary_seed=11, finetune_factory=factory,
                batcher_kw=dict(BATCHER_KW, dispatch_ahead=dispatch_ahead),
                n_replicas=n_replicas)
    return fl


# -- registry invariants -----------------------------------------------------

def test_register_rejects_duplicate_name_and_seed():
    fl = make_fleet(tr.Trace())
    with pytest.raises(FleetConfigError, match="fleet-name"):
        fl.register("toy", ToyStack(1.0), toy_builder, probe=PROBE,
                    canary_seed=12)
    with pytest.raises(FleetConfigError, match="fleet-seed"):
        fl.register("toy2", ToyStack(1.0), toy_builder, probe=PROBE,
                    canary_seed=11)
    assert fl.models == ("toy",)  # failed registrations left no trace


def test_register_rejects_unsatisfiable_deadline():
    plan = FaultPlan(seed=0, p_stuck=0.5, max_stuck_ticks=3,
                     p_flush_fail=0.1)
    fl = FleetRuntime(fault_plan=plan, trace=tr.Trace())
    with pytest.raises(FleetConfigError, match="deadline_ticks"):
        fl.register("m", ToyStack(1.0), toy_builder, probe=PROBE,
                    canary_seed=1,
                    slo=ModelSLO(deadline_ticks=4))  # < 2 + 3
    fl.register("m", ToyStack(1.0), toy_builder, probe=PROBE,
                canary_seed=1, slo=ModelSLO(deadline_ticks=5))


def test_lint_fleet_findings():
    """The reference's registry and findings, and the port's equal to them
    (check, subject, severity, message, in order)."""
    report = Report()
    bad_slo = ModelSLO(deadline_ticks=8, max_agreement_drop=1.5,
                       canary_window=0)
    entries = [("a", SLO, 1, None), ("a", SLO, 1, None), ("", SLO, 2, None),
               ("c", bad_slo, 3, None)]
    planlint.lint_fleet(entries, report)
    checks = {f.check for f in report.findings
              if f.severity >= Severity.ERROR}
    assert checks == {"planlint/fleet-name", "planlint/fleet-seed",
                      "planlint/fleet-slo"}
    jreport = JReport()
    jentries = [(n, jfleet.ModelSLO(**s.to_dict()), c, None)
                for n, s, c, _ in entries]
    jplanlint.lint_fleet(jentries, jreport)
    assert [(f.check, f.subject, int(f.severity), f.message)
            for f in report.findings] == \
        [(f.check, f.subject, int(f.severity), f.message)
         for f in jreport.findings]
    clean = Report()
    planlint.lint_fleet([("a", SLO, 1, None), ("b", SLO, 2, None)], clean)
    assert not clean.findings and clean.proofs


def test_unknown_model_raises():
    fl = make_fleet(tr.Trace())
    with pytest.raises(FleetConfigError, match="unknown model"):
        fl.submit("nope", [RequestSpec(rid=0, seed=0, shape=(6, 3))])
    with pytest.raises(ValueError, match="duplicate rid"):
        fl.submit("toy", [RequestSpec(rid=0, seed=0, shape=(6, 3)),
                          RequestSpec(rid=0, seed=1, shape=(6, 3))])


# -- the healing loop --------------------------------------------------------

def drive_incident(fl, *, pre=5, post=15, model="toy", shape=(6, 3)):
    rid = 0
    for _ in range(pre):
        fl.submit(model, [RequestSpec(rid=rid, seed=42, shape=shape)])
        rid += 1
        fl.tick()
    fl.set_condition(model, (0.3, 0.3, 1.5))
    for _ in range(post):
        fl.submit(model, [RequestSpec(rid=rid, seed=42, shape=shape)])
        rid += 1
        fl.tick()
    fl.drain()


def test_breach_retrain_swap_loop():
    t = tr.Trace()
    fl = make_fleet(t)
    drive_incident(fl)
    assert len(t.of_type("breach")) == 1
    breach = t.of_type("breach")[0]
    assert breach["baseline"] == 1.0 and breach["median"] < 0.8
    swaps = t.of_type("swap")
    assert len(swaps) == 1 and swaps[0]["generation"] == 1
    assert swaps[0]["tick"] > breach["tick"]
    assert t.of_type("retrain")  # background steps ran between the two
    m = fl.stats()["toy"]
    assert m["state"] == HEALTHY and m["generation"] == 1
    # the baseline re-anchored for the new generation (no re-breach flap)
    baselines = t.of_type("baseline")
    assert [b["generation"] for b in baselines] == [0, 1]
    audit = fl.audit("toy")
    assert audit["exactly_once"] and audit["within_slo"]
    # requests flushed after the swap carry the new generation tag
    gens = {r.generation for r in fl.requests("toy") if r.error is None}
    assert gens == {0, 1}


def test_breach_without_factory_flags_breached():
    t = tr.Trace()
    fl = make_fleet(t, factory=None)
    drive_incident(fl, post=10)
    assert fl.stats()["toy"]["state"] == BREACHED
    assert len(t.of_type("breach")) == 1
    assert not t.of_type("swap") and not t.of_type("retrain")
    assert fl.audit("toy")["exactly_once"]  # serving never stopped


def test_incident_replay_bit_exact(tmp_path):
    """The full loop (faults + drift + retrain + swap) replays bit-exactly,
    also through a JSONL round-trip."""
    plan = FaultPlan(seed=3, p_flush_fail=0.3, p_stuck=0.3,
                     max_stuck_ticks=2, p_canary_corrupt=0.1)
    t = tr.Trace()
    fl = make_fleet(t, plan=plan)
    drive_incident(fl)
    assert t.of_type("fault")  # the plan actually fired
    rep = tr.replay(t, lambda cfg, fresh: make_fleet(fresh, plan=plan))
    assert rep.bit_exact, rep.summary()
    p = tmp_path / "incident.jsonl"
    t.save(str(p))
    loaded = tr.Trace.load(str(p))
    rep2 = tr.replay(loaded, lambda cfg, fresh: make_fleet(fresh, plan=plan))
    assert rep2.bit_exact, rep2.summary()
    # every line is valid JSON with a type tag (the observability side)
    for line in p.read_text().splitlines():
        assert "e" in json.loads(line)


def test_replay_detects_divergence():
    """A drifted model factory must be caught, not silently accepted."""
    t = tr.Trace()
    fl = make_fleet(t)
    drive_incident(fl, pre=2, post=0)

    def drifted(cfg, fresh):
        fresh.emit("config", note="toy")
        f = FleetRuntime(trace=fresh)
        f.register("toy", ToyStack(3.0), toy_builder, slo=SLO, probe=PROBE,
                   canary_seed=11, finetune_factory=lambda s, c: ToyJob(),
                   batcher_kw=dict(BATCHER_KW, dispatch_ahead=True))
        return f
    rep = tr.replay(t, drifted)
    assert not rep.bit_exact and rep.divergence_index is not None


# -- fault degradation -------------------------------------------------------

def test_flush_exhaustion_degrades_to_last_good():
    t = tr.Trace()
    fl = make_fleet(t)
    drive_incident(fl)                       # produces a swap: last_good set
    m = fl._model("toy")
    assert m.last_good is not None
    old_gain = m.last_good[0].gain
    m.exhausted = True                       # as the shed bridge would set
    fl.tick()
    assert m.state == DEGRADED and m.stack.gain == old_gain
    degrades = t.of_type("degrade")
    assert degrades and degrades[-1]["reason"] == "flush-retries-exhausted"
    # last_good captured the PRE-swap stack and its generation tag
    assert degrades[-1]["to_generation"] == 0


def test_exhaustion_without_last_good_keeps_serving():
    """All-failing device from the start: every request sheds with a
    structured flush-fault error, the model has no previous stack to fall
    back to, and the runtime keeps running."""
    plan = FaultPlan(seed=0, p_flush_fail=1.0, max_retries=2,
                     backoff_ticks=1)
    t = tr.Trace()
    fl = make_fleet(t, plan=plan)
    rid = 0
    for _ in range(12):
        fl.submit("toy", [RequestSpec(rid=rid, seed=1, shape=(6, 3))])
        rid += 1
        fl.tick()
    fl.drain()
    audit = fl.audit("toy")
    assert audit["exactly_once"] and audit["served"] == 0
    assert audit["shed_codes"] == ["flush-fault"]
    degrades = t.of_type("degrade")
    assert degrades and all(d["to_generation"] is None for d in degrades)
    assert fl.stats()["toy"]["state"] == HEALTHY  # nothing to degrade TO


def test_deadline_shed_is_structured():
    """Queued requests that would miss the SLO deadline shed with a
    deadline error before they can stall the window."""
    plan = FaultPlan(seed=5, p_flush_fail=0.8, max_retries=5,
                     backoff_ticks=2, max_stuck_ticks=1, p_stuck=0.5)
    t = tr.Trace()
    fl = make_fleet(t, plan=plan,
                    slo=ModelSLO(deadline_ticks=4, canary_every=0))
    rid = 0
    for _ in range(15):
        fl.submit("toy", [RequestSpec(rid=rid, seed=2, shape=(6, 3))])
        rid += 1
        fl.tick()
    fl.drain()
    audit = fl.audit("toy")
    assert audit["exactly_once"] and audit["within_slo"]
    shed = [r for r in fl.requests("toy") if r.error is not None]
    assert any(r.error["code"] == "deadline" for r in shed)
    for r in shed:
        assert r.error["rid"] == r.rid and "tick" in r.error


def test_canary_corruption_median_filtered():
    """A corrupted canary observation (junk agreement) must not breach a
    healthy model: the median over the window rides over isolated junk."""
    plan = FaultPlan(seed=2, p_canary_corrupt=0.15)
    t = tr.Trace()
    fl = make_fleet(t, plan=plan,
                    slo=ModelSLO(deadline_ticks=8, canary_window=7,
                                 baseline_obs=3))
    for _ in range(30):
        fl.tick()
    canaries = t.of_type("canary")
    assert any(c["corrupted"] for c in canaries)  # corruption DID fire
    assert not t.of_type("breach")
    assert fl.stats()["toy"]["state"] == HEALTHY


def test_rederive_failure_degrades_with_the_error_text():
    """A retrain whose result cannot be rederived degrades (a traced
    control-plane decision, the error text in the event) and serving goes
    on; a toy is not a ConvertedStack and digests as None."""
    class BadJob(ToyJob):
        def result(self):
            raise ValueError("hand-off broken")
    t = tr.Trace()
    fl = make_fleet(t, factory=lambda s, c: BadJob())
    drive_incident(fl)
    deg = t.of_type("degrade")
    assert deg and deg[0]["reason"] == "rederive-failed"
    assert deg[0]["detail"] == "hand-off broken"
    assert fl.stats()["toy"]["state"] == DEGRADED
    assert not t.of_type("swap") and fl.audit("toy")["exactly_once"]
    assert t.of_type("register")[0]["stack"] is None


# -- lockstep with the reference on the toy ---------------------------------

class JToyStack:
    def __init__(self, gain):
        self.gain = float(gain)

    def rederive(self, layer_params, *, extras=None, check_handoff=True):
        return JToyStack(self.gain + 1.0)


def jtoy_builder(stack):
    """The reference toy, its drift drawing uniforms."""
    g = stack.gain

    def fn(x, noise=None, rng=None):
        y = x * g
        if noise is not None and rng is not None:
            y = y + jax.random.uniform(rng, y.shape) * noise.sigma_mac \
                * 100.0
        return y
    return fn


def _jtoy_fleet(fresh, plan, n_replicas):
    fresh.emit("config", note="toy")
    fl = jfleet.FleetRuntime(
        fault_plan=jfaults.FaultPlan(**plan.to_dict()), trace=fresh)
    fl.register("toy", JToyStack(2.0), jtoy_builder,
                slo=jfleet.ModelSLO(**SLO.to_dict()), probe=PROBE,
                canary_seed=11, finetune_factory=lambda s, c: ToyJob(),
                batcher_kw=dict(BATCHER_KW, dispatch_ahead=True),
                n_replicas=n_replicas)
    return fl


LOCKSTEP_PLAN = FaultPlan(seed=3, p_flush_fail=0.3, p_stuck=0.3,
                          max_stuck_ticks=2, p_canary_corrupt=0.1)


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_toy_incident_lockstep_with_reference(n_replicas):
    """One seeded schedule with active faults, a drift, a breach, a retrain
    and a swap: the port's trace equals the reference's event for event
    (outputs by digest, canary agreements, fault draws, retrain losses)."""
    jt, t = jtrace.Trace(), tr.Trace()
    drive_incident(_jtoy_fleet(jt, LOCKSTEP_PLAN, n_replicas))
    fl = make_fleet(t, plan=LOCKSTEP_PLAN, n_replicas=n_replicas,
                    builder=functools.partial(toy_builder,
                                              draw=prng.uniform))
    drive_incident(fl)
    for etype in ("fault", "breach", "retrain", "swap", "resolve"):
        assert t.of_type(etype), etype
    if n_replicas > 1:
        assert {e["replica"] for e in t.of_type("swap-replica")} == {0, 1}
    rep = tr.compare(tr.Trace(jt.events), t)
    assert rep.bit_exact, rep.summary()


# -- on the card ------------------------------------------------------------

cuda = pytest.mark.skipif(not has_cuda(), reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
def test_replay_on_the_card():
    """The toy incident with faults, on CUDA lanes, replays bit-exactly."""
    builder = functools.partial(toy_builder, device=torch.device("cuda", 0))
    t = tr.Trace()
    fl = make_fleet(t, plan=LOCKSTEP_PLAN, builder=builder, n_replicas=2)
    drive_incident(fl)
    rep = tr.replay(t, lambda cfg, fresh: make_fleet(
        fresh, plan=LOCKSTEP_PLAN, builder=builder, n_replicas=2))
    assert rep.bit_exact, rep.summary()
